"""Carry weights and ZeRO states across from the reference, as numpy.

The reference draws its initial weights with ``jax.random``, which torch
cannot replay; a parity check therefore initialises in the reference,
converts the arrays to numpy and loads them here.  Nothing in this module
imports the reference: it takes plain numpy trees.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree


def params_from_numpy(numpy_tree: Any, device="cpu",
                      requires_grad: bool = False) -> Any:
    """The same nested dict / list tree, with every array as a tensor on
    ``device`` (dtypes kept)."""
    def convert(x):
        t = torch.from_numpy(np.array(x)).to(device)
        return t.requires_grad_() if requires_grad else t
    return tree.tree_map(convert, numpy_tree)


def zero_state_from_numpy(trainer, flat_params: Sequence[np.ndarray],
                          mu: Optional[Sequence[np.ndarray]] = None,
                          nu: Optional[Sequence[np.ndarray]] = None,
                          step: int = 0):
    """A ``ZeroTrainer`` state from the reference's whole ``(padded,)``
    flat buffers, optimizer moments and step (this rank keeps its shard)."""
    def as_tensors(bufs):
        return None if bufs is None else [torch.from_numpy(np.array(b))
                                           for b in bufs]
    return trainer.state_from_flats(as_tensors(flat_params), as_tensors(mu),
                                    as_tensors(nu), int(step))
