"""Carry weights, trainer states and decode caches across from the
reference, as numpy.

The reference draws its initial weights with ``jax.random``, which torch
cannot replay; a parity check therefore initialises in the reference,
converts the arrays to numpy and loads them here.  Nothing in this module
imports the reference: it takes plain numpy trees.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

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


def caches_from_numpy(cfg, numpy_caches: Sequence[Any], device="cpu"
                      ) -> List[Any]:
    """The reference's per-layer decode caches as the port's: one
    ``KVCache``, ``MLSTMState``, ``SLSTMState`` or ``RGLRUState`` a layer
    (by ``cfg.layer_kinds()``), each given as its fields in order (the
    reference's NamedTuple with numpy leaves, or any sequence of arrays).
    Every array is copied, so a decode that writes the port's caches in
    place leaves the given arrays alone."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.ssm import MLSTMState, RGLRUState, SLSTMState
    kinds = cfg.layer_kinds()
    if len(numpy_caches) != len(kinds):
        raise ValueError(f"{len(numpy_caches)} caches for {len(kinds)} "
                         f"layers")
    classes = {"global_attn": KVCache, "local_attn": KVCache,
               "mlstm": MLSTMState, "slstm": SLSTMState,
               "rglru": RGLRUState}
    out = []
    for kind, cache in zip(kinds, numpy_caches):
        cls = classes[kind]
        fields = list(cache)
        if len(fields) != len(cls._fields):
            raise ValueError(f"a {kind} cache has the fields "
                             f"{cls._fields}, got {len(fields)} arrays")
        out.append(cls(*(torch.from_numpy(np.array(x)).to(device)
                         for x in fields)))
    return out


def zero_state_from_numpy(trainer, flat_params: Sequence[np.ndarray],
                          mu: Optional[Sequence[np.ndarray]] = None,
                          nu: Optional[Sequence[np.ndarray]] = None,
                          step: int = 0):
    """A trainer's state from the reference's whole ``(padded,)`` flat
    buffers, optimizer moments and step, through its ``state_from_flats``:
    a ``ZeroTrainer`` rank keeps its shard, a ``PipelineTrainer`` puts each
    stage's buffers on that stage's device."""
    def as_tensors(bufs):
        return None if bufs is None else [torch.from_numpy(np.array(b))
                                           for b in bufs]
    return trainer.state_from_flats(as_tensors(flat_params), as_tensors(mu),
                                    as_tensors(nu), int(step))
