"""Flat-path npz checkpointing for trees of tensors and numpy arrays.

Leaves are stored under their joined key path; restore rebuilds into a
caller-provided template tree (shape checked, dtype cast), so a runtime
re-places leaves on its device after the load.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch import tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _shape_dtype(leaf):
    """A template leaf's shape and numpy dtype, without copying it."""
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape),
                torch.empty((), dtype=leaf.dtype).numpy().dtype)
    leaf = np.asarray(leaf)
    return tuple(leaf.shape), leaf.dtype


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def save_checkpoint(path: str, t: Any, *, step: int | None = None) -> None:
    flat = {_key(p): _to_numpy(leaf) for p, leaf in tree.leaves_with_paths(t)}
    if step is not None:
        flat["__step__"] = np.asarray(step)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    np.savez(tmp, **flat)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_checkpoint(path: str, template: Any):
    """Returns (numpy tree like template, step or None).

    Text leaves in the template (numpy unicode/bytes kinds) are restored as
    stored: their width varies with content, so no shape check applies.
    """
    with np.load(path) as data:
        leaves = []
        for p, leaf in tree.leaves_with_paths(template):
            key = _key(p)
            arr = data[key]
            shape, dtype = _shape_dtype(leaf)
            if dtype.kind in ("U", "S"):
                leaves.append(arr)
                continue
            if tuple(arr.shape) != shape:
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {shape}")
            leaves.append(arr.astype(dtype))
        step = int(data["__step__"]) if "__step__" in data.files else None
    return tree.unflatten(tree.structure(template), leaves), step
