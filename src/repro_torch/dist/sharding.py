"""Canonical data x model sharding rules, as placement values.

``param_pspec`` maps a parameter's path + shape to a
:class:`PartitionSpec` under the repo-wide convention (the reference's
rules, copied):

* 2-D+ weights put their *output-feature* dimension on the model axis and
  their other contraction dimension on the data axis (FSDP / ZeRO-style
  weight sharding).  Projections that map *back* into the residual stream
  (``wo`` / ``down`` / ``out``) are transposed: model on the penultimate
  dimension, data on the last.
* 1-D scales/biases go on the data axis.
* A dimension that is not divisible by its axis size falls back to
  replicated (``None``) — never an invalid sharding.
* ``dim_offset`` skips leading stacking dimensions (the stacked-layer
  parameter layout); extra leading dimensions such as MoE expert stacks
  are replicated unless ``moe_ep`` requests expert parallelism over the
  model axis.

``params_shardings`` / ``batch_shardings`` / ``cache_shardings`` apply the
rules over whole trees and return a tree of specs; ``shard_shape`` and
``device_bytes`` give what one device holds under them.  No step of the
port runs model-parallel: the specs are read by the dry runs, which
reckon per-device bytes from them.
"""

from __future__ import annotations

import math
from typing import Any, Sequence, Tuple

from repro_torch import tree
from repro_torch.launch.mesh import Mesh

# Projections back into the residual stream: (feature_in, d_model) — the
# model-parallel dimension is the *first* of the trailing two.
_MODEL_FIRST_NAMES = frozenset({"wo", "down", "out"})


class PartitionSpec:
    """One entry per dimension: ``None`` (replicated), an axis name, or a
    tuple of axis names.  Equal to a tuple of the same entries, and to the
    reference's ``jax.sharding.PartitionSpec`` taken as a tuple.  Not a
    tuple itself, so that a tree of specs has one leaf per spec."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self.entries == other.entries
        if isinstance(other, tuple):
            return self.entries == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.entries!r}"


def path_str(path: Sequence[Any]) -> str:
    """A tree path → ``"a/0/b"`` (a named tuple's field prints ``.field``,
    as the reference's key paths do)."""
    return "/".join(str(p) for p in path)


def _data_entry(data_axes: Tuple[str, ...]):
    """PartitionSpec entry for the data axes (None / name / axis tuple)."""
    if not data_axes:
        return None
    return data_axes[0] if len(data_axes) == 1 else tuple(data_axes)


def param_pspec(path: str, shape: Tuple[int, ...], *, model_axis=None,
                data_axes: Tuple[str, ...] = (), model_size: int = 1,
                data_size: int = 1, dim_offset: int = 0,
                moe_ep: bool = False) -> PartitionSpec:
    """PartitionSpec for one parameter leaf (see module docstring)."""
    entries: list = [None] * len(shape)
    eff = shape[dim_offset:]
    nd = len(eff)
    data_entry = _data_entry(data_axes)

    def put_model(i: int) -> None:
        if model_axis is not None and model_size > 0 \
                and eff[i] % model_size == 0:
            entries[dim_offset + i] = model_axis

    def put_data(i: int) -> None:
        if data_entry is not None and data_size > 0 \
                and eff[i] % data_size == 0:
            entries[dim_offset + i] = data_entry

    name = path.split("/")[-1]
    if nd == 1:
        put_data(0)
    elif nd >= 2:
        if name in _MODEL_FIRST_NAMES:
            model_dim, data_dim = nd - 2, nd - 1
        else:
            model_dim, data_dim = nd - 1, nd - 2
        expert_parallel = (moe_ep and "moe" in path.split("/") and nd >= 3
                           and model_axis is not None
                           and eff[0] % max(model_size, 1) == 0)
        if expert_parallel:
            entries[dim_offset] = model_axis   # experts over the model axis
            put_data(data_dim)
        else:
            put_model(model_dim)
            put_data(data_dim)
    return PartitionSpec(*entries)


def _mesh_axes(mesh: Mesh, *, fsdp: bool = True):
    model_axis = "model" if "model" in mesh.axis_names else None
    model_size = int(mesh.shape[model_axis]) if model_axis else 1
    data_axes = tuple(a for a in mesh.axis_names if a != model_axis)
    data_size = int(math.prod(mesh.shape[a] for a in data_axes)) \
        if data_axes else 1
    if not fsdp:
        data_axes, data_size = (), 1
    return model_axis, model_size, data_axes, data_size


def params_shardings(cfg, params: Any, mesh: Mesh, *, fsdp: bool = True,
                     moe_ep: bool = False) -> Any:
    """Specs for a parameter (or optimizer-state) tree, same structure.

    Accepts both the per-layer layout (``layers/<i>/...``) and the stacked
    layout (``stack/<j>/...`` — the leading group dimension is kept
    replicated via ``dim_offset=1``).
    """
    del cfg  # rules are shape/path driven; kept for call-site symmetry
    model_axis, model_size, data_axes, data_size = _mesh_axes(mesh, fsdp=fsdp)
    specs = []
    for path, leaf in tree.leaves_with_paths(params):
        ps = path_str(path)
        offset = 1 if "stack" in ps.split("/") else 0
        specs.append(param_pspec(ps, tuple(leaf.shape),
                                 model_axis=model_axis, data_axes=data_axes,
                                 model_size=model_size, data_size=data_size,
                                 dim_offset=offset, moe_ep=moe_ep))
    return tree.unflatten(tree.structure(params), specs)


def batch_shardings(batch: Any, mesh: Mesh) -> Any:
    """Shard every batch leaf's leading (global-batch) dim over the data
    axes; replicate when indivisible (e.g. batch-1 long-context decode)."""
    _, _, data_axes, data_size = _mesh_axes(mesh)
    data_entry = _data_entry(data_axes)

    def rule(leaf):
        if leaf.ndim == 0:
            return PartitionSpec()
        lead = data_entry if (data_entry is not None
                              and leaf.shape[0] % data_size == 0) else None
        return PartitionSpec(lead, *([None] * (leaf.ndim - 1)))

    return tree.tree_map(rule, batch)


def cache_shardings(caches: Any, mesh: Mesh, *, batch: int,
                    seq_over_model: bool = False) -> Any:
    """Decode-cache specs: batch dim over data; for (B, S, H, hd) KV
    leaves the kv-head dim goes over model when divisible, or the sequence
    dim instead with ``seq_over_model=True`` (few-kv-head models)."""
    model_axis, model_size, data_axes, data_size = _mesh_axes(mesh)
    data_entry = _data_entry(data_axes)

    def rule(leaf):
        if leaf.ndim == 0:
            return PartitionSpec()
        entries: list = [None] * leaf.ndim
        if data_entry is not None and leaf.shape[0] == batch \
                and batch % data_size == 0:
            entries[0] = data_entry
        if leaf.ndim == 4 and model_axis is not None:
            if seq_over_model and leaf.shape[1] % model_size == 0:
                entries[1] = model_axis
            elif leaf.shape[2] % model_size == 0:
                entries[2] = model_axis
        return PartitionSpec(*entries)

    return tree.tree_map(rule, caches)


def shard_shape(shape: Sequence[int], spec: PartitionSpec,
                mesh: Mesh) -> Tuple[int, ...]:
    """The block of ``shape`` that one device holds under ``spec``."""
    sizes = mesh.shape
    out = []
    for i, d in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        names = () if entry is None else \
            (entry,) if isinstance(entry, str) else tuple(entry)
        ways = math.prod(sizes[n] for n in names)
        if d % ways:
            raise ValueError(f"dimension {i} of {tuple(shape)} is not "
                             f"divisible by {ways} ({entry})")
        out.append(d // ways)
    return tuple(out)


def device_bytes(t: Any, specs: Any, mesh: Mesh) -> int:
    """Bytes one device holds of the tree ``t`` (tensors, ``meta`` ones
    included) placed by the tree of ``specs``."""
    return sum(math.prod(shard_shape(leaf.shape, spec, mesh))
               * leaf.element_size()
               for leaf, spec in zip(tree.leaves(t), tree.leaves(specs)))
