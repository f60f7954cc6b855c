"""Flat-buffer collectives: one collective per DynaComm segment.

A *sched layer*'s parameter tree is packed into a single padded 1-D float32
buffer (``FlatSpec`` records the layout, leaves in ``jax.tree_util`` order
so every offset equals the reference's), so that a DynaComm transmission
segment — a contiguous group of sched layers — becomes exactly one
``all_gather_into_tensor`` (the paper's parameter *pull*) or one
``reduce_scatter_tensor`` (the gradient *push*) over the process group, no
matter how many tensors the segment contains.

Layout convention (byte for byte the reference's): every per-layer buffer
is padded to a multiple of the group size A and stored sharded as
``(padded // A,)`` per rank.  A pull concatenates the bucket's shards (the
**pack** kernel), all-gathers them into an ``(A, S)`` buffer, and splits
each layer's columns back into its full buffer (the **unpack** kernel, one
launch per bucket at any A).  A push lays each layer's full gradient out as
``(A, padded // A)`` rows, concatenated along columns — built straight from
the gradient leaves by one pack launch — and reduce-scatters it once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.kernels.bucket_pack.ops import pack_ragged, unpack_columns

FLAT_DTYPE = torch.float32


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Layout of one sched layer's tree inside its padded flat buffer."""

    treedef: Any                              # tree structure
    shapes: Tuple[Tuple[int, ...], ...]       # per-leaf shapes
    dtypes: Tuple[Any, ...]                   # per-leaf dtypes (restored)
    offsets: Tuple[int, ...]                  # per-leaf start offset
    sizes: Tuple[int, ...]                    # per-leaf element count
    total: int                                # sum of sizes
    padded: int                               # total rounded up to axis_size
    axis_size: int

    @property
    def num_leaves(self) -> int:
        return len(self.sizes)

    @property
    def shard_size(self) -> int:
        return self.padded // self.axis_size


def make_flat_spec(t: Any, axis_size: int) -> FlatSpec:
    """Compute the flat layout for ``t`` sharded ``axis_size`` ways (reads
    only ``.shape`` / ``.dtype``: ``meta`` tensors do)."""
    if axis_size < 1:
        raise ValueError(f"axis_size must be >= 1, got {axis_size}")
    leaves = tree.leaves(t)
    if not leaves:
        raise ValueError("cannot build a FlatSpec for an empty pytree")
    shapes, dtypes, offsets, sizes = [], [], [], []
    off = 0
    for leaf in leaves:
        n = 1
        for d in leaf.shape:
            n *= int(d)
        shapes.append(tuple(int(d) for d in leaf.shape))
        dtypes.append(leaf.dtype)
        offsets.append(off)
        sizes.append(n)
        off += n
    padded = max(-(-off // axis_size), 1) * axis_size
    return FlatSpec(treedef=tree.structure(t), shapes=tuple(shapes),
                    dtypes=tuple(dtypes), offsets=tuple(offsets),
                    sizes=tuple(sizes), total=off, padded=padded,
                    axis_size=axis_size)


def flatten_tree(t: Any, spec: FlatSpec) -> torch.Tensor:
    """Pack ``t`` into its ``(spec.padded,)`` float32 buffer (zero pad)."""
    leaves = tree.leaves(t)
    if len(leaves) != spec.num_leaves:
        raise ValueError(f"tree has {len(leaves)} leaves, spec expects "
                         f"{spec.num_leaves}")
    parts = [x.reshape(-1).to(FLAT_DTYPE) for x in leaves]
    pad = spec.padded - spec.total
    if pad:
        parts.append(torch.zeros((pad,), dtype=FLAT_DTYPE,
                                 device=parts[0].device))
    return torch.cat(parts)


def unflatten_tree(flat: torch.Tensor, spec: FlatSpec) -> Any:
    """Inverse of :func:`flatten_tree` — restores leaf shapes *and dtypes*
    (views of ``flat`` where the dtype is already float32)."""
    if tuple(flat.shape) != (spec.padded,):
        raise ValueError(f"flat buffer shape {tuple(flat.shape)} != "
                         f"({spec.padded},)")
    leaves = [flat[o:o + n].view(shape).to(dtype)
              for o, n, shape, dtype in zip(spec.offsets, spec.sizes,
                                            spec.shapes, spec.dtypes)]
    return tree.unflatten(spec.treedef, leaves)


def bucket_bytes(specs: Sequence[FlatSpec], bucket: Sequence[int]) -> int:
    """Unpadded payload bytes of one segment's transmission (f32 flats)."""
    itemsize = torch.empty((), dtype=FLAT_DTYPE).element_size()
    return sum(specs[l].total * itemsize for l in bucket)


# ---------------------------------------------------------------------------
# Bucket collectives
# ---------------------------------------------------------------------------


def _check_bucket(specs: Sequence[FlatSpec], bucket: Sequence[int],
                  op: str) -> None:
    """A bucket must be non-empty, name known layers, and share one
    ``axis_size`` across its specs (one collective ⇒ one shard layout)."""
    if not bucket:
        raise ValueError(f"{op}: empty bucket (a DynaComm segment contains "
                         f"at least one layer)")
    bad = [l for l in bucket if not 0 <= l < len(specs)]
    if bad:
        raise ValueError(f"{op}: bucket {tuple(bucket)} names unknown layers "
                         f"{bad} (have specs for 0..{len(specs) - 1})")
    sizes = {specs[l].axis_size for l in bucket}
    if len(sizes) != 1:
        raise ValueError(f"{op}: bucket {tuple(bucket)} mixes axis sizes "
                         f"{sorted(sizes)}; all specs in a bucket must be "
                         f"sharded over the same axis")


def _check_group(specs, bucket, group) -> int:
    axis = specs[bucket[0]].axis_size
    size = dist.get_world_size(group)
    if size != axis:
        raise ValueError(f"bucket {tuple(bucket)} is sharded {axis} ways but "
                         f"the process group has {size} ranks")
    return axis


def gather_bucket(shards: Sequence[torch.Tensor], specs: Sequence[FlatSpec],
                  bucket: Sequence[int], group=None) -> Dict[int, Any]:
    """Pull one bucket with a single all-gather.

    ``shards[l]`` is layer ``l``'s local ``(padded_l // A,)`` slice.
    Returns ``{layer_id: full parameter tree}`` for every layer in
    ``bucket``; the leaves are views of one new full buffer per layer.
    """
    _check_bucket(specs, bucket, "gather_bucket")
    axis = _check_group(specs, bucket, group)
    operand = pack_ragged([shards[l] for l in bucket])
    gathered = torch.empty(axis * operand.numel(), dtype=operand.dtype,
                           device=operand.device)
    dist.all_gather_into_tensor(gathered, operand, group=group)
    del operand
    fulls = unpack_columns(gathered, [specs[l].shard_size for l in bucket],
                           axis)
    return {l: unflatten_tree(full, specs[l])
            for l, full in zip(bucket, fulls)}


def _row_pieces(leaves: Sequence[torch.Tensor], spec: FlatSpec, row: int
                ) -> List[Union[torch.Tensor, int]]:
    """Row ``row`` of the flat buffer ``(A, padded // A)``, as 1-D views of
    the leaves (in FLAT_DTYPE) and zero runs for the padding."""
    lo, hi = row * spec.shard_size, (row + 1) * spec.shard_size
    out: List[Union[torch.Tensor, int]] = []
    for leaf, off, n in zip(leaves, spec.offsets, spec.sizes):
        a, b = max(lo, off), min(hi, off + n)
        if a < b:
            out.append(leaf[a - off:b - off])
    if hi > spec.total:
        out.append(hi - max(lo, spec.total))
    return out


def reduce_scatter_bucket(grads: Dict[int, Any], specs: Sequence[FlatSpec],
                          bucket: Sequence[int], group=None
                          ) -> Dict[int, torch.Tensor]:
    """Push one bucket with a single reduce-scatter.

    ``grads[l]`` is the *full* (per-rank) gradient tree of layer ``l``;
    the result maps each layer to this rank's summed ``(padded_l // A,)``
    gradient shard (views of one buffer; the caller divides by A for the
    mean).
    """
    _check_bucket(specs, bucket, "reduce_scatter_bucket")
    axis = _check_group(specs, bucket, group)
    flat_leaves = {}
    for l in bucket:
        leaves = tree.leaves(grads[l])
        if len(leaves) != specs[l].num_leaves:
            raise ValueError(f"layer {l}: gradient has {len(leaves)} leaves, "
                             f"spec expects {specs[l].num_leaves}")
        flat_leaves[l] = [x.reshape(-1).to(FLAT_DTYPE).contiguous()
                          for x in leaves]
    pieces: List[Union[torch.Tensor, int]] = []
    for r in range(axis):
        for l in bucket:
            pieces.extend(_row_pieces(flat_leaves[l], specs[l], r))
    operand = pack_ragged(pieces)
    del flat_leaves, pieces
    out = torch.empty(operand.numel() // axis, dtype=operand.dtype,
                      device=operand.device)
    dist.reduce_scatter_tensor(out, operand, op=dist.ReduceOp.SUM,
                               group=group)
    result: Dict[int, torch.Tensor] = {}
    off = 0
    for l in bucket:
        w = specs[l].shard_size
        result[l] = out[off:off + w]
        off += w
    return result
