"""Bucket pack / unpack: the wrappers of the CUDA ragged-copy kernel.

Two forms, one kernel (``csrc/bucket_pack.cu``):

* the reference's API, ``bucket_pack(segments, aligned_lengths)`` /
  ``bucket_unpack(flat, aligned_lengths, lmax)`` over a TILE-padded
  ``(K, Lmax)`` matrix, with the same ``ValueError``s;
* the collective form the ZeRO step runs: :func:`pack_ragged` builds one
  collective operand from 1-D segments of any length (views included;
  an ``int`` n is n zeros), and :func:`unpack_columns` splits a gathered
  ``(rows, sum widths)`` buffer into one full buffer per column block.

Dispatch goes by the tensor's device only: on a CPU tensor the plain
version in ``ref.py`` runs; on a CUDA tensor the kernel launches or the
wrapper raises.  ``LAUNCHES`` counts kernel launches, one per call that
reaches the card.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bucket_pack.ref import (bucket_pack_ref,
                                                 bucket_unpack_ref,
                                                 pack_ragged_ref,
                                                 unpack_columns_ref)

TILE = 512  # the reference's alignment unit (4 sublanes x 128 lanes at f32)
DTYPES = (torch.float32, torch.bfloat16)
LAUNCHES: Dict[str, int] = {"bucket_pack": 0, "bucket_unpack": 0}

_MAX_PIECES = 65535          # grid.y limit: one block row per piece
_BYTES_PER_BLOCK = 65536     # work per block before it grid-strides
_MAX_BLOCKS_PER_PIECE = 2048


def aligned(n: int) -> int:
    return ((n + TILE - 1) // TILE) * TILE


def _check_aligned_lengths(aligned_lengths: Sequence[int],
                           k_count: int) -> None:
    if len(aligned_lengths) != k_count:
        raise ValueError(f"got {len(aligned_lengths)} aligned lengths for "
                         f"{k_count} segments")
    for n in aligned_lengths:
        if n <= 0 or n % TILE:
            raise ValueError(f"aligned lengths must be positive multiples of "
                             f"TILE={TILE}, got {tuple(aligned_lengths)}")


def _on_cpu(x: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor; validates a CUDA one; raises otherwise."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{what} must lie on the CPU or a CUDA device, got "
                         f"{x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"{what}: the bucket kernels take {DTYPES}, got "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    return False


def _launch(kind: str, pieces: List[Tuple[int, int, int]],
            device: torch.device) -> None:
    """One kernel launch over ``(src address or 0, dst address, bytes)``."""
    pieces = [p for p in pieces if p[2] > 0]
    if not pieces:
        return
    if len(pieces) > _MAX_PIECES:
        raise ValueError(f"{kind}: {len(pieces)} pieces exceed the launch "
                         f"limit of {_MAX_PIECES}")
    table = torch.tensor(pieces, dtype=torch.int64).to(device)
    blocks = max(1, min(_MAX_BLOCKS_PER_PIECE,
                        -(-max(p[2] for p in pieces) // _BYTES_PER_BLOCK)))
    fn = _build.library("bucket_pack").repro_copy_pieces
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(table.data_ptr(), len(pieces), blocks,
                torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES[kind] += 1
    _build.check(status, kind)


# ---------------------------------------------------------------------------
# the reference's (K, Lmax) API
# ---------------------------------------------------------------------------


def pad_segments(vectors: Sequence[torch.Tensor]
                 ) -> Tuple[torch.Tensor, tuple]:
    """Ragged 1-D vectors → (K, Lmax) TILE-padded matrix + aligned lengths."""
    alens = tuple(aligned(int(v.shape[0])) for v in vectors)
    lmax = max(alens)
    rows = [torch.nn.functional.pad(v, (0, lmax - v.shape[0]))
            for v in vectors]
    return torch.stack(rows), alens


def bucket_pack(segments: torch.Tensor,
                aligned_lengths: Sequence[int]) -> torch.Tensor:
    """segments: (K, Lmax) with Lmax % TILE == 0 → (sum(aligned_lengths),)."""
    if segments.ndim != 2:
        raise ValueError(f"segments must be (K, Lmax), got "
                         f"{tuple(segments.shape)}")
    k_count, lmax = segments.shape
    if lmax % TILE:
        raise ValueError(f"segment row length {lmax} is not a multiple of "
                         f"TILE={TILE}")
    _check_aligned_lengths(aligned_lengths, k_count)
    if max(aligned_lengths) > lmax:
        raise ValueError(f"aligned lengths {tuple(aligned_lengths)} exceed "
                         f"the row length {lmax}")
    if _on_cpu(segments, "segments"):
        return bucket_pack_ref(segments, aligned_lengths)
    es = segments.element_size()
    out = torch.empty(sum(aligned_lengths), dtype=segments.dtype,
                      device=segments.device)
    pieces, off = [], 0
    for k, n in enumerate(aligned_lengths):
        pieces.append((segments.data_ptr() + k * lmax * es,
                       out.data_ptr() + off * es, n * es))
        off += n
    _launch("bucket_pack", pieces, segments.device)
    return out


def bucket_unpack(flat: torch.Tensor, aligned_lengths: Sequence[int],
                  lmax: int) -> torch.Tensor:
    """flat (sum(aligned_lengths),) → (K, Lmax) zero-padded views."""
    if lmax % TILE:
        raise ValueError(f"lmax {lmax} is not a multiple of TILE={TILE}")
    k_count = len(aligned_lengths)
    _check_aligned_lengths(aligned_lengths, k_count)
    total = sum(aligned_lengths)
    if tuple(flat.shape) != (total,):
        raise ValueError(f"flat buffer shape {tuple(flat.shape)} != "
                         f"({total},) implied by aligned lengths")
    if max(aligned_lengths) > lmax:
        raise ValueError(f"aligned lengths {tuple(aligned_lengths)} exceed "
                         f"lmax {lmax}")
    if _on_cpu(flat, "flat"):
        return bucket_unpack_ref(flat, aligned_lengths, lmax)
    es = flat.element_size()
    out = torch.empty((k_count, lmax), dtype=flat.dtype, device=flat.device)
    pieces, off = [], 0
    for k, n in enumerate(aligned_lengths):
        row = out.data_ptr() + k * lmax * es
        pieces.append((flat.data_ptr() + off * es, row, n * es))
        pieces.append((0, row + n * es, (lmax - n) * es))
        off += n
    _launch("bucket_unpack", pieces, flat.device)
    return out


# ---------------------------------------------------------------------------
# collective form (ragged lengths: FlatSpec shard widths)
# ---------------------------------------------------------------------------


def pack_ragged(segments: Sequence[Union[torch.Tensor, int]]
                ) -> torch.Tensor:
    """Concatenate 1-D segments into one new buffer (the collective operand).

    Tensors may be views (``x[a:b]``) as long as each is contiguous; an
    ``int`` n contributes n zeros.  On the card this is one kernel launch
    whatever the number of segments.
    """
    tensors = [s for s in segments if not isinstance(s, int)]
    if not tensors:
        raise ValueError("pack_ragged needs at least one tensor segment")
    like = tensors[0]
    for s in tensors:
        if s.ndim != 1:
            raise ValueError(f"segments must be 1-D, got {tuple(s.shape)}")
        if s.dtype != like.dtype or s.device != like.device:
            raise ValueError("segments must share one dtype and device")
    if _on_cpu(like, "segments"):
        return pack_ragged_ref(segments, dtype=like.dtype, device=like.device)
    for s in tensors:
        _on_cpu(s, "segments")
    es = like.element_size()
    total = sum(s if isinstance(s, int) else s.numel() for s in segments)
    out = torch.empty(total, dtype=like.dtype, device=like.device)
    pieces, off = [], 0
    for s in segments:
        n = s if isinstance(s, int) else s.numel()
        src = 0 if isinstance(s, int) else s.data_ptr()
        pieces.append((src, out.data_ptr() + off * es, n * es))
        off += n
    _launch("bucket_pack", pieces, like.device)
    return out


def unpack_columns(flat: torch.Tensor, widths: Sequence[int],
                   rows: int) -> List[torch.Tensor]:
    """Split ``flat`` viewed ``(rows, sum(widths))`` into column blocks.

    Returns one new ``(rows * widths[k],)`` buffer per block k, holding
    rows ``0..rows-1`` of its columns in order: the per-layer full buffers
    of a gathered bucket.  One kernel launch on the card.
    """
    total = rows * sum(widths)
    if flat.ndim != 1 or flat.numel() != total:
        raise ValueError(f"flat buffer shape {tuple(flat.shape)} != "
                         f"({total},) implied by {rows} rows of widths "
                         f"{tuple(widths)}")
    if _on_cpu(flat, "flat"):
        return unpack_columns_ref(flat, widths, rows)
    es = flat.element_size()
    width = sum(widths)
    outs = [torch.empty(rows * w, dtype=flat.dtype, device=flat.device)
            for w in widths]
    pieces = []
    for r in range(rows):
        off = 0
        for w, out in zip(widths, outs):
            pieces.append((flat.data_ptr() + (r * width + off) * es,
                           out.data_ptr() + r * w * es, w * es))
            off += w
    _launch("bucket_unpack", pieces, flat.device)
    return outs
