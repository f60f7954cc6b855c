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
reaches the card.  A launch never waits for the card: its table of pieces
goes up from pinned host memory by an asynchronous copy.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bucket_pack.ref import (bucket_pack_ref,
                                                 bucket_unpack_ref,
                                                 pack_ragged_ref,
                                                 unpack_columns_ref)

TILE = 512  # the reference's alignment unit (4 sublanes x 128 lanes at f32)
DTYPES = (torch.float32, torch.bfloat16)
LAUNCHES: Dict[str, int] = {"bucket_pack": 0, "bucket_unpack": 0}


def aligned(n: int) -> int:
    return ((n + TILE - 1) // TILE) * TILE


def split_work(pieces: Sequence[Tuple[int, int, int]]
               ) -> Tuple[np.ndarray, int]:
    """The kernel's table: ``pieces`` (src address or 0, dst address,
    bytes) as ``(n, 4)`` int64 rows ``(begin, src, dst, bytes)``, where
    ``begin`` is the piece's offset in the pieces' concatenated byte range,
    empty pieces dropped; and that range's length.

    The kernel cuts the range into 16 KB chunks (``kChunk``), one block
    each, so work is split by bytes, not by piece: block c copies bytes
    ``[c * kChunk, (c + 1) * kChunk)``, the last block the rest.
    """
    p = np.asarray(pieces, dtype=np.int64).reshape(-1, 3)
    p = p[p[:, 2] > 0]
    ends = np.cumsum(p[:, 2])
    table = np.concatenate([(ends - p[:, 2])[:, None], p], axis=1)
    return table, int(ends[-1]) if len(p) else 0


class _Staging:
    """Pinned host buffers for the tables.  A buffer is filled again only
    once the copy that read it has run (its CUDA event has passed), and a
    new one is made when none is free, so no launch waits for the card."""

    def __init__(self) -> None:
        self._slots: List[list] = []            # [pinned int64, event]
        self._lock = threading.Lock()

    def upload(self, table: np.ndarray, device: torch.device) -> torch.Tensor:
        n = table.size
        stream = torch.cuda.current_stream(device)
        with self._lock:
            slot = next((s for s in self._slots if s[0].numel() >= n
                         and s[1].query()), None)
            if slot is None:
                slot = [torch.empty(max(1024, 1 << (n - 1).bit_length()),
                                    dtype=torch.int64, pin_memory=True),
                        None]
                self._slots.append(slot)
            host = slot[0][:n]
            host.numpy()[:] = table.reshape(-1)
            out = torch.empty(n, dtype=torch.int64, device=device)
            out.copy_(host, non_blocking=True)
            slot[1] = torch.cuda.Event()
            slot[1].record(stream)
        return out


_STAGING = _Staging()


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
    table, total = split_work(pieces)
    if not total:
        return
    fn = _build.library("bucket_pack").repro_copy_pieces
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    on_card = _STAGING.upload(table, device)      # held until launched
    status = fn(on_card.data_ptr(), len(table), total,
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
