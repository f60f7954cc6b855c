"""Gradient compression: the wrappers of the CUDA kernels in
``csrc/compress.cu`` and the shared top-k index selection.

The reference's API and ``ValueError``s: ``quantize_pack`` /
``dequantize_unpack`` over a TILE-padded ``(K, Lmax)`` matrix with
per-row aligned lengths, ``topk_indices`` / ``sparsify`` / ``densify`` over
``(K, kmax)`` per-row indices.  Dispatch goes by the tensor's device only:
on a CPU tensor the plain version in ``ref.py`` runs; on a CUDA tensor the
kernel launches or the wrapper raises.  ``LAUNCHES`` counts kernel
launches, one per call that reaches the card.

``topk_indices`` is no kernel, as in the reference (a ``jnp`` helper
there): a stable sort does the selection on either device, so the
coordinates the two packages choose are the same.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bucket_pack.ops import (TILE, _check_aligned_lengths,
                                                 aligned)
from repro_torch.kernels.compress.ref import (densify_ref,
                                              dequantize_unpack_ref,
                                              feedback_residual_ref,
                                              quantize_pack_ref, sparsify_ref)

__all__ = ["TILE", "aligned", "quantize_pack", "dequantize_unpack",
           "topk_indices", "sparsify", "densify"]

LAUNCHES: Dict[str, int] = {"compress_quantize": 0, "compress_dequantize": 0,
                            "compress_sparsify": 0, "compress_densify": 0}
_MAX_ROWS = 65535            # dequantize: grid.y is one row each


def _on_cpu(x: torch.Tensor, what: str, dtype: torch.dtype) -> bool:
    """True for a CPU tensor; validates a CUDA one; raises otherwise."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{what} must lie on the CPU or a CUDA device, got "
                         f"{x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{what}: the compression kernels take {dtype}, "
                         f"got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what} must be contiguous and 16-byte aligned")
    return False


_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {   # csrc/compress.cu's C entry points; the last is the stream
    "repro_quantize_pack": (_P, _L, _P, _I, _L, _P, _P, _P),
    "repro_dequantize_unpack": (_P, _P, _P, _I, _L, _P, _P, _P, _L, _P),
    "repro_sparsify": (_P, _L, _P, _L, _I, _P, _P),
    "repro_densify": (_P, _P, _L, _I, _L, _P, _P),
}


def _fn(name: str):
    fn = getattr(_build.library("compress"), name)
    fn.argtypes = list(_SIGNATURES[name])
    fn.restype = ctypes.c_int
    return fn


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


@functools.lru_cache(maxsize=1024)
def _device_ints(values: Tuple[int, ...], device) -> torch.Tensor:
    """``values`` as an int64 tensor on ``device``, made once: the lengths
    of a sched layer are fixed, and a fresh host-to-device copy would wait
    for the stream on every call.  Callers only read it."""
    return torch.tensor(values, dtype=torch.int64, device=device)


def _offsets(aligned_lengths: Sequence[int], device) -> torch.Tensor:
    run = [0]
    for n in aligned_lengths:
        run.append(run[-1] + n)
    return _device_ints(tuple(run), torch.device(device))


def _check_rows_fit(aligned_lengths: Sequence[int], lmax: int,
                    what: str) -> None:
    # the reference reads (quantize) or drops (dequantize) past the row
    if max(aligned_lengths) > lmax:
        raise ValueError(f"aligned lengths {tuple(aligned_lengths)} exceed "
                         f"{what} {lmax}")


# ---------------------------------------------------------------------------
# int8: per-TILE absmax quantization
# ---------------------------------------------------------------------------


def quantize_pack(segments: torch.Tensor, aligned_lengths: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, Lmax) f32 → (int8 payload (total,), f32 scales (total//TILE,))."""
    if segments.ndim != 2:
        raise ValueError(f"segments must be (K, Lmax), got "
                         f"{tuple(segments.shape)}")
    if segments.dtype != torch.float32:
        raise ValueError(f"quantize_pack expects float32 segments, got "
                         f"{segments.dtype}")
    k_count, lmax = segments.shape
    if lmax % TILE:
        raise ValueError(f"segment row length {lmax} is not a multiple of "
                         f"TILE={TILE}")
    _check_aligned_lengths(aligned_lengths, k_count)
    _check_rows_fit(aligned_lengths, lmax, "the row length")
    if _on_cpu(segments, "segments", torch.float32):
        return quantize_pack_ref(segments, aligned_lengths)
    total = sum(aligned_lengths)
    payload = torch.empty(total, dtype=torch.int8, device=segments.device)
    scales = torch.empty(total // TILE, dtype=torch.float32,
                         device=segments.device)
    tiles = _offsets([n // TILE for n in aligned_lengths], segments.device)
    status = _fn("repro_quantize_pack")(
        segments.data_ptr(), lmax, tiles.data_ptr(), k_count, total // TILE,
        payload.data_ptr(), scales.data_ptr(), _stream(segments))
    LAUNCHES["compress_quantize"] += 1
    _build.check(status, "compress_quantize")
    return payload, scales


def dequantize_unpack(payload: torch.Tensor, scales: torch.Tensor,
                      aligned_lengths: Sequence[int], lmax: int, *,
                      feedback: Optional[Tuple[torch.Tensor, torch.Tensor]]
                      = None) -> torch.Tensor:
    """(int8 payload, per-TILE scales) → (K, Lmax) f32 zero-padded rows.

    With ``feedback=(corrected, residual)`` (1-D, at most the first row's
    aligned length, ``corrected`` the buffer that was quantized) the same
    pass also writes ``residual = corrected - q * scale`` rounded once:
    the reference's error-feedback residual as XLA computes it."""
    if lmax % TILE:
        raise ValueError(f"lmax {lmax} is not a multiple of TILE={TILE}")
    k_count = len(aligned_lengths)
    _check_aligned_lengths(aligned_lengths, k_count)
    total = sum(aligned_lengths)
    if tuple(payload.shape) != (total,):
        raise ValueError(f"payload shape {tuple(payload.shape)} != "
                         f"({total},) implied by aligned lengths")
    if tuple(scales.shape) != (total // TILE,):
        raise ValueError(f"scales shape {tuple(scales.shape)} != "
                         f"({total // TILE},) (one per TILE={TILE})")
    _check_rows_fit(aligned_lengths, lmax, "lmax")
    corrected = residual = None
    if feedback is not None:
        corrected, residual = feedback
        if corrected.ndim != 1 or residual.shape != corrected.shape or \
                corrected.shape[0] > aligned_lengths[0]:
            raise ValueError(f"feedback buffers {tuple(corrected.shape)} / "
                             f"{tuple(residual.shape)} must be 1-D, alike "
                             f"and within the first row "
                             f"({aligned_lengths[0]})")
    if _on_cpu(payload, "payload", torch.int8):
        if residual is not None:
            residual.copy_(feedback_residual_ref(corrected, payload, scales))
        return dequantize_unpack_ref(payload, scales, aligned_lengths, lmax)
    for what, x, dtype in (("scales", scales, torch.float32),
                           ("corrected", corrected, torch.float32),
                           ("residual", residual, torch.float32)):
        if x is not None:
            _on_cpu(x, what, dtype)
            if x.device != payload.device:
                raise ValueError(f"{what} lies on {x.device}, payload on "
                                 f"{payload.device}")
    if k_count > _MAX_ROWS:
        raise ValueError(f"{k_count} rows exceed the launch limit of "
                         f"{_MAX_ROWS}")
    out = torch.empty((k_count, lmax), dtype=torch.float32,
                      device=payload.device)
    offsets = _offsets(aligned_lengths, payload.device)
    status = _fn("repro_dequantize_unpack")(
        payload.data_ptr(), scales.data_ptr(), offsets.data_ptr(), k_count,
        lmax, out.data_ptr(),
        0 if corrected is None else corrected.data_ptr(),
        0 if residual is None else residual.data_ptr(),
        0 if residual is None else residual.numel(), _stream(payload))
    LAUNCHES["compress_dequantize"] += 1
    _build.check(status, "compress_dequantize")
    return out


# ---------------------------------------------------------------------------
# top-k: index selection, gather, scatter
# ---------------------------------------------------------------------------


def topk_indices(segments: torch.Tensor, lengths: Sequence[int],
                 k: int) -> torch.Tensor:
    """Per-row magnitude top-k positions, deterministically.

    Ties break toward the lower index (a stable ascending sort of
    ``-|v|``, as the reference's ``argsort(-mag, stable=True)``; NaN sorts
    last); positions past the row's true ``lengths[i]`` never win; rows
    with fewer than ``k`` valid positions pad with -1.  Returned ascending
    per row, int32, with the -1 padding sorted to the front.
    """
    k_count, lmax = segments.shape
    if len(lengths) != k_count:
        raise ValueError(f"got {len(lengths)} lengths for {k_count} rows")
    if not 1 <= k <= lmax:
        raise ValueError(f"k={k} out of range for row length {lmax}")
    pos = torch.arange(lmax, device=segments.device)[None, :]
    valid = pos < _device_ints(tuple(lengths), segments.device)[:, None]
    key = torch.where(valid, -segments.abs(), 1.0)      # == -mag
    del valid
    order = torch.sort(key, dim=1, stable=True).indices[:, :k]
    chosen_valid = torch.gather(key, 1, order) <= 0     # mag >= 0
    del key
    idx = torch.where(chosen_valid, order, -1)
    return torch.sort(idx, dim=1).values.to(torch.int32)


def _check_sparse_shapes(indices: torch.Tensor, k_count: int) -> None:
    if indices.ndim != 2 or indices.shape[0] != k_count:
        raise ValueError(f"indices must be (K, kmax) with K={k_count}, got "
                         f"{tuple(indices.shape)}")
    if indices.dtype.is_floating_point or indices.dtype.is_complex or \
            indices.dtype == torch.bool:
        raise ValueError(f"indices must be integer, got {indices.dtype}")


def _int32_indices(indices: torch.Tensor, device) -> torch.Tensor:
    if indices.device != device:
        raise ValueError(f"indices lie on {indices.device}, expected "
                         f"{device}")
    return indices.to(torch.int32).contiguous()


def sparsify(segments: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Gather (K, kmax) values from (K, Lmax) rows; -1 slots yield 0."""
    if segments.ndim != 2:
        raise ValueError(f"segments must be (K, Lmax), got "
                         f"{tuple(segments.shape)}")
    k_count, lmax = segments.shape
    _check_sparse_shapes(indices, k_count)
    if _on_cpu(segments, "segments", torch.float32):
        return sparsify_ref(segments, indices)
    idx = _int32_indices(indices, segments.device)
    kmax = idx.shape[1]
    out = torch.empty((k_count, kmax), dtype=segments.dtype,
                      device=segments.device)
    status = _fn("repro_sparsify")(
        segments.data_ptr(), lmax, idx.data_ptr(), kmax, k_count,
        out.data_ptr(), _stream(segments))
    LAUNCHES["compress_sparsify"] += 1
    _build.check(status, "compress_sparsify")
    return out


def densify(values: torch.Tensor, indices: torch.Tensor,
            lmax: int) -> torch.Tensor:
    """Scatter (K, kmax) values back to dense (K, lmax); -1 slots drop.

    The indices of a row must be unique apart from -1 (what
    :func:`topk_indices` returns)."""
    if values.ndim != 2:
        raise ValueError(f"values must be (K, kmax), got "
                         f"{tuple(values.shape)}")
    k_count, kmax = values.shape
    _check_sparse_shapes(indices, k_count)
    if tuple(indices.shape) != tuple(values.shape):
        raise ValueError(f"indices shape {tuple(indices.shape)} != values "
                         f"shape {tuple(values.shape)}")
    if _on_cpu(values, "values", torch.float32):
        return densify_ref(values, indices, lmax)
    idx = _int32_indices(indices, values.device)
    out = torch.zeros((k_count, lmax), dtype=values.dtype,
                      device=values.device)
    status = _fn("repro_densify")(
        values.data_ptr(), idx.data_ptr(), kmax, k_count, lmax,
        out.data_ptr(), _stream(values))
    LAUNCHES["compress_densify"] += 1
    _build.check(status, "compress_densify")
    return out
