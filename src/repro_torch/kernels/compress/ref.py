"""Plain PyTorch versions of the compression kernels (their oracles).

Each performs exactly the per-tile / per-row math of its kernel in
``csrc/compress.cu`` on the same partitioning, so the kernel's results
must equal these bit for bit.  The int8 arithmetic is the reference's as
it trains, under ``jit``: ``inv = 127 / absmax`` by true division (a
tensor divided by a tensor: ``127.0 / t`` would be ``reciprocal(t) * 127``
in PyTorch), ``scale = absmax * fp32(1/127)`` (XLA's rewrite of the
division by the constant), round half to even, and XLA's saturating int8
conversion with NaN -> 0.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

TILE = 512


def quantize_pack_ref(segments: torch.Tensor,
                      aligned_lengths: Sequence[int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, Lmax) f32 segments → (int8 payload, per-TILE f32 scales)."""
    one_127 = torch.tensor(1 / 127, dtype=torch.float32,
                           device=segments.device)
    qs, scales = [], []
    for k, n in enumerate(aligned_lengths):
        tiles = segments[k, :n].reshape(-1, TILE)
        absmax = tiles.abs().amax(dim=1)
        inv = torch.where(absmax > 0, torch.full_like(absmax, 127.0) / absmax,
                          0.0)
        r = torch.round(tiles * inv[:, None])
        q = torch.where(r.isnan(), 0.0, r.clamp(-128.0, 127.0))
        qs.append(q.to(torch.int8).reshape(-1))
        scales.append(absmax * one_127)
    return torch.cat(qs), torch.cat(scales)


def dequantize_unpack_ref(payload: torch.Tensor, scales: torch.Tensor,
                          aligned_lengths: Sequence[int],
                          lmax: int) -> torch.Tensor:
    """(int8 payload, scales) → (K, Lmax) f32, zero-padded past lengths."""
    rows = []
    off = toff = 0
    for n in aligned_lengths:
        tiles = payload[off:off + n].reshape(-1, TILE).to(torch.float32)
        s = scales[toff:toff + n // TILE]
        row = (tiles * s[:, None]).reshape(-1)
        rows.append(torch.nn.functional.pad(row, (0, lmax - n)))
        off += n
        toff += n // TILE
    return torch.stack(rows)


def feedback_residual_ref(corrected: torch.Tensor, payload: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
    """``corrected - q * scale`` rounded once, as XLA computes the
    reference's error-feedback residual under jit (a fused multiply-add):
    in float64 the product of an int8 and a float32 and its difference
    from a float32 near it are exact, so the one rounding is the cast."""
    n = corrected.shape[0]
    q = payload[:n].to(torch.float64)
    s = scales.repeat_interleave(TILE)[:n].to(torch.float64)
    return (corrected.to(torch.float64) - q * s).to(torch.float32)


def sparsify_ref(segments: torch.Tensor,
                 indices: torch.Tensor) -> torch.Tensor:
    """Gather values at per-row ``indices``; slots outside the row (the -1
    padding) yield 0."""
    lmax = segments.shape[1]
    valid = (indices >= 0) & (indices < lmax)
    gathered = torch.gather(segments, 1,
                            torch.where(valid, indices, 0).long())
    return torch.where(valid, gathered, 0.0)


def densify_ref(values: torch.Tensor, indices: torch.Tensor,
                lmax: int) -> torch.Tensor:
    """Scatter ``0.0 + value`` into zero rows (K, lmax); slots outside the
    row drop.  Indices are unique per row apart from -1, as
    ``ops.topk_indices`` returns them; the dropped slots all land in
    one spare column, cut off at the end."""
    k_count = values.shape[0]
    valid = (indices >= 0) & (indices < lmax)
    out = torch.zeros((k_count, lmax + 1), dtype=values.dtype,
                      device=values.device)
    out.scatter_(1, torch.where(valid, indices, lmax).long(), values + 0.0)
    return out[:, :lmax].contiguous()
