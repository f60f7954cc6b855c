"""The ``Compressor`` carried on the push paths.

A compressor owns two things:

* **payload math** — ``roundtrip(flat)`` is compress-then-decompress of
  one FlatSpec buffer (what the server would reconstruct from the wire
  payload), and ``feedback_roundtrip(flat, residual)`` is the
  error-feedback variant, in place: the compression error of this push is kept in a
  per-(worker, layer) residual and re-injected into the next one, so the
  *accumulated* applied gradient is unbiased;
* **wire accounting** — ``wire_bytes(logical_bytes)`` maps fp32 payload
  bytes to what actually crosses the link (works elementwise on numpy
  arrays so the cost model can rescale whole ``gt`` vectors), plus a
  per-segment ``segment_overhead_bytes`` header cost.

The math goes through :mod:`repro_torch.kernels.compress`, whose wrappers
dispatch by the buffer's device: the CUDA kernels on the card, their
plain versions on the CPU.  The wire formulas are the reference's,
verbatim.

Schemes: ``none`` (identity), ``int8`` (per-TILE absmax quantization,
~3.97x on the wire), ``topk`` (magnitude top-k, index+value pairs,
``8 * ceil(fraction * n)`` wire bytes).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.compress.ops import (TILE, aligned, densify,
                                              dequantize_unpack,
                                              quantize_pack, sparsify,
                                              topk_indices)

SCHEMES = ("none", "int8", "topk")

Bytes = Union[float, int, np.ndarray]


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Identity compressor (scheme ``none``); also the subclass base."""

    error_feedback: bool = False

    scheme = "none"
    segment_overhead_bytes = 0.0

    # --- wire accounting -------------------------------------------------
    def wire_bytes(self, logical_bytes: Bytes) -> Bytes:
        """fp32 payload bytes → bytes actually crossing the link."""
        return np.asarray(logical_bytes, np.float64) * 1.0

    def ratio(self, logical_bytes: Bytes) -> float:
        """Compression ratio (>1 is smaller on the wire)."""
        wire = float(np.sum(self.wire_bytes(logical_bytes)))
        return float(np.sum(np.asarray(logical_bytes, np.float64))) / wire \
            if wire > 0 else 1.0

    # --- payload math ----------------------------------------------------
    def roundtrip(self, flat: torch.Tensor) -> torch.Tensor:
        """Compress-then-decompress one flat fp32 buffer."""
        return flat

    def feedback_roundtrip(self, flat: torch.Tensor, residual: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Error-feedback step, in place: returns (pushed payload, new
        residual).

        ``corrected = flat + residual`` is taken into ``flat`` (the caller
        gives it up), the payload is ``roundtrip(corrected)`` and the new
        residual ``corrected - payload`` is written into ``residual``."""
        corrected = flat.add_(residual)
        compressed = self.roundtrip(corrected)
        return compressed, torch.sub(corrected, compressed, out=residual)


@dataclasses.dataclass(frozen=True)
class Int8Compressor(Compressor):
    """Per-TILE absmax int8: 1 byte/elem + one fp32 scale per TILE."""

    scheme = "int8"

    def wire_bytes(self, logical_bytes: Bytes) -> Bytes:
        n = np.asarray(logical_bytes, np.float64) / 4.0
        return n + 4.0 * np.ceil(n / TILE)

    def _roundtrip(self, flat: torch.Tensor, residual=None) -> torch.Tensor:
        n = int(flat.shape[0])
        npad = aligned(n)
        seg = torch.nn.functional.pad(flat, (0, npad - n))[None, :]
        payload, scales = quantize_pack(seg, (npad,))
        del seg
        out = dequantize_unpack(
            payload, scales, (npad,), npad,
            feedback=None if residual is None else (flat, residual))
        return out[0, :n]

    def roundtrip(self, flat: torch.Tensor) -> torch.Tensor:
        return self._roundtrip(flat)

    def feedback_roundtrip(self, flat: torch.Tensor, residual: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """As :meth:`Compressor.feedback_roundtrip`, with the new residual
        ``corrected - q * scale`` rounded once: under jit XLA fuses the
        reference's ``corrected - compressed`` with the dequantizing
        product into a multiply-add, and the port computes the same
        numbers (in the dequantize pass)."""
        corrected = flat.add_(residual)
        return self._roundtrip(corrected, residual), residual


@dataclasses.dataclass(frozen=True)
class TopKCompressor(Compressor):
    """Magnitude top-k: ``ceil(fraction * n)`` (int32 index, fp32 value)
    pairs per buffer, plus a fixed per-segment length header."""

    fraction: float = 0.01

    scheme = "topk"
    segment_overhead_bytes = 8.0

    def __post_init__(self):
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"topk fraction must be in (0, 1], got "
                             f"{self.fraction}")

    def k_for(self, n: int) -> int:
        return max(1, int(math.ceil(self.fraction * n)))

    def wire_bytes(self, logical_bytes: Bytes) -> Bytes:
        n = np.asarray(logical_bytes, np.float64) / 4.0
        return 8.0 * np.maximum(1.0, np.ceil(self.fraction * n))

    def roundtrip(self, flat: torch.Tensor) -> torch.Tensor:
        n = int(flat.shape[0])
        row = flat[None, :]
        idx = topk_indices(row, (n,), self.k_for(n))
        values = sparsify(row, idx)
        return densify(values, idx, n)[0]


def make_compressor(scheme: str, *, topk_fraction: Optional[float] = None,
                    error_feedback: bool = True) -> Compressor:
    """Build a compressor (its math follows the device of each buffer)."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown compression scheme {scheme!r}; "
                         f"expected one of {SCHEMES}")
    if scheme == "none":
        if topk_fraction is not None:
            raise ValueError("topk_fraction only applies to scheme='topk'")
        return Compressor()
    if scheme == "int8":
        if topk_fraction is not None:
            raise ValueError("topk_fraction only applies to scheme='topk'")
        return Int8Compressor(error_feedback=error_feedback)
    if topk_fraction is None:
        raise ValueError("scheme='topk' requires topk_fraction")
    return TopKCompressor(error_feedback=error_feedback,
                          fraction=topk_fraction)
