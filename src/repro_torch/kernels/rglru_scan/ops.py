"""Public wrapper of the CUDA RG-LRU scan, with its gradient.

``rglru_scan(a, x)`` keeps the reference's signature: ``h_t = a_t·h_{t-1} +
x_t`` over axis 1 of ``(B, T, W)`` f32 or bf16 tensors, with an fp32 carry.
Dispatch goes by the tensor's device only: on a CUDA tensor
``csrc/rglru_scan.cu`` launches (or the wrapper raises); on a CPU tensor the
plain loop of ``ref.py`` runs.  ``LAUNCHES["rglru_scan"]`` counts launches
of the scan (forward or reverse), ``LAUNCHES["rglru_scan_bwd"]`` those of
the fused backward.

The gradient is the transpose of the linear recurrence, as the reference's
``custom_vjp`` computes it (the VJP of its associative scan): the cotangent
runs through the same recurrence in reverse, ``dh_t = g_t + a_{t+1}·dh_{t+1}``
with ``a_T = 0``, then ``da_t = dh_t·h_{t-1}`` and ``dx_t = dh_t``.  On the
card that is one launch of the fused backward kernel (:func:`scan_backward`);
on the CPU its plain version, ``ref.rglru_scan_backward_ref``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_backward_ref,
                                                rglru_scan_ref)

DTYPES = (torch.float32, torch.bfloat16)
LAUNCHES: Dict[str, int] = {"rglru_scan": 0, "rglru_scan_bwd": 0}


def _check(a: torch.Tensor, *others: torch.Tensor) -> None:
    names = ", ".join(f"{tuple(t.shape)}" for t in (a, *others))
    if a.ndim != 3 or any(t.shape != a.shape for t in others):
        raise ValueError(f"the inputs {names} must be one (B, T, W) shape")
    if a.dtype not in DTYPES or any(t.dtype != a.dtype for t in others):
        raise ValueError(f"rglru_scan takes one dtype of {DTYPES}, got "
                         f"{[t.dtype for t in (a, *others)]}")
    if a.device.type not in ("cpu", "cuda") or any(
            t.device != a.device for t in others):
        raise ValueError(f"rglru_scan runs on the CPU or a CUDA device, got "
                         f"{[str(t.device) for t in (a, *others)]}")


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {   # csrc/rglru_scan.cu's C entry points; the last is the stream
    "repro_rglru_scan": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "repro_rglru_scan_backward": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}


def _fn(name: str):
    fn = getattr(_build.library("rglru_scan"), name)
    fn.argtypes = list(_SIGNATURES[name])
    fn.restype = ctypes.c_int
    return fn


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(a: torch.Tensor, x: torch.Tensor, reverse: bool) -> torch.Tensor:
    a, x = a.contiguous(), x.contiguous()
    h = torch.empty_like(x)
    status = _fn("repro_rglru_scan")(
        a.data_ptr(), x.data_ptr(), h.data_ptr(),
        int(a.dtype == torch.bfloat16), *a.shape, int(reverse), _stream(a))
    LAUNCHES["rglru_scan"] += 1
    _build.check(status, "rglru_scan")
    return h


def _launch_backward(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    a, h, g = a.contiguous(), h.contiguous(), g.contiguous()
    da, dx = torch.empty_like(a), torch.empty_like(a)
    status = _fn("repro_rglru_scan_backward")(
        a.data_ptr(), h.data_ptr(), g.data_ptr(), da.data_ptr(),
        dx.data_ptr(), int(a.dtype == torch.bfloat16), *a.shape, _stream(a))
    LAUNCHES["rglru_scan_bwd"] += 1
    _build.check(status, "rglru_scan_bwd")
    return da, dx


def scan(a: torch.Tensor, x: torch.Tensor,
         reverse: bool = False) -> torch.Tensor:
    """The recurrence without autograd: the kernel on a CUDA tensor, the
    plain loop on a CPU tensor; ``reverse`` runs it from the end."""
    _check(a, x)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, x, reverse)
    return _launch(a, x, reverse)


def scan_backward(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(da, dx)``, the gradient of ``h = scan(a, x)`` for the cotangent
    ``g``: one launch of the fused kernel on a CUDA tensor, its plain
    version (pad, reverse loop, multiply) on a CPU tensor."""
    _check(a, h, g)
    if a.device.type == "cpu":
        return rglru_scan_backward_ref(a, h, g)
    return _launch_backward(a, h, g)


class _RGLRUScan(torch.autograd.Function):
    """Forward scan; backward the fused reverse scan of the shifted ``a``."""

    @staticmethod
    def forward(ctx, a, x):
        h = scan(a, x)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        return scan_backward(a, h, g)


def rglru_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + x_t over axis 1; a, x: (B, T, W)."""
    _check(a, x)
    return _RGLRUScan.apply(a, x)
