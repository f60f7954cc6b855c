"""Public wrapper of the CUDA RG-LRU scan, with its gradient.

``rglru_scan(a, x)`` keeps the reference's signature: ``h_t = a_t·h_{t-1} +
x_t`` over axis 1 of ``(B, T, W)`` f32 or bf16 tensors, with an fp32 carry.
Dispatch goes by the tensor's device only: on a CUDA tensor
``csrc/rglru_scan.cu`` launches (or the wrapper raises); on a CPU tensor the
plain loop of ``ref.py`` runs.  ``LAUNCHES`` counts kernel launches.

The gradient is the transpose of the linear recurrence, as the reference's
``custom_vjp`` computes it (the VJP of its associative scan): the cotangent
runs through the same recurrence in reverse, ``dh_t = g_t + a_{t+1}·dh_{t+1}``
with ``a_T = 0`` (the kernel again, on the card), then ``da_t = dh_t·h_{t-1}``
and ``dx_t = dh_t``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

DTYPES = (torch.float32, torch.bfloat16)
LAUNCHES: Dict[str, int] = {"rglru_scan": 0}


def _check(a: torch.Tensor, x: torch.Tensor) -> None:
    if a.ndim != 3 or a.shape != x.shape:
        raise ValueError(f"a {tuple(a.shape)} and x {tuple(x.shape)} must "
                         f"be one (B, T, W) shape")
    if a.dtype != x.dtype or a.dtype not in DTYPES:
        raise ValueError(f"rglru_scan takes one dtype of {DTYPES}, got "
                         f"{a.dtype}/{x.dtype}")
    if a.device != x.device or a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rglru_scan runs on the CPU or a CUDA device, got "
                         f"{a.device}/{x.device}")


def _launch(a: torch.Tensor, x: torch.Tensor, reverse: bool) -> torch.Tensor:
    a, x = a.contiguous(), x.contiguous()
    h = torch.empty_like(x)
    b, t, w = a.shape
    fn = _build.library("rglru_scan").repro_rglru_scan
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(a.data_ptr(), x.data_ptr(), h.data_ptr(),
                int(a.dtype == torch.bfloat16), b, t, w, int(reverse),
                torch.cuda.current_stream(a.device).cuda_stream)
    LAUNCHES["rglru_scan"] += 1
    _build.check(status, "rglru_scan")
    return h


def scan(a: torch.Tensor, x: torch.Tensor,
         reverse: bool = False) -> torch.Tensor:
    """The recurrence without autograd: the kernel on a CUDA tensor, the
    plain loop on a CPU tensor; ``reverse`` runs it from the end."""
    _check(a, x)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, x, reverse)
    return _launch(a, x, reverse)


class _RGLRUScan(torch.autograd.Function):
    """Forward scan; backward the reverse scan of the shifted ``a``."""

    @staticmethod
    def forward(ctx, a, x):
        h = scan(a, x)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        a_next = F.pad(a[:, 1:], (0, 0, 0, 1))          # a_{t+1}, a_T = 0
        dh = scan(a_next, g, reverse=True)
        h_prev = F.pad(h[:, :-1], (0, 0, 1, 0))          # h_{t-1}, h_-1 = 0
        return dh * h_prev, dh


def rglru_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + x_t over axis 1; a, x: (B, T, W)."""
    _check(a, x)
    return _RGLRUScan.apply(a, x)
