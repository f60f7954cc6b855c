"""Public wrapper of the CUDA flash-attention forward, with its gradient.

``flash_attention(q, k, v, causal, window, softcap)`` keeps the
reference's ``(B, H, T, hd)`` signature.  On a CUDA tensor it launches
``csrc/flash_attention.cu`` (GQA by kv-head index, any T, the head dim as
it is) or raises; on a CPU tensor it runs the plain version ``_ref_fwd``.
The inputs may be strided views: the model passes ``(B, T, H, hd)``
tensors transposed to ``(B, H, T, hd)`` without a copy.

The backward is not a kernel, as in the reference (``custom_vjp`` through
the jnp oracle): :class:`_FlashAttention` recomputes the plain attention
under autograd and returns its vector-Jacobian product.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0}


def _ref_fwd(q, k, v, causal, window, softcap):
    h, hkv = q.shape[1], k.shape[1]
    rep = h // hkv
    kb = torch.repeat_interleave(k, rep, dim=1) if rep > 1 else k
    vb = torch.repeat_interleave(v, rep, dim=1) if rep > 1 else v
    return attention_ref(q, kb, vb, causal=causal, window=window,
                         softcap=softcap)


def _check(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (B, H, T, hd)")
    b, h, _, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[1]} kv heads")


def _launch(q, k, v, causal: bool, window: int,
            softcap: float) -> torch.Tensor:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} must lie on {q.device}, got {x.device}")
        if x.dtype != q.dtype or x.dtype not in DTYPES:
            raise ValueError(f"flash_attention takes one dtype of {DTYPES}, "
                             f"got {q.dtype}/{k.dtype}/{v.dtype}")
        if x.stride(3) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
    b, h, tq, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} > {MAX_HEAD_DIM}")
    # (B, T, H, hd) storage, handed back as a (B, H, T, hd) view
    out = torch.empty((b, tq, h, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *(x.stride(i) for x in (q, k, v, out) for i in (0, 1, 2)))
    fn = _build.library("flash_attention").repro_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                int(q.dtype == torch.bfloat16), b, h, hkv, tq, tk, hd,
                ctypes.cast(strides, ctypes.c_void_p), 1.0 / hd ** 0.5,
                float(softcap), int(causal), int(window),
                torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["flash_attention_fwd"] += 1
    _build.check(status, "flash_attention_fwd")
    return out


class _FlashAttention(torch.autograd.Function):
    """Kernel forward, plain-attention backward (the reference's pairing)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, softcap)
        return _launch(q, k, v, causal, window, softcap)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            q_, k_, v_ = (x.detach().requires_grad_() for x in (q, k, v))
            out = _ref_fwd(q_, k_, v_, *ctx.args)
            dq, dk, dv = torch.autograd.grad(out, (q_, k_, v_), g)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, Tq, hd); k,v: (B, Hkv, Tk, hd) → (B, H, Tq, hd)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return _ref_fwd(q, k, v, causal, window, softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on the CPU or a CUDA device, "
                         f"got {q.device}")
    return _FlashAttention.apply(q, k, v, causal, window, softcap)
