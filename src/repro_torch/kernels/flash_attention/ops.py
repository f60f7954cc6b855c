"""Public wrapper of the CUDA flash-attention forward, with its gradient.

``flash_attention(q, k, v, causal, window, softcap, scale)`` keeps the
reference's ``(B, H, T, hd)`` signature (``scale``, the scores' factor,
defaults to 1 / sqrt(hd)).  v's head dim may differ from q's and k's
(latent attention: Q K^T over 192, P V over 128); the output takes v's.
On a CUDA tensor it launches ``csrc/flash_attention.cu`` (GQA by kv-head
index, any T, the head dims as they are: one template a width where q, k
and v share it, the 192 / 128 template where v's is narrower) or raises;
on a CPU tensor it runs the plain version ``_ref_fwd``.
The inputs may be strided views: the model passes ``(B, T, H, hd)``
tensors transposed to ``(B, H, T, hd)`` without a copy.

The backward is not a kernel, as in the reference (``custom_vjp`` through
the jnp oracle): :class:`_FlashAttention` recomputes the plain attention
under autograd and returns its vector-Jacobian product.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
# the template where v's head dim differs from q's and k's: Q K^T over up
# to 192 columns, P V and O over up to 128
MAX_SPLIT_DIMS = (192, 128)
LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0}
# of those launches, the ones that took the template of a narrower v
# (latent attention's); not a kernel of its own, so not in
# ``kernels.launch_counts()``
NARROW_V_LAUNCHES: Dict[str, int] = {"flash_attention_fwd@mla": 0}


def _ref_fwd(q, k, v, causal, window, softcap, scale=None):
    h, hkv = q.shape[1], k.shape[1]
    rep = h // hkv
    kb = torch.repeat_interleave(k, rep, dim=1) if rep > 1 else k
    vb = torch.repeat_interleave(v, rep, dim=1) if rep > 1 else v
    return attention_ref(q, kb, vb, causal=causal, window=window,
                         softcap=softcap, scale=scale)


def _check(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (B, H, T, hd)")
    b, h, _, hd = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[1]} kv heads")


def _launch(q, k, v, causal: bool, window: int, softcap: float,
            scale: Optional[float] = None) -> torch.Tensor:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} must lie on {q.device}, got {x.device}")
        if x.dtype != q.dtype or x.dtype not in DTYPES:
            raise ValueError(f"flash_attention takes one dtype of {DTYPES}, "
                             f"got {q.dtype}/{k.dtype}/{v.dtype}")
        if x.stride(3) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
    b, h, tq, hd = q.shape
    hkv, tk, hdv = k.shape[1], k.shape[2], v.shape[3]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} > {MAX_HEAD_DIM}")
    if hdv != hd and (hd > MAX_SPLIT_DIMS[0] or hdv > MAX_SPLIT_DIMS[1]):
        raise ValueError(f"q / k head dim {hd} with v head dim {hdv}: a "
                         f"narrower v takes at most {MAX_SPLIT_DIMS}")
    # (B, T, H, hdv) storage, handed back as a (B, H, T, hdv) view
    out = torch.empty((b, tq, h, hdv), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *(x.stride(i) for x in (q, k, v, out) for i in (0, 1, 2)))
    fn = _build.library("flash_attention").repro_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                int(q.dtype == torch.bfloat16), b, h, hkv, tq, tk, hd, hdv,
                ctypes.cast(strides, ctypes.c_void_p),
                1.0 / hd ** 0.5 if scale is None else float(scale),
                float(softcap), int(causal), int(window),
                torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["flash_attention_fwd"] += 1
    if hdv != hd:
        NARROW_V_LAUNCHES["flash_attention_fwd@mla"] += 1
    _build.check(status, "flash_attention_fwd")
    return out


class _FlashAttention(torch.autograd.Function):
    """Kernel forward, plain-attention backward (the reference's pairing)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, softcap, scale)
        return _launch(q, k, v, causal, window, softcap, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            q_, k_, v_ = (x.detach().requires_grad_() for x in (q, k, v))
            out = _ref_fwd(q_, k_, v_, *ctx.args)
            dq, dk, dv = torch.autograd.grad(out, (q_, k_, v_), g)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Tq, hd); k: (B, Hkv, Tk, hd); v: (B, Hkv, Tk, hdv) →
    (B, H, Tq, hdv)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return _ref_fwd(q, k, v, causal, window, softcap, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on the CPU or a CUDA device, "
                         f"got {q.device}")
    return _FlashAttention.apply(q, k, v, causal, window, softcap, scale)
