"""Recurrent blocks: the RG-LRU of RecurrentGemma / Griffin (train, prefill).

The RG-LRU (real-gated linear recurrent unit, arXiv:2402.19427 §2.4) inside
the Griffin recurrent block: input projection → 4-tap temporal conv →
gated linear recurrence → gated output projection.  It follows the
reference (``repro/models/ssm.py``), not the published Griffin: dense W×W
gates and the same parameter keys, shapes and arithmetic order.

The recurrence always goes through ``kernels/rglru_scan``: the CUDA kernel
on a CUDA tensor, its plain loop on a CPU tensor.  The reference's
``use_kernel`` switch (off by default there, which left its model on
``jax.lax.associative_scan``) is gone: dispatch goes by the tensor's
device, as for attention.  Decode (the O(1)-state step) waits for the
serving slice; mLSTM and sLSTM wait for a later one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.models.attention import DECODE_PENDING
from repro_torch.models.layers import dense, init_dense, normal

_RGLRU_C = 8.0
_CONV_WIDTH = 4


class RGLRUState(NamedTuple):
    h: torch.Tensor       # (B, W) recurrent state
    conv: torch.Tensor    # (B, CONV_WIDTH-1, W) trailing inputs for the conv


def _uniform(gen, shape, lo: float, hi: float, device) -> torch.Tensor:
    """``U(lo, hi)`` in fp32; shapes only on ``meta``."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return u * (hi - lo) + lo


def init_rglru_params(gen, cfg: ArchConfig, dtype=torch.float32,
                      device="cpu"):
    d = cfg.d_model
    w = cfg.rglru_lru_width or d
    # Λ init so a^c stays in (0.9, 0.999) — Griffin appendix
    lam = _uniform(gen, (w,), 0.9, 0.999, device)
    lam_param = torch.log(torch.exp(-torch.log(lam) / _RGLRU_C) - 1.0)
    return {
        "in_x": init_dense(gen, d, w, dtype, device),
        "in_gate": init_dense(gen, d, w, dtype, device),
        "conv": normal(gen, (_CONV_WIDTH, w), 0.1, dtype, device),
        "w_rgate": init_dense(gen, w, w, dtype, device),
        "w_igate": init_dense(gen, w, w, dtype, device),
        "lam": lam_param.float(),
        "out": init_dense(gen, w, d, dtype, device),
    }


def init_rglru_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device="cpu") -> RGLRUState:
    w = cfg.rglru_lru_width or cfg.d_model
    return RGLRUState(
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, _CONV_WIDTH - 1, w), dtype=dtype,
                         device=device))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere (``F.softplus``
    turns into the identity above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rglru_gates(params, u: torch.Tensor):
    """u: (..., W) post-conv activations → (a, gated input), float32."""
    r = torch.sigmoid(dense(u, params["w_rgate"]).float())
    i = torch.sigmoid(dense(u, params["w_igate"]).float())
    log_a = -_RGLRU_C * _softplus(params["lam"]) * r
    a = torch.exp(log_a)
    x_in = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * i * u.float()
    return a, x_in


def apply_rglru(params, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
                state: Optional[RGLRUState] = None
                ) -> Tuple[torch.Tensor, Optional[RGLRUState]]:
    """Returns (output (B, T, d_model), the prefill state or None)."""
    if mode not in ("train", "prefill"):
        raise NotImplementedError(DECODE_PENDING)
    b, t, _ = x.shape
    gate = F.gelu(dense(x, params["in_gate"]), approximate="tanh")
    u = dense(x, params["in_x"])                                  # (B, T, W)

    pad = torch.zeros((b, _CONV_WIDTH - 1, u.shape[-1]), dtype=u.dtype,
                      device=u.device)
    upad = torch.cat([pad, u], dim=1)
    # a Python sum from 0, in tap order, as the reference's
    conv = sum(upad[:, i:i + t] * params["conv"][i].to(u.dtype)
               for i in range(_CONV_WIDTH))
    a, x_in = _rglru_gates(params, conv)
    h = rglru_scan(a, x_in)
    new_state = None
    if mode == "prefill":
        new_state = RGLRUState(h=h[:, -1], conv=upad[:, -(_CONV_WIDTH - 1):])
    out = h.to(x.dtype)
    return dense(out * gate, params["out"]), new_state
