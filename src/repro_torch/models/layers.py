"""Shared neural-net building blocks (plain functions on tensors).

Weights keep the reference's layout: dense weights are ``(in, out)`` so
that ``dense(x, w) = x @ w``.  Initialisers draw from an explicit
``torch.Generator``; on the ``meta`` device they only make shapes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def normal(gen: torch.Generator | None, shape, std: float, dtype,
           device) -> torch.Tensor:
    """``N(0, std²)`` drawn in fp32 and cast; shapes only on ``meta``."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(std).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def init_dense(gen, in_dim: int, out_dim: int, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    return normal(gen, (in_dim, out_dim), 1.0 / np.sqrt(in_dim), dtype,
                  device)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w.to(x.dtype))


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return logits
    return cap * torch.tanh(logits / cap)


def activation_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "geglu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


# ---------------------------------------------------------------------------
# MLP (optionally gated: SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def init_mlp(gen, d_model: int, d_ff: int, gated: bool, dtype=torch.float32,
             device="cpu"):
    p = {"up": init_dense(gen, d_model, d_ff, dtype, device),
         "down": init_dense(gen, d_ff, d_model, dtype, device)}
    if gated:
        p["gate"] = init_dense(gen, d_model, d_ff, dtype, device)
    return p


def apply_mlp(params, x, act_name: str):
    act = activation_fn(act_name)
    up = dense(x, params["up"])
    if "gate" in params:
        up = act(dense(x, params["gate"])) * up
    else:
        up = act(up)
    return dense(up, params["down"])


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, head_dim); positions: broadcastable to (..., T)."""
    head_dim = x.shape[-1]
    freqs = torch.as_tensor(rope_frequencies(head_dim, theta),
                            dtype=torch.float32, device=x.device)
    angles = positions[..., None].float() * freqs        # (..., T, hd/2)
    angles = angles[..., None, :]                         # (..., T, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def init_embedding(gen, vocab: int, d_model: int, dtype=torch.float32,
                   device="cpu"):
    return normal(gen, (vocab, d_model), 0.02, dtype, device)


def embed(tokens: torch.Tensor, table: torch.Tensor,
          scale: bool = True) -> torch.Tensor:
    x = F.embedding(tokens.long(), table)
    if scale:
        x = x * float(np.float32(np.sqrt(table.shape[-1])))
    return x


def logits_from_embedding(x: torch.Tensor, table: torch.Tensor,
                          final_cap: float = 0.0) -> torch.Tensor:
    out = torch.matmul(x, table.to(x.dtype).t())
    return softcap(out, final_cap)
