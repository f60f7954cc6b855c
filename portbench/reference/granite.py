"""The granite decoder as its configuration file states it, in plain
float32 PyTorch.

    x = embed[tokens] * embedding_multiplier
    per layer:  x += residual_multiplier * attn(rms(x, norm1))
                x += residual_multiplier * mlp_or_moe(rms(x, norm2))
    logits = rms(x, final_norm) @ embed.T / logits_scaling   (tied head)

``rms(x, s) = x / sqrt(mean(x^2) + eps) * (1 + s)``.  Attention: GQA
(query head h reads kv head h // (H / KV)), rotary embedding on the two
halves of each head, causal softmax of ``q k^T * attention_multiplier``.
MLP: SwiGLU, ``(silu(x W_gate) * (x W_up)) W_down``.  MoE: softmax router,
top-k by a stable descending sort (ties: the lower expert first), the k
weights renormalised, each expert holding at most
``C = max(int(N k capacity_factor / E), k)`` of the N tokens' assignments
taken in token-major order (the rest dropped), and the Switch load-balance
loss ``E * sum_e frac_e * mean_prob_e`` over all k assignments, weighted
by ``router_aux_loss_coef``.  The loss is the mean cross-entropy plus the
weighted aux of every layer.

Parameters: a dict kind -> list over layers (``embed`` and ``final_norm``
are single tensors), dense weights ``(in, out)``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.precision import mm

Params = Dict[str, Any]
DENSE = ("norm1", "norm2", "wq", "wk", "wv", "wo", "gate", "up", "down")
MOE = ("norm1", "norm2", "wq", "wk", "wv", "wo", "router", "e_gate",
       "e_up", "e_down")


def block_kinds(cfg: Dict[str, Any]) -> Tuple[str, ...]:
    return MOE if cfg.get("num_local_experts", 0) else DENSE


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, T, H, hd), positions 0..T-1."""
    t, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                        device=x.device) / hd))
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] \
        * inv[None, :]
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(cfg, h, wq, wk, wv, wo) -> torch.Tensor:
    b, t, _ = h.shape
    nh, nkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    q = rope(mm(h, wq).view(b, t, nh, hd), cfg["rope_theta"])
    k = rope(mm(h, wk).view(b, t, nkv, hd), cfg["rope_theta"])
    v = mm(h, wv).view(b, t, nkv, hd)
    rep = nh // nkv
    q = q.transpose(1, 2)                                   # (B, H, T, hd)
    k = k.transpose(1, 2).repeat_interleave(rep, dim=1)
    v = v.transpose(1, 2).repeat_interleave(rep, dim=1)
    s = mm(q, k.transpose(-1, -2)) * cfg["attention_multiplier"]
    future = torch.ones(t, t, dtype=torch.bool, device=h.device).triu(1)
    s = s.masked_fill(future, float("-inf"))
    o = mm(torch.softmax(s, dim=-1), v)                     # (B, H, T, hd)
    return mm(o.transpose(1, 2).reshape(b, t, nh * hd), wo)


def swiglu(x, gate, up, down) -> torch.Tensor:
    return mm(F.silu(mm(x, gate)) * mm(x, up), down)


def capacity(cfg, n: int) -> int:
    e, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    return max(int(n * k * cfg["capacity_factor"] / e), k)


def routing(cfg, probs: torch.Tensor):
    """(top weights (N, k), top experts (N, k), kept (N, k) bool)."""
    e, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    n = probs.shape[0]
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    flat = top_e.reshape(-1)
    onehot = F.one_hot(flat, e)
    before = (torch.cumsum(onehot, 0) - onehot).gather(1, flat[:, None])[:, 0]
    kept = (before < capacity(cfg, n)).view(n, k)
    return top_p, top_e, kept


def moe(cfg, x, router, e_gate, e_up, e_down) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    b, t, d = x.shape
    xf = x.reshape(-1, d)
    probs = torch.softmax(mm(xf, router), dim=-1)
    top_p, top_e, kept = routing(cfg, probs)
    out = torch.zeros_like(xf)
    for e in range(cfg["num_local_experts"]):
        tok, slot = torch.nonzero((top_e == e) & kept, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(xf[tok], e_gate[e], e_up[e], e_down[e])
        out = out.index_add(0, tok, y * top_p[tok, slot][:, None])
    num_e = cfg["num_local_experts"]
    counts = F.one_hot(top_e, num_e).float().sum((0, 1))
    aux = num_e * (counts / counts.sum() * probs.mean(0)).sum()
    return out.view(b, t, d), aux


def block(cfg, x, *leaves) -> Tuple[torch.Tensor, torch.Tensor]:
    p = dict(zip(block_kinds(cfg), leaves))
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    x = x + r * attention(cfg, rms(x, p["norm1"], eps), p["wq"], p["wk"],
                          p["wv"], p["wo"])
    h = rms(x, p["norm2"], eps)
    if "router" in p:
        y, aux = moe(cfg, h, p["router"], p["e_gate"], p["e_up"],
                     p["e_down"])
    else:
        y, aux = swiglu(h, p["gate"], p["up"], p["down"]), \
            torch.zeros((), device=x.device)
    return x + r * y, aux


def hidden(cfg, params: Params, tokens: torch.Tensor,
           remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The last layer's output (before the final norm) and the summed
    aux; with ``remat`` each block is recomputed in the backward."""
    x = F.embedding(tokens, params["embed"]) * cfg["embedding_multiplier"]
    aux = torch.zeros((), device=x.device)
    kinds = block_kinds(cfg)
    for i in range(cfg["num_hidden_layers"]):
        leaves = [params[k][i] for k in kinds]
        if remat:
            x, a = checkpoint(lambda *a_: block(cfg, *a_), x, *leaves,
                              use_reentrant=False)
        else:
            x, a = block(cfg, x, *leaves)
        aux = aux + a
    return x, aux


def head(cfg, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = rms(x, params["final_norm"], cfg["rms_norm_eps"])
    return mm(x, params["embed"].t()) / cfg["logits_scaling"]


def loss(cfg, params: Params, tokens, labels,
         remat: bool = True) -> torch.Tensor:
    x, aux = hidden(cfg, params, tokens, remat=remat)
    logits = head(cfg, params, x)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         labels.reshape(-1))
    return ce + cfg.get("router_aux_loss_coef", 0.0) * aux


def params_from_stacked(cfg, stacked: Dict[str, torch.Tensor],
                        grad: bool = False) -> Params:
    """Copies of the drawn weights, one tensor per layer and kind."""
    def own(x):
        x = x.clone()
        return x.requires_grad_() if grad else x
    out: Params = {"embed": own(stacked["embed"]),
                   "final_norm": own(stacked["final_norm"])}
    for k in block_kinds(cfg):
        out[k] = [own(x) for x in stacked[k].unbind(0)]
    return out


def leaf_items(cfg, params: Params):
    """``((kind, layer), tensor)`` for every leaf, in a fixed order."""
    yield ("embed", None), params["embed"]
    yield ("final_norm", None), params["final_norm"]
    for i in range(cfg["num_hidden_layers"]):
        for k in sorted(block_kinds(cfg)):
            yield (k, i), params[k][i]

