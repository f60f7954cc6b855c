"""Model FLOPs of a step, from the configuration's sizes, for ``mfu``.

Training: 6 x (matrix-product parameters a token) x tokens, plus causal
attention (Q K^T and P V, forward once and backward twice).  The tied
head counts as a product (``V x d``); the embedding lookup does not.  An
MoE layer counts its router for every token and its experts only for the
assignments the router kept.  Recomputation is not counted.

Serving: the prefill's products for every prompt token and the head for
its last position, then a decode step per served token after the first
(2 x parameters a token, attention over the positions cached so far).
"""

from __future__ import annotations

from typing import Any, Dict, Optional


def _sizes(cfg: Dict[str, Any]):
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    h, kv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    return L, d, h, kv, hd, cfg["intermediate_size"], cfg["vocab_size"]


def _dense_params(cfg) -> int:
    """Product parameters a token sees in one layer, experts left out."""
    L, d, h, kv, hd, f, V = _sizes(cfg)
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    e = cfg.get("num_local_experts", 0)
    return attn + (d * e if e else 3 * d * f)


def _expert_params(cfg) -> int:
    _, d, _, _, _, f, _ = _sizes(cfg)
    return 3 * d * f


def causal_pairs(t: int) -> int:
    return t * (t + 1) // 2


def train_step(cfg: Dict[str, Any], batch: int, seq: int,
               kept_fraction: Optional[float] = None) -> float:
    """``kept_fraction``: the share of the router's assignments within
    capacity (MoE; ``None`` counts them all)."""
    L, d, h, kv, hd, f, V = _sizes(cfg)
    tokens = batch * seq
    flops = 6.0 * tokens * (L * _dense_params(cfg) + V * d)
    k = cfg.get("num_experts_per_tok", 0)
    if k:
        kept = tokens * k * (1.0 if kept_fraction is None else kept_fraction)
        flops += 6.0 * L * kept * _expert_params(cfg)
    flops += 3.0 * L * 4 * batch * h * hd * causal_pairs(seq)
    return flops


def serve_batch(cfg: Dict[str, Any], batch: int, prompt: int,
                new_tokens: int) -> float:
    """A batch of ``batch`` prompts of ``prompt`` tokens, ``new_tokens``
    served each (the first from the prefill)."""
    L, d, h, kv, hd, f, V = _sizes(cfg)
    k = cfg.get("num_experts_per_tok", 0)
    per_token = L * (_dense_params(cfg) + k * _expert_params(cfg))
    flops = 2.0 * batch * prompt * per_token + 2.0 * batch * V * d
    flops += L * 4.0 * batch * h * hd * causal_pairs(prompt)
    for i in range(1, new_tokens):
        keys = prompt + i           # the token fed sits at prompt + i - 1
        flops += 2.0 * batch * (per_token + V * d)
        flops += L * 4.0 * batch * h * hd * keys
    return flops
