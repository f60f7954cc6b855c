"""Model FLOPs of a training step of a DeepSeek-V3-style configuration
file, for ``mfu``.

6 x (matrix-product parameters a token) x tokens: each layer's latent
attention (``W_q``, ``W_kva``, ``W_kvb``, ``W_o``), the dense layers'
SwiGLU, each MoE layer's router and shared experts, and the untied head
(``V x d``; the embedding lookup is not a product).  The routed experts
count only the assignments this device's share kept (``kept_fraction``:
kept over routed, pooled over the layers; ``None``: the held share of
every assignment).  Then each layer's causal attention
(``counts/mla_attention.py``: Q K^T over the q / k head dim, P V over
v's), forward once and backward twice.  The elementwise work is left out;
recomputation is not counted.  The serving count is not given: no serving
cell runs this family.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from portbench.counts import mla_attention


def mla_products(cfg: Dict[str, Any]) -> int:
    """One layer's latent-attention product parameters."""
    d, h, r = (cfg["hidden_size"], cfg["num_attention_heads"],
               cfg["kv_lora_rank"])
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    return d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv) \
        + h * dv * d


def _products(cfg: Dict[str, Any]) -> int:
    """Product parameters a token sees, the routed experts left out."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    dense = min(cfg["first_k_dense_replace"], L)
    moe = d * cfg["num_router_experts"] + 3 * d * cfg["n_shared_experts"] \
        * cfg["moe_intermediate_size"]
    return L * mla_products(cfg) + dense * 3 * d * cfg["intermediate_size"] \
        + (L - dense) * moe + cfg["vocab_size"] * d


def train_step(cfg: Dict[str, Any], batch: int, seq: int,
               kept_fraction: Optional[float] = None) -> float:
    tokens = batch * seq
    L = cfg["num_hidden_layers"]
    flops = 6.0 * tokens * _products(cfg)
    share = cfg["n_routed_experts"] / cfg["num_router_experts"] \
        if kept_fraction is None else kept_fraction
    kept = tokens * cfg["num_experts_per_tok"] * share
    moe_layers = L - min(cfg["first_k_dense_replace"], L)
    flops += 6.0 * moe_layers * kept * 3 * cfg["hidden_size"] \
        * cfg["moe_intermediate_size"]
    flops += 3.0 * L * mla_attention.ops(**mla_attention.call(cfg, batch,
                                                              seq))
    return flops
