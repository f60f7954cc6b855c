"""Model FLOPs of a training step of a granite 4.0-H configuration file,
for ``mfu``.

6 x (matrix-product parameters a token) x tokens: each Mamba-2 layer's
``in_proj`` and ``out_proj``, each attention layer's four projections,
every layer's router and shared expert, and the tied head (``V x d``; the
embedding lookup is not a product).  The experts count only the
assignments this device's share kept (``kept_fraction``: kept over routed,
pooled over the layers; ``None``: the held share of every assignment).
Then the attention layers' causal ``Q K^T`` and ``P V`` and the Mamba-2
layers' SSD (``counts/mamba2_ssd.py``), forward once and backward twice.
The depthwise conv (8 operations a channel and token) and the
elementwise work are left out; recomputation is not counted.  The serving
count is not given: no serving cell runs this family.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from portbench.counts import mamba2_ssd
from portbench.counts.model_flops import causal_pairs


def _products(cfg: Dict[str, Any]) -> int:
    """Product parameters a token sees, the experts left out."""
    d = cfg["hidden_size"]
    types = cfg["layer_types"][:cfg["num_hidden_layers"]]
    h, p = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    gn = cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    mamba = d * (2 * h * p + 2 * gn + h) + h * p * d
    hd = cfg["head_dim"]
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    attention = 2 * d * q + 2 * d * kv
    every = d * cfg["num_router_experts"] \
        + 3 * d * cfg["shared_intermediate_size"]
    return (types.count("mamba") * mamba + types.count("attention")
            * attention + len(types) * every + cfg["vocab_size"] * d)


def train_step(cfg: Dict[str, Any], batch: int, seq: int,
               kept_fraction: Optional[float] = None) -> float:
    tokens = batch * seq
    types = cfg["layer_types"][:cfg["num_hidden_layers"]]
    flops = 6.0 * tokens * _products(cfg)
    share = cfg["num_local_experts"] / cfg["num_router_experts"] \
        if kept_fraction is None else kept_fraction
    kept = tokens * cfg["num_experts_per_tok"] * share
    flops += 6.0 * len(types) * kept * 3 * cfg["hidden_size"] \
        * cfg["intermediate_size"]
    flops += 3.0 * types.count("attention") * 4 * batch \
        * cfg["num_attention_heads"] * cfg["head_dim"] * causal_pairs(seq)
    c = mamba2_ssd.call(cfg, batch, seq)
    flops += 3.0 * types.count("mamba") * mamba2_ssd.ops(
        c["b"], c["t"], c["h"], c["p"], c["n"], c["g"], c["chunk"])
    return flops
