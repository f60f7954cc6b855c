"""Latent attention's causal softmax attention (``repro_torch.models.
attention.mla`` through ``flash_attention``, inside the port's
``mla.attention`` span): one call's operations and bytes, the same
whatever implements it.

Operations: ``Q K^T`` over the q / k head dim (nope + rope) and ``P V``
over v's, a multiply-add each (two operations) a live (query, key) pair a
head.  Bytes: q, k (H heads of the q / k dim each), v and o (H heads of
v's dim each), float32, each read or written once.  The bound is the
larger of operations over the float32 peak and bytes over the memory's.
"""

from __future__ import annotations

from typing import Any, Dict

from portbench.counts.model_flops import causal_pairs


def call(cfg: Dict[str, Any], b: int, t: int) -> Dict[str, int]:
    """One call of a configuration file's MLA layer at (b, t), causal."""
    return {"b": b, "t": t, "h": cfg["num_attention_heads"],
            "dqk": cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
            "dv": cfg["v_head_dim"]}


def ops(b: int, t: int, h: int, dqk: int, dv: int) -> int:
    return 2 * b * h * causal_pairs(t) * (dqk + dv)


def nbytes(b: int, t: int, h: int, dqk: int, dv: int,
           itemsize: int = 4) -> int:
    return itemsize * b * t * (h * dqk + h * dqk + h * dv + h * dv)


def bound_s(c: Dict[str, int], peaks: dict) -> float:
    """The least time one call can take on the card."""
    return max(ops(**c) / peaks["flops"],
               nbytes(**c) / peaks["bytes_per_s"])
