"""Mixture-of-experts sizing (the MoE layer itself waits for a later slice)."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig


def expert_capacity(num_tokens: int, cfg: ArchConfig) -> int:
    cap = int(num_tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(cap, cfg.top_k)
