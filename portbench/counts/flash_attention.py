"""``flash_fwd_kernel`` (the port's ``csrc/flash_attention.cu``): one
forward call's operations and bytes."""

from __future__ import annotations

import re

KERNEL = re.compile(r"flash_fwd_kernel")


def live_pairs(t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps for T queries over T keys: query
    q sees keys ``max(0, q - window + 1)..q`` (causal) or ``..T - 1``."""
    if causal and (window <= 0 or window >= t):
        return t * (t + 1) // 2
    total = 0
    for q in range(t):
        hi = q if causal else t - 1
        lo = max(0, q - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def ops(b: int, h: int, hd: int, t: int, causal: bool = True,
        window: int = 0) -> int:
    """Q K^T and P V: 2 x hd multiply-adds each, a pair a head."""
    return 4 * b * h * hd * live_pairs(t, causal, window)


def nbytes(b: int, h: int, hkv: int, t: int, hd: int,
           itemsize: int = 4) -> int:
    """q and o of H heads, k and v of HKV heads, each once."""
    return itemsize * (2 * b * h * t * hd + 2 * b * hkv * t * hd)


def bound_s(call: dict, peaks: dict) -> float:
    """The least time one call can take on the card."""
    o = ops(call["b"], call["h"], call["hd"], call["t"], call["causal"],
            call["window"])
    n = nbytes(call["b"], call["h"], call["hkv"], call["t"], call["hd"])
    return max(o / peaks["flops"], n / peaks["bytes_per_s"])
