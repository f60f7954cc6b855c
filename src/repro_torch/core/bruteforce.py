"""Exact brute-force oracle for the Zero-One Integer Programming problem.

Enumerates all 2^(L-1) decomposition decisions per direction and evaluates
``f_m`` for each — the O(L * 2^L) search the paper rules out at scale
(Section III-B) but which serves here as the optimality oracle for the DP
(used by the hypothesis property tests and the §Faithful experiments).
"""

from __future__ import annotations

from typing import Tuple

from repro_torch.core.costmodel import (LayerCosts, Segment, backward_time,
                                  backward_segments_from_g, forward_time,
                                  forward_segments_from_p)

_MAX_L = 18


def _check(L: int) -> None:
    if L > _MAX_L:
        raise ValueError(f"brute force limited to L<={_MAX_L}, got {L}")


def bruteforce_forward(costs: LayerCosts) -> Tuple[Tuple[Segment, ...], float]:
    L = costs.num_layers
    _check(L)
    best_t, best_segs = float("inf"), None
    for mask in range(1 << (L - 1)):
        p = tuple((mask >> i) & 1 for i in range(L - 1))
        segs = forward_segments_from_p(p)
        t = forward_time(costs, segs)
        if t < best_t:
            best_t, best_segs = t, segs
    return best_segs, best_t


def bruteforce_backward(costs: LayerCosts) -> Tuple[Tuple[Segment, ...], float]:
    L = costs.num_layers
    _check(L)
    best_t, best_segs = float("inf"), None
    for mask in range(1 << (L - 1)):
        g = tuple((mask >> i) & 1 for i in range(L - 1))
        segs = backward_segments_from_g(g)
        t = backward_time(costs, segs)
        if t < best_t:
            best_t, best_segs = t, segs
    return best_segs, best_t
