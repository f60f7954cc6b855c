"""iBatch / iPart greedy scheduling (paper Algorithms 1 and 2).

The competing method the paper benchmarks against.  Implemented literally as
printed in the DynaComm paper, including its known deficiencies (the greedy
choice property does not hold, so it lands in local optima — reproducing
Fig. 5(c) where iBatch loses to plain layer-by-layer).

Where the pseudo-code is silent we resolve as follows (documented so the
§Faithful experiments are auditable):

* Alg. 1 forward — if no boundary satisfies the overlap condition, the
  remainder of the network is batched into one final segment (j = L).
  The companion algorithm that "does the opposite" (scans from the last
  layer to the first, only sketched in [16]) is implemented as the mirror
  of Alg. 1 on reversed cost vectors; iBatch returns whichever of the two
  candidates has the lower estimated time, as the paper states.
* Alg. 2 backward — if no x in [1, m-1] satisfies the condition, the x with
  maximal (least-negative) slack is chosen, i.e. the smallest next segment.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core.costmodel import (LayerCosts, Segment, backward_time,
                                  forward_time)


def _fwd_candidate_literal(pt: np.ndarray, fc: np.ndarray, dt: float,
                           L: int) -> Tuple[Segment, ...]:
    """Algorithm 1, as printed (boundary list D_f, D_f[0] = 0)."""
    if L == 1:
        return ((1, 1),)
    pt_pref = np.concatenate([[0.0], np.cumsum(pt)])
    fc_pref = np.concatenate([[0.0], np.cumsum(fc)])

    def pt_sum(lo, hi):  # Σ pt_{lo..hi}, 1-indexed inclusive
        return pt_pref[hi] - pt_pref[lo - 1]

    def fc_sum(lo, hi):
        return fc_pref[hi] - fc_pref[lo - 1]

    # Lines 1-5: pick the first two boundaries (D_f[1], D_f[2]).
    s2 = [(d1, d2) for d1 in range(1, L) for d2 in range(d1 + 1, L + 1)
          if dt + pt_sum(d1 + 1, d2) >= fc_sum(1, d1)]
    if not s2:
        return ((1, L),)  # degenerate: fall back to a single batch
    max_fc = max(fc_sum(1, d1) for d1, _ in s2)
    s3 = [pair for pair in s2 if fc_sum(1, pair[0]) == max_fc]
    d1, d2 = min(s3, key=lambda pair: dt + pt_sum(1, pair[0]))

    bounds = [0, d1, d2]
    n, m = d1, d2
    # Lines 6-17 (greedy extension).  NB: the listing never re-assigns n,
    # so the compute side is the *cumulative* fc since D_f[1] — kept literal.
    while m != L:
        options = [x for x in range(m + 1, L + 1)
                   if dt + pt_sum(m + 1, x) >= fc_sum(n + 1, m)]
        if options:
            j = min(options,
                    key=lambda x: dt + pt_sum(m + 1, x) - fc_sum(n + 1, m))
        else:
            j = L
        m = j
        bounds.append(m)
    return tuple((bounds[i] + 1, bounds[i + 1]) for i in range(len(bounds) - 1))


def ibatch_forward(costs: LayerCosts) -> Tuple[Tuple[Segment, ...], float]:
    """Best of the two greedy forward candidates (paper Section III-C)."""
    L = costs.num_layers
    cand_a = _fwd_candidate_literal(costs.pt, costs.fc, costs.dt, L)
    # Mirror candidate: run the same greedy from the last layer to the first.
    mirrored = _fwd_candidate_literal(costs.pt[::-1], costs.fc[::-1],
                                      costs.dt, L)
    cand_b = tuple(sorted(((L - hi + 1, L - lo + 1) for lo, hi in mirrored)))
    best = min((cand_a, cand_b), key=lambda s: forward_time(costs, s))
    return best, forward_time(costs, best)


def ibatch_backward(costs: LayerCosts) -> Tuple[Tuple[Segment, ...], float]:
    """Algorithm 2 (iPart's greedy gradient scheduling), as printed."""
    L = costs.num_layers
    if L == 1:
        segs = ((1, 1),)
        return segs, backward_time(costs, segs)

    bc_pref = np.concatenate([[0.0], np.cumsum(costs.bc)])
    gt_pref = np.concatenate([[0.0], np.cumsum(costs.gt)])

    def bc_sum(lo, hi):
        return bc_pref[hi] - bc_pref[lo - 1] if hi >= lo else 0.0

    def gt_sum(lo, hi):
        return gt_pref[hi] - gt_pref[lo - 1] if hi >= lo else 0.0

    candidates: List[Tuple[Segment, ...]] = []
    for n in range(2, L + 1):
        bounds = [L + 1, n]   # first segment = layers L..n
        k, m = 1, n
        while m != 1:
            slack = {x: k * costs.dt_push + gt_sum(m, L) - bc_sum(x, m - 1)
                     for x in range(1, m)}
            options = [x for x, s in slack.items() if s >= 0]
            j = (min(options, key=lambda x: slack[x]) if options
                 else max(slack, key=lambda x: slack[x]))
            bounds.append(j)
            m = j
            k += 1
        segs = tuple((bounds[i + 1], bounds[i] - 1 if i else L)
                     for i in range(len(bounds) - 1))
        candidates.append(segs)

    best = min(candidates, key=lambda s: backward_time(costs, s))
    return best, backward_time(costs, best)


def ibatch_schedule(costs: LayerCosts):
    f_segs, f_t = ibatch_forward(costs)
    b_segs, b_t = ibatch_backward(costs)
    return (f_segs, b_segs), f_t + b_t
