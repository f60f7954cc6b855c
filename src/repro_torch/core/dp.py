"""DynaComm's DP-based scheduling algorithms (paper Algorithms 3 and 4).

Forward Bellman equation (paper eq. 13)::

    F[m][n] = min_{0<=k<m} { max(F[k][n-1], n*Δt + Σ_{1<=l<=m} pt_l)
                             + Σ_{k+1<=l<=m} fc_l }          1<=n<=m<=L

``F[m][n]`` is the earliest completion time of the first ``m`` layers'
forward compute given ``n`` transmission mini-procedures cover their
parameters.  The n-th transmission ends at ``n*Δt + Σ pt_{1..m}`` because
transmissions are serialized back-to-back on the link.

Backward Bellman equation (paper eq. 14)::

    B[m][n] = min_{0<=k<m} { max(B[k][n-1], Σ_{L-m+1<=l<=L} bc_l)
                             + Δt + Σ_{L-m+1<=l<=L-k} gt_l }  1<=n<=m<=L

``B[m][n]`` is the earliest completion time of the *gradient transmissions*
of the last ``m`` layers using ``n`` mini-procedures; backward compute runs
stall-free from layer L downwards.

Both run in O(L^3) time / O(L^2) space (paper Section IV-B4).  The inner
minimization is vectorized with numpy so the Fig. 12 complexity benchmark is
tractable at hundreds of layers.

Warm re-planning (``repro_torch.core.planner``): both DPs accept an
``incumbent=`` upper bound — typically a previously-optimal decision's
O(L) evaluation under the *new* costs — and prune the column sweep via a
monotone per-column lower bound.  Pruned solves return *exactly* the
same segments/time/num_transmissions as a full solve: the prune carries
a small relative slack (``_PRUNE_SLACK``) because the incumbent's O(L)
summation order differs from the DP's prefix-sum arithmetic by a few
ULP, and slack only ever *adds* columns to the sweep — smallest-``n``
argmin tie-breaks are preserved.  Only the untouched table columns stay
at ``inf``.  ``fc_pref=``/``bc_pref=`` let a caller reuse compute-side
prefix sums when only bandwidth/Δt scalars changed between plans.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.costmodel import (LayerCosts, Segment, backward_time,
                                  forward_time)

_INF = np.inf

#: relative slack on the incumbent prune: a feasible plan's O(L)
#: evaluation can undershoot the DP's prefix-sum value of the *same*
#: plan by a few ULP (different summation order), so a strict bound
#: could prune the optimal column.  Slack never removes columns a full
#: sweep would keep — it only computes extra ones — so pruned results
#: stay exactly equal to full solves.
_PRUNE_SLACK = 1e-9


@dataclasses.dataclass(frozen=True)
class DPResult:
    segments: Tuple[Segment, ...]
    time: float                  # optimal phase time (== f_m of segments)
    table: np.ndarray            # F or B, shape (L+1, L+1)
    num_transmissions: int


def _traceback(path: np.ndarray, L: int, n_star: int) -> Tuple[int, ...]:
    """Recover the k-chain 0 = k_0 < k_1 < ... < k_{n*} = L from Path."""
    bounds = [L]
    m, n = L, n_star
    while n > 0:
        k = int(path[m, n])
        if k < 0:
            raise RuntimeError("broken DP path")
        bounds.append(k)
        m, n = k, n - 1
    if bounds[-1] != 0:
        raise RuntimeError("DP path did not terminate at 0")
    return tuple(reversed(bounds))


def dp_forward(costs: LayerCosts, *, incumbent: Optional[float] = None,
               fc_pref: Optional[np.ndarray] = None) -> DPResult:
    """Algorithm 3 — optimal parameter-transmission segmentation.

    ``incumbent`` is an upper bound on the optimum (any feasible
    segmentation's ``forward_time``); columns whose lower bound strictly
    exceeds the best value seen are skipped.  ``fc_pref`` reuses a
    precomputed compute prefix-sum vector (length L+1, leading 0)."""
    L = costs.num_layers
    pt_pref = np.concatenate([[0.0], np.cumsum(costs.pt)])   # Σ pt_{1..m}
    if fc_pref is None:
        fc_pref = np.concatenate([[0.0], np.cumsum(costs.fc)])  # Σ fc_{1..m}

    F = np.full((L + 1, L + 1), _INF)
    path = np.full((L + 1, L + 1), -1, dtype=np.int64)
    F[0, 0] = 0.0

    # best value of F[L, ·] seen so far; the incumbent seeds the pruning
    best = _INF if incumbent is None else float(incumbent)
    ms = np.arange(L + 1)
    for n in range(1, L + 1):
        # Every n-column value at m = L pays all n serialized
        # transmissions plus at least the last layer's compute after the
        # last one: lb is monotone increasing in n, so once it clears
        # the best finished value (plus FP slack) no later column can
        # win, and the smallest-n argmin tie-break stays identical to a
        # full sweep.
        lb = n * costs.dt + pt_pref[L] + float(costs.fc[-1])
        if lb > best + _PRUNE_SLACK * max(1.0, abs(best)):
            break
        prev = F[:, n - 1]                       # F[k][n-1], k = 0..L
        # arrive[m]: when the n-th transmission (ending at layer m) completes
        arrive = n * costs.dt + pt_pref
        # cand[m, k] = max(prev[k], arrive[m]) + (fc_pref[m] - fc_pref[k])
        cand = np.maximum(prev[None, :], arrive[:, None]) \
            + fc_pref[:, None] - fc_pref[None, :]
        cand[ms[:, None] <= ms[None, :]] = _INF  # require k < m
        ks = np.argmin(cand, axis=1)
        vals = cand[ms, ks]
        valid = ms >= n
        F[valid, n] = vals[valid]
        path[valid, n] = ks[valid]
        best = min(best, float(F[L, n]))

    n_star = int(np.argmin(F[L, 1:]) + 1)
    t_star = float(F[L, n_star])
    bounds = _traceback(path, L, n_star)
    segments = tuple((bounds[i] + 1, bounds[i + 1]) for i in range(len(bounds) - 1))
    # Sanity: the DP objective must equal the O(L) cost function.
    assert abs(forward_time(costs, segments) - t_star) <= 1e-9 * max(1.0, t_star)
    return DPResult(segments=segments, time=t_star, table=F,
                    num_transmissions=n_star)


def dp_backward(costs: LayerCosts, *, incumbent: Optional[float] = None,
                bc_pref: Optional[np.ndarray] = None) -> DPResult:
    """Algorithm 4 — optimal gradient-transmission segmentation.

    ``incumbent``/``bc_pref`` as in :func:`dp_forward` (``bc_pref`` is
    the prefix sum of the *reversed* backward compute costs)."""
    L = costs.num_layers
    # Reversed views: position j (1-indexed) = original layer L+1-j.
    bc_rev = costs.bc[::-1]
    gt_rev = costs.gt[::-1]
    if bc_pref is None:
        bc_pref = np.concatenate([[0.0], np.cumsum(bc_rev)])  # Σ bc last-m
    gt_pref = np.concatenate([[0.0], np.cumsum(gt_rev)])     # Σ gt last-m layers

    B = np.full((L + 1, L + 1), _INF)
    path = np.full((L + 1, L + 1), -1, dtype=np.int64)
    B[0, 0] = 0.0

    best = _INF if incumbent is None else float(incumbent)
    ms = np.arange(L + 1)
    for n in range(1, L + 1):
        # By induction B[m][n] >= n*Δt + Σ gt_{1..m} (each of the n
        # pushes pays its own Δt and the gt ranges tile [1, m]), so
        # B[L][n] >= n*Δt + gt_pref[L] — monotone in n.  Same FP slack
        # as the forward sweep.
        lb = n * costs.dt_push + gt_pref[L]
        if lb > best + _PRUNE_SLACK * max(1.0, abs(best)):
            break
        prev = B[:, n - 1]
        ready = bc_pref                              # compute-done time per m
        # cand[m, k] = max(prev[k], ready[m]) + Δt + (gt_pref[m] - gt_pref[k])
        cand = np.maximum(prev[None, :], ready[:, None]) + costs.dt_push \
            + gt_pref[:, None] - gt_pref[None, :]
        cand[ms[:, None] <= ms[None, :]] = _INF
        ks = np.argmin(cand, axis=1)
        vals = cand[ms, ks]
        valid = ms >= n
        B[valid, n] = vals[valid]
        path[valid, n] = ks[valid]
        best = min(best, float(B[L, n]))

    n_star = int(np.argmin(B[L, 1:]) + 1)
    t_star = float(B[L, n_star])
    bounds = _traceback(path, L, n_star)
    # bounds are in reversed coordinates: reversed position j covers original
    # layer L+1-j; chain segment (k, m] reversed = original layers
    # [L-m+1 .. L-k], transmitted top-down.
    segments = tuple((L - bounds[i + 1] + 1, L - bounds[i])
                     for i in range(len(bounds) - 1))
    assert abs(backward_time(costs, segments) - t_star) <= 1e-9 * max(1.0, t_star)
    return DPResult(segments=segments, time=t_star, table=B,
                    num_transmissions=n_star)


def dynacomm_schedule(costs: LayerCosts):
    """Both directions; returns ((fwd_segments, bwd_segments), total_time)."""
    f = dp_forward(costs)
    b = dp_backward(costs)
    return (f.segments, b.segments), f.time + b.time


@dataclasses.dataclass(frozen=True)
class PartitionResult:
    """Optimal contiguous min-max partition (pipeline stage split)."""

    segments: Tuple[Segment, ...]   # 1-indexed inclusive, tiles 1..L
    bottleneck: float               # max per-segment load (the objective)
    table: np.ndarray               # P, shape (L+1, S+1)


def dp_partition(loads, num_parts: int) -> PartitionResult:
    """Split ``loads`` into ``num_parts`` contiguous pieces minimizing the
    maximum piece sum (the pipeline *bottleneck stage*).

    The Bellman recurrence mirrors the transmission DPs above, with
    ``max`` replacing the comm/compute coupling::

        P[m][s] = min_{s-1<=k<m} max(P[k][s-1], Σ_{k+1<=l<=m} load_l)

    O(S·L²) time via the same vectorized candidate matrix; ties break to
    the smallest split point ``k`` (``np.argmin`` keeps the first
    minimum), so results are deterministic.  Every piece is non-empty:
    ``1 <= num_parts <= len(loads)`` is required.
    """
    loads = np.asarray(loads, dtype=np.float64)
    if loads.ndim != 1 or loads.size == 0:
        raise ValueError("loads must be a non-empty 1-D array")
    if np.any(loads < 0):
        raise ValueError("loads must be non-negative")
    L = int(loads.size)
    S = int(num_parts)
    if not 1 <= S <= L:
        raise ValueError(f"num_parts must be in [1, {L}], got {num_parts}")

    pref = np.concatenate([[0.0], np.cumsum(loads)])
    P = np.full((L + 1, S + 1), _INF)
    path = np.full((L + 1, S + 1), -1, dtype=np.int64)
    P[0, 0] = 0.0

    ms = np.arange(L + 1)
    for s in range(1, S + 1):
        prev = P[:, s - 1]                       # P[k][s-1], k = 0..L
        # cand[m, k] = max(prev[k], pref[m] - pref[k])
        cand = np.maximum(prev[None, :], pref[:, None] - pref[None, :])
        cand[ms[:, None] <= ms[None, :]] = _INF  # require k < m
        ks = np.argmin(cand, axis=1)
        vals = cand[ms, ks]
        valid = ms >= s
        P[valid, s] = vals[valid]
        path[valid, s] = ks[valid]

    t_star = float(P[L, S])
    bounds = _traceback(path, L, S)
    segments = tuple((bounds[i] + 1, bounds[i + 1])
                     for i in range(len(bounds) - 1))
    sums = tuple(float(pref[hi] - pref[lo - 1]) for lo, hi in segments)
    assert abs(max(sums) - t_star) <= 1e-9 * max(1.0, t_star)
    return PartitionResult(segments=segments, bottleneck=t_star, table=P)
