"""Memoized, incremental, and asynchronous planning (paper Table I).

The paper argues the DP's cost disappears inside the Δt + gt¹ idle
window while the last gradient push of an iteration is in flight.  The
schedulers historically only *checked* that claim after running the DP
synchronously on the step path; this module makes the hiding real and
attacks the planner's own cost, which at fleet scale (one O(L³) DP per
worker, re-run on every membership change) is a hot path of its own:

* :class:`Planner` — a content-keyed memo cache over
  ``(strategy, LayerCosts)`` → ``Decision``.  Keys hash the exact cost
  *bytes*, so the W identical DPs of a homogeneous fleet collapse to one
  solve plus W−1 dictionary hits, and revisited knots of a
  piecewise-constant ``NetworkSchedule``/``TopologySchedule`` cycle are
  hits across re-plans.  For the DP strategy, a *warm* solve kicks in
  when only the communication side changed against a cached sibling
  (same fc/bc — the ``bandwidth_shift`` / ``uplink_degradation``
  scenarios): the sibling's decision is evaluated under the new costs in
  O(L) and the resulting incumbent bound prunes the Bellman sweep
  (``dp_forward(..., incumbent=)``), while the compute-side prefix sums
  are reused verbatim.  Warm results are *exactly* equal — segments and
  time — to a fresh solve (property-tested).
* :class:`AsyncPlanner` — the off-step-path variant: a deterministic
  two-phase submit/collect protocol.  ``submit`` enqueues the solve for
  a *predicted* future cost point (epoch e+1's costs, computable during
  epoch e whenever the cost source is analytic) on a background thread;
  ``decide`` collects it at the boundary.  Because every solve is a pure
  function of its inputs, the collected decision is bit-identical to a
  synchronous one regardless of thread timing — if the plan is not ready
  (or was never submitted: measured costs, a surprise membership
  change), ``decide`` falls back to solving inline.  Only the *where*
  of the compute moves, never the *what*.

Both schedulers (:class:`~repro_torch.core.scheduler.DynaCommScheduler`,
:class:`~repro_torch.core.scheduler.TopologyScheduler`) accept a ``planner=``
seam; every dynamic trainer threads one through.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import dp
from repro_torch.core.costmodel import (LayerCosts, TopologyCosts, backward_time,
                                  forward_time)
from repro_torch.core.scheduler import Decision, STRATEGIES, schedule

__all__ = ["Planner", "AsyncPlanner", "PlannerStats", "cost_key"]

#: decisions retained by default (LRU); sized well past any smoke/bench
#: schedule's distinct (strategy, costs) points
DEFAULT_CACHE_SIZE = 256


def cost_key(costs: LayerCosts) -> Tuple:
    """Exact content key of a :class:`LayerCosts` (array bytes + Δt
    scalars).  Two cost objects with bit-identical vectors share a key —
    no hashing collisions to reason about, dict equality is byte
    equality."""
    return (costs.pt.tobytes(), costs.fc.tobytes(), costs.bc.tobytes(),
            costs.gt.tobytes(), float(costs.dt),
            None if costs.dt_bwd is None else float(costs.dt_bwd))


def _compute_key(costs: LayerCosts) -> Tuple:
    """Key of the compute side only (fc/bc) — the part that is unchanged
    when just bandwidth/Δt scalars move between epochs."""
    return (costs.fc.tobytes(), costs.bc.tobytes())


def _key_to_json(x):
    """Recursively JSON-encode a cache key: raw cost bytes become hex
    (``{"b": ...}``), nested tuples become ``{"t": [...]}`` — strings,
    floats, and None pass through.  ``json`` float text is the shortest
    round-tripping repr, so keys decode byte-exact."""
    if isinstance(x, bytes):
        return {"b": x.hex()}
    if isinstance(x, tuple):
        return {"t": [_key_to_json(v) for v in x]}
    return x


def _key_from_json(x):
    if isinstance(x, dict):
        if "b" in x:
            return bytes.fromhex(x["b"])
        return tuple(_key_from_json(v) for v in x["t"])
    return x


def _decision_to_json(decision: Decision):
    return [[list(seg) for seg in side] for side in decision]


def _decision_from_json(obj) -> Decision:
    return tuple(tuple(tuple(int(v) for v in seg) for seg in side)
                 for side in obj)


@dataclasses.dataclass
class _WarmEntry:
    """A cached solve reusable as a warm start for same-compute costs."""

    decision: Decision
    fc_pref: np.ndarray           # forward compute prefix sums
    bc_pref: np.ndarray           # reversed backward compute prefix sums


@dataclasses.dataclass
class PlannerStats:
    """Counters for the benches and the CI hit-rate gate."""

    solves: int = 0               # cold full solves
    warm_solves: int = 0          # DP solves warm-started from a sibling
    hits: int = 0                 # exact content-key cache hits
    evictions: int = 0            # LRU evictions from the decision cache
    async_submitted: int = 0      # background jobs enqueued
    async_ready: int = 0          # collected with the result already done
    async_waited: int = 0         # collect had to wait on an in-flight job
    sync_fallbacks: int = 0       # decide() with nothing submitted

    @property
    def lookups(self) -> int:
        return self.hits + self.solves + self.warm_solves

    @property
    def hit_rate(self) -> float:
        """Fraction of decide() lookups served from the memo cache."""
        n = self.lookups
        return self.hits / n if n else 0.0

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hit_rate
        return d


class Planner:
    """Content-keyed memoizing planner (see module docstring).

    Thread-safe: :class:`AsyncPlanner` solves on a background thread into
    the same cache.  ``cache_size`` bounds the decision LRU; the warm
    index keeps at most one sibling per distinct compute profile, LRU-
    bounded by the same size.
    """

    def __init__(self, *, cache_size: int = DEFAULT_CACHE_SIZE):
        if cache_size < 1:
            raise ValueError(f"cache_size must be >= 1, got {cache_size}")
        self.cache_size = cache_size
        self._decisions: "OrderedDict[Tuple, Decision]" = OrderedDict()
        self._warm: "OrderedDict[Tuple, _WarmEntry]" = OrderedDict()
        # whole-topology consensus results: (decision, makespan) keyed by
        # every worker's content key — revisited knots skip the candidate
        # makespan evaluations too, not just the DPs
        self._consensus: "OrderedDict[Tuple, Tuple[Decision, float]]" = \
            OrderedDict()
        self.stats = PlannerStats()
        self._lock = threading.RLock()

    # -- lookup / solve -------------------------------------------------

    @staticmethod
    def _key(costs: LayerCosts, strategy: str) -> Tuple:
        return (strategy,) + cost_key(costs)

    def _lookup(self, key: Tuple) -> Optional[Decision]:
        """Cache probe under the lock; counts a hit when found."""
        decision = self._decisions.get(key)
        if decision is not None:
            self._decisions.move_to_end(key)
            self.stats.hits += 1
        return decision

    def _store(self, key: Tuple, costs: LayerCosts, strategy: str,
               decision: Decision, fc_pref: np.ndarray,
               bc_pref: np.ndarray) -> None:
        self._decisions[key] = decision
        self._decisions.move_to_end(key)
        while len(self._decisions) > self.cache_size:
            self._decisions.popitem(last=False)
            self.stats.evictions += 1
        if strategy == "dynacomm":
            ck = _compute_key(costs)
            self._warm[ck] = _WarmEntry(decision=decision,
                                        fc_pref=fc_pref, bc_pref=bc_pref)
            self._warm.move_to_end(ck)
            while len(self._warm) > self.cache_size:
                self._warm.popitem(last=False)

    def _solve(self, costs: LayerCosts, strategy: str, key: Tuple
               ) -> Decision:
        """Full or warm solve + store.  The DP math runs outside the
        lock (it is pure); only bookkeeping is serialized."""
        with self._lock:
            warm = self._warm.get(_compute_key(costs)) \
                if strategy == "dynacomm" else None
        fc_pref = bc_pref = None
        if warm is not None:
            # Same compute profile, different bandwidth/Δt scalars: the
            # sibling's segmentation is feasible here too, so its O(L)
            # evaluation under the *new* costs bounds the optimum from
            # above and prunes the Bellman sweep; the compute prefix
            # sums carry over verbatim.
            f = dp.dp_forward(costs,
                              incumbent=forward_time(costs,
                                                     warm.decision[0]),
                              fc_pref=warm.fc_pref)
            b = dp.dp_backward(costs,
                               incumbent=backward_time(costs,
                                                       warm.decision[1]),
                               bc_pref=warm.bc_pref)
            decision: Decision = (f.segments, b.segments)
            fc_pref, bc_pref = warm.fc_pref, warm.bc_pref
        else:
            decision = schedule(costs, strategy)
        if fc_pref is None:
            fc_pref = np.concatenate([[0.0], np.cumsum(costs.fc)])
            bc_pref = np.concatenate([[0.0], np.cumsum(costs.bc[::-1])])
        with self._lock:
            if warm is not None:
                self.stats.warm_solves += 1
            else:
                self.stats.solves += 1
            self._store(key, costs, strategy, decision, fc_pref, bc_pref)
        return decision

    # -- the planning API -----------------------------------------------

    def decide(self, costs: LayerCosts, strategy: str) -> Decision:
        """The (memoized) decision for one worker's costs — exactly what
        ``schedule(costs, strategy)`` returns, cached by content."""
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; "
                             f"choose from {sorted(STRATEGIES)}")
        key = self._key(costs, strategy)
        with self._lock:
            hit = self._lookup(key)
        if hit is not None:
            return hit
        return self._solve(costs, strategy, key)

    def decide_topology(self, topo: TopologyCosts, strategy: str
                        ) -> Tuple[Decision, ...]:
        """Per-worker decisions — ``schedule_topology`` through the memo
        cache, so a homogeneous fleet costs one DP, not W."""
        return tuple(self.decide(c, strategy) for c in topo.workers)

    def consensus(self, topo: TopologyCosts, strategy: str
                  ) -> Tuple[Decision, float]:
        """``consensus_decision`` through the memo cache: candidates are
        the per-worker decisions (deduped, first occurrence order), the
        winner minimizes the synchronous makespan — identical tie-breaks
        to the uncached path.  The whole-topology result is itself
        cached, so a revisited knot costs one dictionary probe instead
        of W DPs plus the candidate makespan sweep."""
        tkey = (strategy,) + tuple(cost_key(c) for c in topo.workers)
        with self._lock:
            cached = self._consensus.get(tkey)
            if cached is not None:
                self._consensus.move_to_end(tkey)
                self.stats.hits += 1
                return cached
        candidates = list(dict.fromkeys(self.decide_topology(topo,
                                                             strategy)))
        best = min(candidates, key=lambda d: topo.makespan(*d))
        result = (best, topo.makespan(*best))
        with self._lock:
            self._consensus[tkey] = result
            self._consensus.move_to_end(tkey)
            while len(self._consensus) > self.cache_size:
                self._consensus.popitem(last=False)
        return result

    def clear(self) -> None:
        """Drop all cached decisions and warm entries (counters stay)."""
        with self._lock:
            self._decisions.clear()
            self._warm.clear()
            self._consensus.clear()

    def __len__(self) -> int:
        return len(self._decisions)

    # -- persistence ----------------------------------------------------

    def state_dict(self) -> Dict:
        """JSON-serializable snapshot of every cache (not the counters).

        Content keys hold raw cost bytes; they travel as hex so the
        snapshot survives ``json.dumps`` inside the loop-state metadata.
        A restored planner serves the same hits a warm one would — a
        resumed run's first re-plan at an already-seen cost point is a
        cache hit, not a fresh solve (tested)."""
        with self._lock:
            return {
                "cache_size": self.cache_size,
                "decisions": [[_key_to_json(k), _decision_to_json(d)]
                              for k, d in self._decisions.items()],
                "warm": [[_key_to_json(k),
                          {"decision": _decision_to_json(w.decision),
                           "fc_pref": [float(v) for v in w.fc_pref],
                           "bc_pref": [float(v) for v in w.bc_pref]}]
                         for k, w in self._warm.items()],
                "consensus": [[_key_to_json(k),
                               [_decision_to_json(d), float(mk)]]
                              for k, (d, mk) in self._consensus.items()],
            }

    def load_state_dict(self, state: Dict) -> None:
        """Restore the caches from :meth:`state_dict` (insertion order —
        and thus LRU order — preserved; counters start fresh)."""
        with self._lock:
            self._decisions.clear()
            self._warm.clear()
            self._consensus.clear()
            for k, d in state.get("decisions", ()):
                self._decisions[_key_from_json(k)] = _decision_from_json(d)
            for k, w in state.get("warm", ()):
                self._warm[_key_from_json(k)] = _WarmEntry(
                    decision=_decision_from_json(w["decision"]),
                    fc_pref=np.asarray(w["fc_pref"], np.float64),
                    bc_pref=np.asarray(w["bc_pref"], np.float64))
            for k, pair in state.get("consensus", ()):
                d, mk = pair
                self._consensus[_key_from_json(k)] = \
                    (_decision_from_json(d), float(mk))


class AsyncPlanner(Planner):
    """Two-phase submit/collect planner (see module docstring).

    Phase one (``submit``/``submit_topology``) runs during epoch e: the
    trainer predicts epoch e+1's cost point and enqueues its solve on the
    background thread — the wall-clock window the paper's Table I says
    is idle.  Phase two (``decide``, called by the scheduler at the
    boundary) collects: a finished job is a dictionary hit
    (``async_ready``), an in-flight one is joined (``async_waited`` —
    still off the critical path for everything already computed), and a
    never-submitted point solves inline (``sync_fallbacks``).  Decisions
    are pure functions of their inputs, so all three paths return
    bit-identical results.
    """

    def __init__(self, *, cache_size: int = DEFAULT_CACHE_SIZE):
        super().__init__(cache_size=cache_size)
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="repro-planner")
        self._pending: Dict[Tuple, "Future[Decision]"] = {}

    def submit(self, costs: LayerCosts, strategy: str) -> bool:
        """Phase one: enqueue the solve for a predicted cost point.
        Returns whether a new background job was created (False when the
        point is already cached or in flight)."""
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; "
                             f"choose from {sorted(STRATEGIES)}")
        key = self._key(costs, strategy)
        with self._lock:
            # finished speculative jobs live on in the decision cache
            self._pending = {k: f for k, f in self._pending.items()
                             if not f.done()}
            if key in self._decisions or key in self._pending:
                return False
            future = self._executor.submit(self._solve, costs, strategy,
                                           key)
            self._pending[key] = future
            self.stats.async_submitted += 1
            return True

    def submit_topology(self, topo: TopologyCosts, strategy: str) -> int:
        """Phase one over a whole topology; returns jobs enqueued."""
        return sum(int(self.submit(c, strategy)) for c in topo.workers)

    def decide(self, costs: LayerCosts, strategy: str) -> Decision:
        """Phase two: collect (waiting if the job is still in flight) or
        fall back to an inline solve."""
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; "
                             f"choose from {sorted(STRATEGIES)}")
        key = self._key(costs, strategy)
        with self._lock:
            hit = self._lookup(key)
            future = None if hit is not None else self._pending.pop(key,
                                                                    None)
        if hit is not None:
            return hit
        if future is not None:
            if future.done():
                self.stats.async_ready += 1
            else:
                self.stats.async_waited += 1
            return future.result()
        self.stats.sync_fallbacks += 1
        return self._solve(costs, strategy, key)

    def drain(self) -> None:
        """Block until every submitted job has landed in the cache
        (tests; not needed by the trainers)."""
        with self._lock:
            pending = list(self._pending.values())
        for future in pending:
            future.result()

    def close(self) -> None:
        """Shut the background thread down (idempotent)."""
        self._executor.shutdown(wait=True)
