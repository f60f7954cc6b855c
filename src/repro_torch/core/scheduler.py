"""The DynaComm scheduler (paper Section IV) and the strategy registry.

``DynaCommScheduler`` wires profiling → DP → decision, with the overhead
minimizations of Section IV-C: decisions are recomputed once per epoch by
default (``reschedule_every`` iterations), and the forward scheduler for
iteration i+1 can run in the idle window after the last backward compute
(modelled by ``scheduling_overhead_hidden``).

``STRATEGIES`` exposes every competing method under a uniform interface so
benchmarks and the distributed trainer can switch with a string:
``sequential | lbl | ibatch | dynacomm | bruteforce``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core import baselines, bruteforce, dp, greedy
from repro_torch.core.costmodel import (LayerCosts, Segment, TopologyCosts,
                                  backward_time, forward_time, iteration_time)

Decision = Tuple[Tuple[Segment, ...], Tuple[Segment, ...]]  # (forward, backward)


def _default_clock() -> float:
    """Wall clock used to *measure* scheduling overhead (Table I).  Both
    schedulers take it as an injectable ``clock=`` field so deterministic
    tests and resumed-vs-fresh runs can pin event timings.  Genuinely
    measuring here, hence the lint exemption.
    """
    return time.perf_counter()  # noqa: DET-WALL-CLOCK


def _seq(costs: LayerCosts) -> Decision:
    L = costs.num_layers
    return baselines.sequential_forward(L), baselines.sequential_backward(L)


def _lbl(costs: LayerCosts) -> Decision:
    L = costs.num_layers
    return baselines.lbl_forward(L), baselines.lbl_backward(L)


def _ibatch(costs: LayerCosts) -> Decision:
    (f, b), _ = greedy.ibatch_schedule(costs)
    return f, b


def _dynacomm(costs: LayerCosts) -> Decision:
    (f, b), _ = dp.dynacomm_schedule(costs)
    return f, b


def _bruteforce(costs: LayerCosts) -> Decision:
    f, _ = bruteforce.bruteforce_forward(costs)
    b, _ = bruteforce.bruteforce_backward(costs)
    return f, b


STRATEGIES: Dict[str, Callable[[LayerCosts], Decision]] = {
    "sequential": _seq,
    "lbl": _lbl,
    "ibatch": _ibatch,
    "dynacomm": _dynacomm,
    "bruteforce": _bruteforce,
}


def schedule(costs: LayerCosts, strategy: str) -> Decision:
    try:
        return STRATEGIES[strategy](costs)
    except KeyError:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"choose from {sorted(STRATEGIES)}") from None


def schedule_topology(topo: TopologyCosts, strategy: str
                      ) -> Tuple[Decision, ...]:
    """One independent decision per worker of a PS topology.

    This is the *asynchronous* planning mode: each edge worker overlaps its
    own link with its own compute, so the optimal decomposition differs per
    worker (a slow uplink wants few large pushes; a fast one wants
    layer-wise overlap)."""
    return tuple(schedule(c, strategy) for c in topo.workers)


def consensus_decision(topo: TopologyCosts, strategy: str
                       ) -> Tuple[Decision, float]:
    """One shared decision for synchronous-mode PS training.

    A bulk-synchronous step compiles a single program, so every worker must
    run the same segmentation; the iteration ends when the straggler
    finishes.  Each worker's individually-optimal decision is a candidate;
    the one minimizing the *synchronous makespan* (max over workers) wins.
    Returns ``(decision, makespan_seconds)``."""
    candidates = list(dict.fromkeys(schedule_topology(topo, strategy)))
    best = min(candidates, key=lambda d: topo.makespan(*d))
    return best, topo.makespan(*best)


def evaluate(costs: LayerCosts, decision: Decision) -> Dict[str, float]:
    f, b = decision
    return {
        "forward": forward_time(costs, f),
        "backward": backward_time(costs, b),
        "total": iteration_time(costs, f, b),
    }


@dataclasses.dataclass
class DynaCommScheduler:
    """Run-time scheduler with per-epoch decision caching (Section IV-C).

    ``planner=`` plugs a :class:`repro_torch.core.planner.Planner` (or
    :class:`~repro_torch.core.planner.AsyncPlanner`) in front of the strategy
    call — re-plans then go through the content-keyed memo cache (and,
    async, collect decisions pre-computed in the gt¹ idle window) while
    returning bit-identical decisions.  ``clock=`` injects the overhead
    stopwatch so tests and resumed runs can pin event timings.
    """

    strategy: str = "dynacomm"
    reschedule_every: int = 195       # paper: once per epoch (CIFAR-10, bs 256)
    planner: Optional[Any] = None     # duck-typed: .decide(costs, strategy)
    clock: Callable[[], float] = _default_clock

    _decision: Decision | None = None
    _iter_seen: int = 0
    last_scheduling_seconds: float = 0.0

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; "
                             f"choose from {sorted(STRATEGIES)}")
        if self.reschedule_every < 1:
            raise ValueError(f"reschedule_every must be >= 1, got "
                             f"{self.reschedule_every}")

    def decision_for_iteration(self, costs: LayerCosts) -> Decision:
        """Return the active decision, re-scheduling on the epoch boundary."""
        if self._decision is None or self._iter_seen % self.reschedule_every == 0:
            t0 = self.clock()
            if self.planner is not None:
                self._decision = self.planner.decide(costs, self.strategy)
            else:
                self._decision = schedule(costs, self.strategy)
            self.last_scheduling_seconds = self.clock() - t0
        self._iter_seen += 1
        return self._decision

    def scheduling_overhead_hidden(self, costs: LayerCosts) -> bool:
        """Idle-event-trigger check (Section IV-C / Table I): the forward
        scheduler for iteration i+1 fits in the window
        (Δt + gt_i^1) while the last gradient push is in flight."""
        return self.last_scheduling_seconds <= costs.idle_window

    def invalidate(self) -> None:
        """Drop the cached decision so the next iteration re-schedules
        (drift detected mid-epoch) without disturbing the iteration
        counter's epoch alignment."""
        self._decision = None

    def state_dict(self) -> Dict[str, object]:
        """Checkpointable loop state (decision in segment form)."""
        return {"strategy": self.strategy,
                "iter_seen": self._iter_seen,
                "decision": self._decision,
                "last_scheduling_seconds": self.last_scheduling_seconds}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        saved = state.get("strategy", self.strategy)  # legacy: no strategy
        if saved != self.strategy:
            raise ValueError(
                f"checkpoint was written by a {saved!r}-strategy scheduler; "
                f"this scheduler runs {self.strategy!r}")
        self._iter_seen = int(state["iter_seen"])
        d = state["decision"]
        self._decision = None if d is None else (
            tuple(tuple(s) for s in d[0]), tuple(tuple(s) for s in d[1]))
        self.last_scheduling_seconds = float(
            state.get("last_scheduling_seconds", 0.0))

    def reset(self) -> None:
        self._decision = None
        self._iter_seen = 0
        self.last_scheduling_seconds = 0.0


@dataclasses.dataclass
class TopologyScheduler:
    """Per-topology-epoch scheduler for the parameter-server regime.

    The PS analogue of :class:`DynaCommScheduler`: decisions are derived
    from a whole :class:`TopologyCosts` — one consensus decision shared by
    every worker (``mode="consensus"``, synchronous execution) or one
    independent decision per worker (``mode="per-worker"``, asynchronous
    execution) — and cached until ``invalidate()`` or the next epoch
    boundary (``reschedule_every`` iterations).

    ``decision_for_iteration`` returns a ``Decision`` in consensus mode
    and a tuple of per-worker ``Decision``s in per-worker mode.

    ``planner=``/``clock=`` as on :class:`DynaCommScheduler`.  The
    planner seam is where the homogeneous-fleet collapse happens: W
    workers with identical costs become one DP solve plus W−1 cache
    hits instead of W independent O(L³) sweeps.
    """

    strategy: str = "dynacomm"
    reschedule_every: int = 195
    mode: str = "consensus"           # "consensus" | "per-worker"
    planner: Optional[Any] = None     # duck-typed planner seam
    clock: Callable[[], float] = _default_clock

    _decision: object = None
    _iter_seen: int = 0
    last_scheduling_seconds: float = 0.0
    last_makespan: float = 0.0        # consensus mode: straggler seconds

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; "
                             f"choose from {sorted(STRATEGIES)}")
        if self.reschedule_every < 1:
            raise ValueError(f"reschedule_every must be >= 1, got "
                             f"{self.reschedule_every}")
        if self.mode not in ("consensus", "per-worker"):
            raise ValueError(f"mode must be 'consensus' or 'per-worker', "
                             f"got {self.mode!r}")

    def decision_for_iteration(self, topo: TopologyCosts):
        """The active decision(s), re-scheduling on the epoch boundary."""
        if self._decision is None or \
                self._iter_seen % self.reschedule_every == 0:
            t0 = self.clock()
            if self.mode == "consensus":
                if self.planner is not None:
                    self._decision, self.last_makespan = \
                        self.planner.consensus(topo, self.strategy)
                else:
                    self._decision, self.last_makespan = \
                        consensus_decision(topo, self.strategy)
            elif self.planner is not None:
                self._decision = self.planner.decide_topology(
                    topo, self.strategy)
            else:
                self._decision = schedule_topology(topo, self.strategy)
            self.last_scheduling_seconds = self.clock() - t0
        self._iter_seen += 1
        return self._decision

    def scheduling_overhead_hidden(self, topo: TopologyCosts) -> bool:
        """Table I check against the *topology's* gt¹ idle window: the
        re-plan (run once, driver-side) must fit in every worker's
        Δt + gt¹ window, so the minimum over workers binds."""
        return self.last_scheduling_seconds <= topo.idle_window

    def invalidate(self) -> None:
        """Drop the cached decision without disturbing epoch alignment."""
        self._decision = None

    def _tuplize(self, d):
        """Rebuild tuple-typed decisions from JSON-roundtripped lists."""
        def one(dec):
            return (tuple(tuple(s) for s in dec[0]),
                    tuple(tuple(s) for s in dec[1]))
        return one(d) if self.mode == "consensus" \
            else tuple(one(w) for w in d)

    def state_dict(self) -> Dict[str, object]:
        """Checkpointable loop state (decision in segment form).

        ``mode`` and ``strategy`` are persisted so a restore into a
        differently-configured scheduler fails loudly: ``_tuplize``
        branches on ``self.mode``, so feeding a per-worker checkpoint to
        a consensus scheduler would otherwise silently rebuild garbage
        nested tuples."""
        return {"mode": self.mode,
                "strategy": self.strategy,
                "iter_seen": self._iter_seen,
                "decision": self._decision,
                "last_scheduling_seconds": self.last_scheduling_seconds,
                "last_makespan": self.last_makespan}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        saved_mode = state.get("mode", self.mode)     # legacy: no mode
        if saved_mode != self.mode:
            raise ValueError(
                f"checkpoint was written by a {saved_mode!r}-mode scheduler; "
                f"this scheduler runs mode {self.mode!r}")
        saved = state.get("strategy", self.strategy)  # legacy: no strategy
        if saved != self.strategy:
            raise ValueError(
                f"checkpoint was written by a {saved!r}-strategy scheduler; "
                f"this scheduler runs {self.strategy!r}")
        self._iter_seen = int(state["iter_seen"])
        d = state["decision"]
        self._decision = None if d is None else self._tuplize(d)
        self.last_scheduling_seconds = float(
            state.get("last_scheduling_seconds", 0.0))
        self.last_makespan = float(state.get("last_makespan", 0.0))

    def reset(self) -> None:
        self._decision = None
        self._iter_seen = 0
        self.last_scheduling_seconds = 0.0
        self.last_makespan = 0.0
