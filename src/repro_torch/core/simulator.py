"""Discrete-event execution simulator for a scheduled iteration.

Builds the explicit per-mini-procedure timeline implied by a decomposition
decision, enforcing the paper's partial-order constraints (eqs. 1-7), and
derives the stacked-bar decomposition of Figs. 5-8 (non-overlapping
computation / overlapping / non-overlapping communication).

The simulator is deliberately independent of the closed-form ``f_m`` in
``costmodel`` — tests assert both agree, which is the machine-checked version
of the paper's claim that ``f_m`` measures the schedule correctly.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.costmodel import (LayerCosts, PhaseBreakdown, Segment,
                                  TopologyCosts, phase_breakdown,
                                  validate_backward_segments,
                                  validate_forward_segments)


@dataclasses.dataclass(frozen=True)
class Event:
    kind: str            # 'pt' | 'fc' | 'bc' | 'gt'
    layers: Segment      # (lo, hi) covered
    start: float
    end: float


@dataclasses.dataclass(frozen=True)
class IterationTimeline:
    forward_events: Tuple[Event, ...]
    backward_events: Tuple[Event, ...]
    forward_time: float
    backward_time: float

    @property
    def total(self) -> float:
        return self.forward_time + self.backward_time

    def breakdown(self, phase: str) -> PhaseBreakdown:
        events = self.forward_events if phase == "forward" else self.backward_events
        comm = [(e.start, e.end) for e in events if e.kind in ("pt", "gt")]
        comp = [(e.start, e.end) for e in events if e.kind in ("fc", "bc")]
        return phase_breakdown(comm, comp)


def simulate_forward(costs: LayerCosts,
                     segments: Sequence[Segment]) -> Tuple[List[Event], float]:
    validate_forward_segments(segments, costs.num_layers)
    events: List[Event] = []
    link_free = 0.0
    comp_free = 0.0
    for lo, hi in segments:
        # transmission mini-procedure (includes its Δt setup)
        dur = costs.dt + float(np.sum(costs.pt[lo - 1:hi]))
        t0, t1 = link_free, link_free + dur
        events.append(Event("pt", (lo, hi), t0, t1))
        link_free = t1
        # per-layer forward compute mini-procedures within the segment
        for l in range(lo, hi + 1):
            start = max(comp_free, t1)  # eq. (1): needs this segment's params
            end = start + float(costs.fc[l - 1])
            events.append(Event("fc", (l, l), start, end))
            comp_free = end
    return events, comp_free


def simulate_backward(costs: LayerCosts,
                      segments: Sequence[Segment]) -> Tuple[List[Event], float]:
    validate_backward_segments(segments, costs.num_layers)
    events: List[Event] = []
    comp_free = 0.0
    link_free = 0.0
    for lo, hi in segments:
        # per-layer backward compute, layer hi down to lo (eq. 6)
        for l in range(hi, lo - 1, -1):
            end = comp_free + float(costs.bc[l - 1])
            events.append(Event("bc", (l, l), comp_free, end))
            comp_free = end
        # gradient push once the whole segment's grads exist (eq. 2)
        start = max(link_free, comp_free)
        dur = costs.dt_push + float(np.sum(costs.gt[lo - 1:hi]))
        events.append(Event("gt", (lo, hi), start, start + dur))
        link_free = start + dur
    return events, link_free


def simulate_iteration(costs: LayerCosts,
                       fwd_segments: Sequence[Segment],
                       bwd_segments: Sequence[Segment]) -> IterationTimeline:
    f_events, f_t = simulate_forward(costs, fwd_segments)
    b_events, b_t = simulate_backward(costs, bwd_segments)
    return IterationTimeline(tuple(f_events), tuple(b_events), f_t, b_t)


@dataclasses.dataclass(frozen=True)
class PSTimeline:
    """Per-worker timelines of one parameter-server iteration.

    Every worker runs the paper's pull → forward → backward → push pipeline
    against its own link; in synchronous mode the iteration ends at the
    straggler's last gradient push (``makespan``), and ``barrier_waits``
    is each worker's idle time at the barrier — the quantity asynchronous
    bounded-staleness execution reclaims."""

    workers: Tuple[IterationTimeline, ...]

    @property
    def num_workers(self) -> int:
        return len(self.workers)

    @property
    def makespan(self) -> float:
        return max(t.total for t in self.workers)

    @property
    def straggler(self) -> int:
        totals = [t.total for t in self.workers]
        return int(np.argmax(totals))

    @property
    def barrier_waits(self) -> Tuple[float, ...]:
        span = self.makespan
        return tuple(span - t.total for t in self.workers)


def simulate_ps_iteration(topo: TopologyCosts,
                          decisions) -> PSTimeline:
    """Simulate one PS iteration over every worker of a topology.

    ``decisions`` is either one shared ``(fwd, bwd)`` decision (synchronous
    mode) or a sequence of per-worker decisions (one per worker, the
    asynchronous planning mode)."""
    if len(decisions) == 2 and decisions[0] and \
            isinstance(decisions[0][0], tuple) and \
            isinstance(decisions[0][0][0], (int, np.integer)):
        decisions = [decisions] * topo.num_workers
    if len(decisions) != topo.num_workers:
        raise ValueError(f"got {len(decisions)} decisions for "
                         f"{topo.num_workers} workers")
    return PSTimeline(workers=tuple(
        simulate_iteration(costs, f, b)
        for costs, (f, b) in zip(topo.workers, decisions)))


@dataclasses.dataclass(frozen=True)
class PSReplanTimeline:
    """Per-epoch PS timelines of a run over a time-varying topology.

    For each topology epoch, two simulations of one synchronous iteration:
    ``replanned`` uses the decision derived from that epoch's costs (what
    ``repro_torch.ps.dynamic.DynamicPSTrainer`` executes), ``frozen`` keeps the
    epoch-0 decision throughout (the plan-once baseline the paper's
    run-time loop exists to beat).  The gap is the stale-plan penalty."""

    replanned: Tuple[PSTimeline, ...]
    frozen: Tuple[PSTimeline, ...]

    def __post_init__(self):
        if len(self.replanned) != len(self.frozen):
            raise ValueError(f"{len(self.replanned)} replanned epochs vs "
                             f"{len(self.frozen)} frozen")
        if not self.replanned:
            raise ValueError("need at least one epoch")

    @property
    def num_epochs(self) -> int:
        return len(self.replanned)

    @property
    def makespans(self) -> Tuple[float, ...]:
        return tuple(t.makespan for t in self.replanned)

    @property
    def frozen_makespans(self) -> Tuple[float, ...]:
        return tuple(t.makespan for t in self.frozen)

    def stale_plan_penalty(self, epoch: int) -> float:
        """Seconds per iteration lost in ``epoch`` by keeping the epoch-0
        plan instead of re-planning (>= 0 whenever the re-plan is at least
        as good as the stale plan under the new costs)."""
        return self.frozen_makespans[epoch] - self.makespans[epoch]


def simulate_ps_replan(epoch_costs: Sequence[TopologyCosts],
                       epoch_decisions: Sequence,
                       ) -> PSReplanTimeline:
    """Simulate re-planned vs frozen execution over topology epochs.

    ``epoch_costs[e]`` is epoch ``e``'s projected :class:`TopologyCosts`;
    ``epoch_decisions[e]`` the decision derived from it (one shared
    decision or per-worker decisions, as ``simulate_ps_iteration``
    accepts).  The frozen baseline runs ``epoch_decisions[0]`` against
    every epoch's costs."""
    if len(epoch_costs) != len(epoch_decisions):
        raise ValueError(f"{len(epoch_costs)} epoch costs for "
                         f"{len(epoch_decisions)} decisions")
    replanned = tuple(simulate_ps_iteration(c, d)
                      for c, d in zip(epoch_costs, epoch_decisions))
    frozen = tuple(simulate_ps_iteration(c, epoch_decisions[0])
                   for c in epoch_costs)
    return PSReplanTimeline(replanned=replanned, frozen=frozen)


def check_partial_orders(timeline: IterationTimeline, L: int) -> None:
    """Assert the timeline satisfies eqs. (1)-(7).  Raises on violation."""
    eps = 1e-12

    def ends(events, kind):
        out = {}
        for e in events:
            if e.kind == kind:
                for l in range(e.layers[0], e.layers[1] + 1):
                    out[l] = e
        return out

    pt = ends(timeline.forward_events, "pt")
    fc = ends(timeline.forward_events, "fc")
    bc = ends(timeline.backward_events, "bc")
    gt = ends(timeline.backward_events, "gt")

    for l in range(1, L + 1):
        assert pt[l].end <= fc[l].start + eps, f"eq1 violated at layer {l}"
        assert bc[l].end <= gt[l].start + eps, f"eq2 violated at layer {l}"
    for l in range(1, L):
        assert pt[l].end <= pt[l + 1].end + eps, "eq4"
        assert fc[l].end <= fc[l + 1].start + eps, "eq5"
        assert bc[l + 1].end <= bc[l].start + eps, "eq6"
        assert gt[l + 1].end <= gt[l].end + eps, "eq7"
