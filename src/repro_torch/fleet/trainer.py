"""``FleetTrainer``: elastic bounded-staleness training over a churning
worker fleet.

This is ``repro_torch.ps.async_mode.AsyncPSTrainer`` grown to fleet scale
on the deterministic :class:`~repro_torch.fleet.engine.EventQueue`.  Three
event kinds share one engine:

* ``("commit",)`` — a worker's pull → compute → push iteration
  completes; the payload-free event is matched against the worker's
  ``in_flight`` record by ``seq``, so events of departed or evicted
  workers invalidate lazily (they pop and are ignored);
* ``("fleet", i)`` — the ``i``-th :class:`FleetEvent` of the schedule
  fires: joins enter the roster parked, leaves and crashes depart (a
  crash loses its connection mid-push — half its backward segments have
  already hit the server and stay in the ledger before the pending set
  is dropped), stalls and drifts are *silent* (nothing re-plans until
  measurement notices);
* ``("check",)`` — the periodic failure-detector probe: any in-flight
  iteration past ``stall_factor ×`` its believed duration is evicted,
  exactly how a real PS times out a silent worker.

**Re-planning.**  Every observable membership change (join, leave,
crash, stall eviction, detected drift) re-plans through the
``TopologyScheduler`` in per-worker mode: the live roster is projected
onto a fresh ``PSTopology`` (compute rates scaled by the *believed* drift
factors the detector has learned), the DP re-derives one plan per
worker, and when ``workers_per_shard`` moves the shard count the server
:meth:`~repro_torch.ps.server.PSServer.reshard`\\ s — versioned state
(parameters, snapshots, optimizer moments, version counter) is carried
bit-identically while the migration bytes land in the ``TransferLedger``.

**Staleness.**  Both throttles of the async core carry over: ``reject``
(server-side eviction of stale pushes) and ``wait`` (SSP admission gate
+ min-pin commit barrier), and the SSP bound holds under churn — the
admission gate counts *every* uncommitted computation, a departed
worker's in-flight work is cancelled (never committed), and the commit
barrier still requires the minimum pin.  A stalled worker keeps holding
its admission slot and its pinned version until the failure detector
evicts it, which is precisely why silent stalls hurt and detection
matters.

**Payloads.**  As in ``AsyncPSTrainer``, a computation's gradients wait
as one flat buffer per layer, flattened as autograd hands them back, and
each layer's flat leaves the payload as its segment goes out, so the
server's pending set holds the only copy.  A crash pushes the first half
of the segments and frees the rest of the payload before the next
admission; a departed worker's payload goes with it.

**Determinism.**  The loop is a pure function of (model init, schedule,
specs, batch function): no wall clock, no RNG.  The *entire* loop state
— engine entries, in-flight gradients, barrier, roster, detector and
scheduler state, error-feedback residuals, the run log — round-trips
through ``save_loop_state``/``restore_loop_state`` (the reference's keys
and meta layout), so a resumed run replays bit-identically to an
uninterrupted one.  The trainer runs on the device of its initial layers;
batches and restored buffers are moved there.
"""

from __future__ import annotations

import dataclasses
import json
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.core.buckets import BucketPlan, decision_from_plan, \
    plan_from_decision
from repro_torch.core.costmodel import iteration_time
from repro_torch.core.planner import AsyncPlanner, Planner
from repro_torch.core.scheduler import TopologyScheduler
from repro_torch.dist.collectives import FlatSpec, flatten_tree, \
    make_flat_spec, unflatten_tree
from repro_torch.fleet.drift import FleetDriftDetector
from repro_torch.fleet.engine import EventQueue
from repro_torch.fleet.membership import (FleetEvent, FleetMembership,
                                          FleetSchedule, WorkerSpec)
from repro_torch.optim import Optimizer
from repro_torch.ps.async_mode import (THROTTLES, AsyncPushEvent, AsyncRunLog,
                                       value_and_grad)
from repro_torch.ps.server import PSServer, PushResult, StaleVersion


@dataclasses.dataclass(frozen=True)
class FleetReplanEvent:
    """One pass through the ``TopologyScheduler`` after a trigger."""

    sim_time: float
    at_push: int                 # accepted pushes when the re-plan ran
    reason: str                  # init|join|leave|crash|stall|drift
    worker: Optional[int]        # the triggering worker (None for init)
    num_workers: int             # fleet size after the trigger
    num_servers: int
    plan_changed: bool
    resharded: bool
    migrated_bytes: int
    scheduling_seconds: float
    overhead_hidden: bool


@dataclasses.dataclass(frozen=True)
class MembershipChange:
    """One applied roster change or silent-failure (non-)observation."""

    sim_time: float
    kind: str          # join|leave|crash|stall|drift|stall-evict|drift-detect
    worker: int
    fleet_size: int    # active workers after the change


Payload = List[Optional[torch.Tensor]]     # one gradient flat a layer


@dataclasses.dataclass
class _InFlight:
    """One admitted iteration: its commit event and everything the push
    will need (the engine event itself carries no payload)."""

    seq: int
    started: float
    pin: int
    loss: float
    grads: Payload
    plan: BucketPlan


@dataclasses.dataclass
class _FleetLoop:
    """Resumable event-loop state (see ``save_loop_state``)."""

    log: AsyncRunLog
    parked: List[int]
    engine: EventQueue = dataclasses.field(default_factory=EventQueue)
    in_flight: Dict[int, _InFlight] = dataclasses.field(default_factory=dict)
    # (pin, completion time, worker, loss, grads, plan)
    barrier: List[Tuple] = dataclasses.field(default_factory=list)
    now: float = 0.0
    accepted: int = 0
    attempts: Dict[int, int] = dataclasses.field(default_factory=dict)
    retries: Dict[int, int] = dataclasses.field(default_factory=dict)


def _plan_to_lists(plan: BucketPlan) -> list:
    return [[list(b) for b in plan.forward],
            [list(b) for b in plan.backward]]


def _plan_from_lists(data: Sequence) -> BucketPlan:
    return BucketPlan(forward=tuple(tuple(b) for b in data[0]),
                      backward=tuple(tuple(b) for b in data[1]))


class FleetTrainer:
    """Event-driven bounded-staleness trainer over an elastic fleet.

    Parameters
    ----------
    init_layers / loss_fn / optimizer:
        as for ``AsyncPSTrainer`` — per-layer parameter trees on the
        device the trainer runs on, and a ``loss_fn(layers, batch) ->
        scalar`` differentiated once per computation.
    workers:
        the initial fleet: ``{worker id: WorkerSpec}`` (or an int for
        ``n`` default-spec workers with ids ``0..n-1``).  Ids are
        *global* and never reused; topology position always follows
        ascending active id.
    schedule:
        the :class:`FleetSchedule` of join/leave/fail/drift events.
    num_servers:
        shard count when ``workers_per_shard == 0`` (fixed sharding).
    workers_per_shard:
        when positive, the shard count tracks the fleet:
        ``S = ceil(active / workers_per_shard)`` — membership changes
        that move it re-shard the server in place.
    staleness / throttle / compressor:
        the async core's bound ``k``, ``"reject"`` or ``"wait"``, and
        optional push compression with per-(worker, layer) EF residuals.
    strategy:
        DP strategy for the per-worker ``TopologyScheduler``.
    profiles:
        per-layer :class:`LayerProfile`\\ s for the cost model (default:
        synthesized from the parameter shapes).
    drift_detector:
        a :class:`FleetDriftDetector`; every commit feeds it the
        worker's observed gap, a trigger scales that worker's believed
        compute rate to the measurement and re-plans.
    stall_factor / check_interval:
        failure detection: every ``check_interval`` simulated seconds
        (default: the slowest believed iteration) any in-flight
        iteration older than ``stall_factor × max(believed duration,
        observed EWMA gap)`` is evicted.  Note the timeout trade-off of
        real failure detectors: a worker that silently slows beyond
        ``stall_factor×`` before detection catches up is evicted as
        stalled rather than re-planned.
    """

    def __init__(self, *, init_layers: Sequence[Any],
                 loss_fn: Callable[[List[Any], Dict[str, Any]], Any],
                 optimizer: Optimizer,
                 workers: Union[int, Mapping[int, WorkerSpec]],
                 schedule: Optional[FleetSchedule] = None,
                 num_servers: int = 1, workers_per_shard: int = 0,
                 staleness: int = 1, throttle: str = "wait",
                 strategy: str = "dynacomm",
                 profiles: Optional[Sequence[Any]] = None,
                 compressor=None,
                 drift_detector: Optional[FleetDriftDetector] = None,
                 stall_factor: float = 4.0, check_interval: float = 0.0,
                 async_planning: bool = False, plan_cache_size: int = 256):
        init_layers = list(init_layers)
        if not init_layers:
            raise ValueError("need at least one layer tree")
        if throttle not in THROTTLES:
            raise ValueError(f"throttle must be one of {THROTTLES}, got "
                             f"{throttle!r}")
        if staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {staleness}")
        if workers_per_shard < 0:
            raise ValueError(f"workers_per_shard must be >= 0, got "
                             f"{workers_per_shard}")
        if stall_factor <= 1:
            raise ValueError(f"stall_factor must be > 1, got {stall_factor}")
        if isinstance(workers, int):
            workers = {w: WorkerSpec() for w in range(workers)}
        self._init_specs: Dict[int, WorkerSpec] = dict(sorted(workers.items()))
        self.schedule = schedule or FleetSchedule()
        self.schedule.validate_against(tuple(self._init_specs))
        self.staleness = staleness
        self.throttle = throttle
        self.workers_per_shard = workers_per_shard
        self._fixed_servers = num_servers
        self.stall_factor = stall_factor
        self._check_interval = check_interval
        self.specs: Tuple[FlatSpec, ...] = tuple(
            make_flat_spec(t, 1) for t in init_layers)
        if profiles is None:
            from repro_torch.ps.dynamic import profiles_from_specs
            profiles = profiles_from_specs(self.specs)
        self._profiles = tuple(profiles)
        if compressor is not None and compressor.scheme == "none":
            compressor = None
        self.compressor = compressor
        self._grad_fn = value_and_grad(loss_fn)
        self.detector = drift_detector or FleetDriftDetector()
        # The memo cache is what makes fleet-scale re-planning viable: a
        # homogeneous roster's W identical per-worker DPs collapse to one
        # solve + W−1 content-key hits, and re-plans after churn re-use
        # every unchanged worker's decision.  async_planning additionally
        # pre-solves the next scripted membership change's roster in the
        # background (see _speculate_next_replan).
        self.async_planning = async_planning
        planner_cls = AsyncPlanner if async_planning else Planner
        self.planner = planner_cls(cache_size=plan_cache_size)
        self.scheduler = TopologyScheduler(strategy=strategy,
                                           reschedule_every=1,
                                           mode="per-worker",
                                           planner=self.planner)
        self._next_fleet_event = 0       # index into schedule.events
        self.membership = FleetMembership(self._init_specs)
        topo0 = self.membership.topology(
            self._servers_for(self.membership.num_active))
        flats = []
        with torch.no_grad():
            for l, spec in enumerate(self.specs):
                flats.append(flatten_tree(init_layers[l], spec))
                init_layers[l] = None     # one copy of the weights at a time
        self.device = flats[0].device
        self.server = PSServer(self.specs, topo0, optimizer, flats,
                               staleness_bound=staleness,
                               compressor=compressor)
        self.topology = topo0
        self._residuals: Dict[Tuple[int, int], torch.Tensor] = {}
        self._stalled: set = set()
        self._true_factor: Dict[int, float] = {}
        self._believed: Dict[int, float] = {}
        self._plans: Dict[int, BucketPlan] = {}
        self._durations: Dict[int, float] = {}       # believed (planner)
        self._base_durations: Dict[int, float] = {}  # spec rates, no factors
        self._true_durations: Dict[int, float] = {}  # simulation physics
        self._num_servers = topo0.num_servers
        self._push_history: Dict[int, List[list]] = {}
        self.replan_events: List[FleetReplanEvent] = []
        self.membership_events: List[MembershipChange] = []
        self._loop: Optional[_FleetLoop] = None

    # ------------------------------------------------------------------
    # roster → topology → plans
    # ------------------------------------------------------------------

    def _servers_for(self, num_active: int) -> int:
        if self.workers_per_shard > 0:
            return max(1, -(-num_active // self.workers_per_shard))
        return self._fixed_servers

    def _worker_costs(self, factors: Mapping[int, float]):
        topo = self.membership.topology(self._num_servers,
                                        flops_scale=factors)
        return topo, topo.topology_costs(self._profiles,
                                         compressor=self.compressor)

    def _replan(self, loop: _FleetLoop, now: float, *, reason: str,
                worker: Optional[int]) -> None:
        """Project the live roster onto a topology, re-run the DP, and
        re-shard the server if the shard count moved."""
        W = self.membership.num_active
        if W == 0:
            self._plans, self._durations = {}, {}
            self._base_durations, self._true_durations = {}, {}
            return
        S = self._servers_for(W)
        self._num_servers = S
        resharded, migrated = False, 0
        topo, costs = self._worker_costs(self._believed)
        if S != self.server.topology.num_servers:
            migrated = self.server.reshard(topo)["migrated_bytes"]
            resharded = True
        else:
            self.server.topology = topo
        self.topology = topo
        self.scheduler.invalidate()
        decisions = self.scheduler.decision_for_iteration(costs)
        L = len(self.specs)
        active = self.membership.active
        new_plans = {w: plan_from_decision(*d, L)
                     for w, d in zip(active, decisions)}
        plan_changed = any(new_plans[w] != self._plans.get(w)
                           for w in new_plans)
        self._plans = new_plans
        self._durations = {
            w: iteration_time(costs.workers[i],
                              *decision_from_plan(new_plans[w]))
            for i, w in enumerate(active)}
        _, base_costs = self._worker_costs({})
        self._base_durations = {
            w: iteration_time(base_costs.workers[i],
                              *decision_from_plan(new_plans[w]))
            for i, w in enumerate(active)}
        self._recompute_true_durations()
        self.replan_events.append(FleetReplanEvent(
            sim_time=now, at_push=loop.accepted, reason=reason,
            worker=worker, num_workers=W, num_servers=S,
            plan_changed=plan_changed, resharded=resharded,
            migrated_bytes=migrated,
            scheduling_seconds=self.scheduler.last_scheduling_seconds,
            overhead_hidden=self.scheduler.scheduling_overhead_hidden(
                costs)))
        if self.async_planning:
            self._speculate_next_replan()

    def _speculate_next_replan(self) -> None:
        """Phase one of the async protocol: project the roster the *next*
        scripted membership change will leave behind and pre-solve its
        per-worker DPs in the background, so the re-plan at that event is
        a collect instead of an inline O(W·L³) sweep.  Unscripted
        re-plans (stall evictions, drift detections) and mispredictions
        simply fall back to the planner's inline solve — speculation
        never changes a decision, only where it was computed."""
        specs = {w: self.membership.spec(w) for w in self.membership.active}
        for fev in self.schedule.events[self._next_fleet_event:]:
            if fev.kind == "join":
                specs[fev.worker] = fev.spec or WorkerSpec()
            elif fev.kind == "leave" or \
                    (fev.kind == "fail" and fev.mode == "crash"):
                specs.pop(fev.worker, None)
            else:
                continue         # stalls/drifts don't re-plan on arrival
            break
        else:
            return               # no further scripted membership change
        if not specs:
            return
        topo = FleetMembership(specs).topology(
            self._servers_for(len(specs)), flops_scale=self._believed)
        self.planner.submit_topology(
            topo.topology_costs(self._profiles, compressor=self.compressor),
            self.scheduler.strategy)

    def _recompute_true_durations(self) -> None:
        """What an iteration *actually* takes per worker — the believed
        plan timed under the true (possibly drifted) compute rates."""
        _, costs = self._worker_costs(self._true_factor)
        self._true_durations = {
            w: iteration_time(costs.workers[i],
                              *decision_from_plan(self._plans[w]))
            for i, w in enumerate(self.membership.active)}

    @property
    def plans(self) -> Dict[int, BucketPlan]:
        """{active worker: its current plan}."""
        return dict(self._plans)

    @property
    def push_history(self) -> Dict[int, Tuple[Tuple[BucketPlan, int, int],
                                              ...]]:
        """Per worker (ever admitted), the plan-segmented push record:
        ``(plan, completed pushes, trailing partial segments)`` runs in
        order — what an elastic worker's ledger decomposes against."""
        return {w: tuple((p, full, extra) for p, full, extra in hist)
                for w, hist in self._push_history.items()}

    # ------------------------------------------------------------------
    # one worker attempt (segmented pull → grads → segmented push)
    # ------------------------------------------------------------------

    def _pull_layers(self, worker: int,
                     plan: BucketPlan) -> Tuple[int, List[Any]]:
        while True:
            version: Optional[int] = None
            buffers: Dict[int, Any] = {}
            try:
                for bucket in plan.forward:
                    v, flats = self.server.pull_bucket(
                        bucket, version=version, worker=worker)
                    version = v
                    buffers.update(flats)
            except StaleVersion:
                continue
            layers = [unflatten_tree(buffers[l], self.specs[l])
                      for l in range(len(self.specs))]
            return version, layers

    def _compress_flat(self, worker: int, layer: int,
                       flat: torch.Tensor) -> torch.Tensor:
        """What the server reconstructs from this worker's wire payload
        (the error-feedback round trip works in place on ``flat``, which
        the caller gives up)."""
        if self.compressor is None:
            return flat
        if not self.compressor.error_feedback:
            return self.compressor.roundtrip(flat)
        key = (worker, layer)
        residual = self._residuals.get(key)
        if residual is None:
            residual = torch.zeros_like(flat)
        compressed, self._residuals[key] = \
            self.compressor.feedback_roundtrip(flat, residual)
        return compressed

    def _take(self, worker: int, layer: int, grads: Payload) -> torch.Tensor:
        """Layer ``layer``'s pushed gradient, handed over out of the
        payload (whose slot empties, so the server's pending set holds the
        only copy)."""
        flat, grads[layer] = grads[layer], None
        return self._compress_flat(worker, layer, flat)

    def _note_push(self, worker: int, plan: BucketPlan,
                   partial_segments: int = 0) -> None:
        hist = self._push_history.setdefault(worker, [])
        if not hist or hist[-1][0] != plan or hist[-1][2]:
            hist.append([plan, 0, 0])
        if partial_segments:
            hist[-1][2] += partial_segments
        else:
            hist[-1][1] += 1

    def _push(self, worker: int, version: int, grads: Payload,
              plan: BucketPlan) -> PushResult:
        result: Optional[PushResult] = None
        for bucket in plan.backward:
            flat_grads = {l: self._take(worker, l, grads) for l in bucket}
            result = self.server.push_bucket(worker, version, bucket,
                                             flat_grads)
            del flat_grads
        assert result is not None, "plan.backward committed no push"
        self._note_push(worker, plan)
        return result

    # ------------------------------------------------------------------
    # the event loop
    # ------------------------------------------------------------------

    def run(self, num_pushes: int, batch_fn: Callable[[int, int], Any], *,
            reset: bool = True) -> AsyncRunLog:
        """Run until ``num_pushes`` more pushes were *accepted*.

        ``batch_fn(worker, attempt_idx) -> batch`` supplies data per
        global worker id.  ``reset=False`` resumes the previous loop
        (clock, in-flight work, roster, pending fleet events)."""
        if num_pushes < 1:
            raise ValueError(f"num_pushes must be >= 1, got {num_pushes}")
        if reset or self._loop is None:
            self._init_loop()
        loop = self._loop
        target = loop.accepted + num_pushes
        self._drain(loop, loop.now, target, batch_fn)
        self._admit(loop, loop.now, batch_fn)
        while loop.accepted < target:
            if not loop.engine:
                raise RuntimeError(
                    f"fleet drained at t={loop.now}: no events left with "
                    f"{target - loop.accepted} pushes to go")
            if self.membership.num_active == 0 and not loop.in_flight \
                    and not loop.barrier:
                raise RuntimeError(
                    f"fleet empty at t={loop.now}: every worker departed "
                    f"with {target - loop.accepted} pushes to go")
            ev = loop.engine.pop()
            loop.now = ev.time
            kind = ev.payload[0]
            if kind == "commit":
                self._on_commit(loop, ev, target, batch_fn)
            elif kind == "fleet":
                # bookmark for the speculative pre-solve: the next
                # scripted event after this one is what a re-plan here
                # should pre-compute for
                self._next_fleet_event = ev.payload[1] + 1
                self._apply_fleet_event(
                    loop, self.schedule.events[ev.payload[1]], ev.time,
                    target, batch_fn)
            else:
                self._on_check(loop, ev.time, target, batch_fn)
        return loop.log

    def _init_loop(self) -> None:
        self.membership = FleetMembership(self._init_specs)
        self.detector = FleetDriftDetector(
            alpha=self.detector.alpha, threshold=self.detector.threshold,
            patience=self.detector.patience, warmup=self.detector.warmup)
        self._residuals = {}
        self._stalled = set()
        self._true_factor, self._believed = {}, {}
        self._push_history = {}
        self.replan_events, self.membership_events = [], []
        self._next_fleet_event = 0
        loop = _FleetLoop(log=AsyncRunLog(),
                          parked=list(self.membership.active))
        loop.attempts = {w: 0 for w in loop.parked}
        loop.retries = {w: 0 for w in loop.parked}
        self._loop = loop
        self._replan(loop, 0.0, reason="init", worker=None)
        for i, e in enumerate(self.schedule.events):
            loop.engine.push(e.time, e.worker, ("fleet", i))
        loop.engine.push(self._check_every(), -1, ("check",))

    def _check_every(self) -> float:
        if self._check_interval > 0:
            return self._check_interval
        return max(self._durations.values(), default=1.0) or 1.0

    def _admit(self, loop: _FleetLoop, now: float, batch_fn) -> None:
        if self.throttle == "reject":
            while loop.parked:
                self._start(loop, loop.parked.pop(0), now, batch_fn)
            return
        k = self.staleness
        while loop.parked and \
                len(loop.in_flight) + len(loop.barrier) <= k:
            self._start(loop, loop.parked.pop(0), now, batch_fn)

    def _start(self, loop: _FleetLoop, worker: int, now: float,
               batch_fn) -> None:
        """Admit ``worker``: pull at the head, compute its gradients as one
        flat a layer, schedule the commit."""
        plan = self._plans[worker]
        version, layers = self._pull_layers(worker, plan)
        batch = batch_fn(worker, loop.attempts[worker])
        batch = {k: v.to(self.device) for k, v in batch.items()}
        loss, grads = self._grad_fn(layers, batch)
        del layers
        flats: Payload = []
        for l, spec in enumerate(self.specs):
            flats.append(flatten_tree(grads[l], spec))
            grads[l] = None       # keep one copy of the gradients, not two
        loop.attempts[worker] += 1
        ev = loop.engine.push(now + self._true_durations[worker], worker,
                              ("commit",))
        loop.in_flight[worker] = _InFlight(
            seq=ev.seq, started=now, pin=version, loss=loss, grads=flats,
            plan=plan)

    def _min_pin(self, loop: _FleetLoop) -> int:
        return min([e.pin for e in loop.in_flight.values()] +
                   [b[0] for b in loop.barrier])

    def _on_commit(self, loop: _FleetLoop, ev, target: int,
                   batch_fn) -> None:
        w = ev.worker
        entry = loop.in_flight.get(w)
        if entry is None or entry.seq != ev.seq:
            return                       # cancelled: departed or evicted
        if w in self._stalled:
            return                       # silent stall: commit never lands
        del loop.in_flight[w]
        if self.detector.observe(w, ev.time - entry.started):
            self._on_drift_detected(loop, w, ev.time)
        if self.throttle == "wait":
            loop.barrier.append((entry.pin, ev.time, w, entry.loss,
                                 entry.grads, entry.plan))
            self._drain(loop, ev.time, target, batch_fn)
            return
        result = self._push(w, entry.pin, entry.grads, entry.plan)
        loop.log.events.append(AsyncPushEvent(
            worker=w, sim_time=ev.time, version=entry.pin, result=result,
            loss=entry.loss, retries=loop.retries[w]))
        loop.accepted += int(result.accepted)
        loop.retries[w] = 0 if result.accepted else loop.retries[w] + 1
        if self.membership.is_active(w):
            self._start(loop, w, ev.time, batch_fn)

    def _drain(self, loop: _FleetLoop, now: float, target: int,
               batch_fn) -> None:
        """Wait throttle: commit every barrier entry whose pin is the
        in-flight minimum, in (pin, completion, worker) order."""
        if self.throttle != "wait":
            return
        k = self.staleness
        while loop.barrier and loop.accepted < target:
            loop.barrier.sort(key=lambda e: (e[0], e[1], e[2]))
            pin, done_t, w, loss, grads, plan = loop.barrier[0]
            if pin > self._min_pin(loop):
                return                   # blocked on a laggard
            loop.barrier.pop(0)
            assert self.server.head_distance(pin) <= k, \
                "SSP gates must keep every commit within the bound"
            result = self._push(w, pin, grads, plan)
            assert result.accepted, \
                "a wait-throttled push can never be stale at commit"
            wait_s = now - done_t
            if wait_s > 0:
                self.server.ledger.waited_pushes += 1
            loop.log.events.append(AsyncPushEvent(
                worker=w, sim_time=now, version=pin, result=result,
                loss=loss, retries=0, wait_s=wait_s))
            loop.accepted += 1
            if self.membership.is_active(w):
                loop.parked.append(w)
            self._admit(loop, now, batch_fn)

    # ------------------------------------------------------------------
    # fleet events, failure detection, drift
    # ------------------------------------------------------------------

    def _record_membership(self, now: float, kind: str,
                           worker: int) -> None:
        self.membership_events.append(MembershipChange(
            sim_time=now, kind=kind, worker=worker,
            fleet_size=self.membership.num_active))

    def _apply_fleet_event(self, loop: _FleetLoop, fev: FleetEvent,
                           now: float, target: int, batch_fn) -> None:
        w = fev.worker
        if fev.kind == "join":
            self.membership.join(w, fev.spec or WorkerSpec(), time=now,
                                 version=self.server.version)
            loop.attempts.setdefault(w, 0)
            loop.retries.setdefault(w, 0)
            loop.parked.append(w)
            self._record_membership(now, "join", w)
            self._replan(loop, now, reason="join", worker=w)
        elif fev.kind == "leave":
            self._remove_worker(loop, w, now, reason="leave", crash=False)
            self._record_membership(now, "leave", w)
            self._replan(loop, now, reason="leave", worker=w)
        elif fev.kind == "fail" and fev.mode == "crash":
            self._remove_worker(loop, w, now, reason="crash", crash=True)
            self._record_membership(now, "crash", w)
            self._replan(loop, now, reason="crash", worker=w)
        elif fev.kind == "fail":         # silent stall: no replan yet
            self._stalled.add(w)
            self._record_membership(now, "stall", w)
        else:                            # silent drift: physics change only
            self._true_factor[w] = fev.factor
            self._recompute_true_durations()
            self._record_membership(now, "drift", w)
        self._drain(loop, now, target, batch_fn)
        self._admit(loop, now, batch_fn)

    def _remove_worker(self, loop: _FleetLoop, w: int, now: float, *,
                       reason: str, crash: bool) -> None:
        entry = loop.in_flight.pop(w, None)
        if entry is not None and crash:
            # the connection dies mid-push: the first half of the backward
            # segments already reached the server (and its ledger); the
            # incomplete pending set is dropped, never committed
            partial = len(entry.plan.backward) // 2
            for bucket in entry.plan.backward[:partial]:
                flat = {l: self._take(w, l, entry.grads) for l in bucket}
                self.server.push_bucket(w, entry.pin, bucket, flat)
            if partial:
                self._note_push(w, entry.plan, partial_segments=partial)
            self.server.drop_pending(w)
        if entry is not None:
            entry.grads.clear()          # freed before the next admission
        loop.barrier = [b for b in loop.barrier if b[2] != w]
        if w in loop.parked:
            loop.parked.remove(w)
        self._stalled.discard(w)
        self.membership.depart(w, time=now, reason=reason)
        self.detector.forget(w)
        for key in [k for k in self._residuals if k[0] == w]:
            del self._residuals[key]

    def _on_check(self, loop: _FleetLoop, now: float, target: int,
                  batch_fn) -> None:
        evicted = []
        for w in sorted(loop.in_flight):
            entry = loop.in_flight[w]
            believed = max(self._durations.get(w, 0.0),
                           self.detector.observed_gap(w) or 0.0)
            if now > entry.started + self.stall_factor * believed + 1e-9:
                evicted.append(w)
        for w in evicted:
            self._remove_worker(loop, w, now, reason="stall", crash=False)
            self._record_membership(now, "stall-evict", w)
            self._replan(loop, now, reason="stall", worker=w)
        loop.engine.push(now + self._check_every(), -1, ("check",))
        if evicted:
            self._drain(loop, now, target, batch_fn)
            self._admit(loop, now, batch_fn)

    def _on_drift_detected(self, loop: _FleetLoop, w: int,
                           now: float) -> None:
        base = self._base_durations.get(w)
        observed = self.detector.observed_gap(w)
        if base and observed:
            self._believed[w] = max(observed / base, 1e-6)
        self._record_membership(now, "drift-detect", w)
        self._replan(loop, now, reason="drift", worker=w)

    # ------------------------------------------------------------------
    # interop
    # ------------------------------------------------------------------

    @property
    def log(self) -> Optional[AsyncRunLog]:
        return self._loop.log if self._loop is not None else None

    @property
    def planner_stats(self) -> Dict[str, float]:
        """Memo-cache / async-planning counters (``PlannerStats``)."""
        return self.planner.stats.as_dict()

    def layer_params(self) -> List[Any]:
        """Head-version parameters, unflattened to the layer trees (views
        of the server's buffers)."""
        return [unflatten_tree(f, s)
                for f, s in zip(self.server.flats(), self.specs)]

    def reset_loop(self) -> None:
        """Discard the loop (clock, in-flight work, roster evolution);
        the next ``run`` restarts from the initial fleet at t=0."""
        self._loop = None
        self._residuals = {}

    # ------------------------------------------------------------------
    # loop checkpointing (bit-identical resume)
    # ------------------------------------------------------------------

    def save_loop_state(self, path: str) -> None:
        """Serialize the *entire* loop — engine, in-flight gradients,
        barrier, roster, detector/scheduler state, EF residuals, ledger,
        and the run log — so a restore resumes bit-identically."""
        if self._loop is None:
            raise ValueError("no active loop to save; run() first")
        loop = self._loop
        led = self.server.ledger
        meta = {
            "now": loop.now, "accepted": loop.accepted,
            "parked": list(loop.parked),
            "attempts": {str(w): n for w, n in loop.attempts.items()},
            "retries": {str(w): n for w, n in loop.retries.items()},
            "stalled": sorted(self._stalled),
            "true_factor": {str(w): f
                            for w, f in self._true_factor.items()},
            "believed": {str(w): f for w, f in self._believed.items()},
            "membership": self.membership.state_dict(),
            "detector": self.detector.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "planner": self.planner.state_dict(),
            "next_fleet_event": self._next_fleet_event,
            "num_servers": self._num_servers,
            "plans": {str(w): _plan_to_lists(p)
                      for w, p in self._plans.items()},
            "durations": {str(w): d for w, d in self._durations.items()},
            "base_durations": {str(w): d
                               for w, d in self._base_durations.items()},
            "true_durations": {str(w): d
                               for w, d in self._true_durations.items()},
            "push_history": {str(w): [[_plan_to_lists(p), full, extra]
                                      for p, full, extra in hist]
                             for w, hist in self._push_history.items()},
            "engine": loop.engine.state(),
            "in_flight": [[w, e.seq, e.started, e.pin, e.loss,
                           _plan_to_lists(e.plan)]
                          for w, e in sorted(loop.in_flight.items())],
            "barrier": [[pin, done_t, w, loss, _plan_to_lists(plan)]
                        for pin, done_t, w, loss, _g, plan
                        in loop.barrier],
            "log": [[e.worker, e.sim_time, e.version, e.loss, e.retries,
                     e.wait_s, e.result.worker, e.result.accepted,
                     e.result.staleness, e.result.version]
                    for e in loop.log.events],
            "replans": [dataclasses.asdict(e) for e in self.replan_events],
            "membership_events": [dataclasses.asdict(e)
                                  for e in self.membership_events],
            "residual_keys": sorted([w, l] for w, l in self._residuals),
            "ledger": {
                "pulled_bytes": {str(w): b
                                 for w, b in led.pulled_bytes.items()},
                "pushed_bytes": {str(w): b
                                 for w, b in led.pushed_bytes.items()},
                "pulled_wire_bytes": {
                    str(w): b for w, b in led.pulled_wire_bytes.items()},
                "pushed_wire_bytes": {
                    str(w): b for w, b in led.pushed_wire_bytes.items()},
                "num_pulls": led.num_pulls, "num_pushes": led.num_pushes,
                "rejected_pushes": led.rejected_pushes,
                "waited_pushes": led.waited_pushes,
                "migrated_bytes": led.migrated_bytes,
                "num_reshards": led.num_reshards,
            },
        }
        tree: Dict[str, Any] = {"meta": np.asarray(json.dumps(meta))}
        for w, e in loop.in_flight.items():
            for l, g in enumerate(e.grads):
                tree[f"infl/{w}/{l}"] = g
        for i, (_pin, _t, _w, _loss, grads, _plan) in \
                enumerate(loop.barrier):
            for l, g in enumerate(grads):
                tree[f"bar/{i}/{l}"] = g
        for (w, l), r in self._residuals.items():
            tree[f"res/{w}/{l}"] = r
        from repro_torch.checkpoint import save_checkpoint
        save_checkpoint(path, tree)

    def restore_loop_state(self, path: str) -> None:
        """Inverse of :meth:`save_loop_state`.  Restore the server's
        ``state_dict`` first — the loop's pinned versions reference it."""
        with np.load(path) as f:
            data = {k: f[k] for k in f.files}

        def flat(key: str) -> torch.Tensor:
            return torch.from_numpy(data.pop(key)).to(self.device)

        meta = json.loads(str(data["meta"]))
        self.membership = FleetMembership.from_state(meta["membership"])
        self.detector.load_state_dict(meta["detector"])
        self.scheduler.load_state_dict(meta["scheduler"])
        if meta.get("planner") is not None:
            self.planner.load_state_dict(meta["planner"])
        self._stalled = set(meta["stalled"])
        self._true_factor = {int(w): f
                             for w, f in meta["true_factor"].items()}
        self._believed = {int(w): f for w, f in meta["believed"].items()}
        self._next_fleet_event = int(meta.get("next_fleet_event", 0))
        self._num_servers = int(meta["num_servers"])
        self._plans = {int(w): _plan_from_lists(p)
                       for w, p in meta["plans"].items()}
        self._durations = {int(w): d
                           for w, d in meta["durations"].items()}
        self._base_durations = {int(w): d
                                for w, d in meta["base_durations"].items()}
        self._true_durations = {int(w): d
                                for w, d in meta["true_durations"].items()}
        self._push_history = {
            int(w): [[_plan_from_lists(p), full, extra]
                     for p, full, extra in hist]
            for w, hist in meta["push_history"].items()}
        self.replan_events = [FleetReplanEvent(**e)
                              for e in meta["replans"]]
        self.membership_events = [MembershipChange(**e)
                                  for e in meta["membership_events"]]
        self._residuals = {(w, l): flat(f"res/{w}/{l}")
                           for w, l in meta["residual_keys"]}
        led = self.server.ledger
        lm = meta["ledger"]
        led.pulled_bytes = {int(w): b
                            for w, b in lm["pulled_bytes"].items()}
        led.pushed_bytes = {int(w): b
                            for w, b in lm["pushed_bytes"].items()}
        led.pulled_wire_bytes = {
            int(w): b for w, b in lm["pulled_wire_bytes"].items()}
        led.pushed_wire_bytes = {
            int(w): b for w, b in lm["pushed_wire_bytes"].items()}
        led.num_pulls, led.num_pushes = lm["num_pulls"], lm["num_pushes"]
        led.rejected_pushes = lm["rejected_pushes"]
        led.waited_pushes = lm["waited_pushes"]
        led.migrated_bytes = lm["migrated_bytes"]
        led.num_reshards = lm["num_reshards"]
        topo = self.membership.topology(self._num_servers,
                                        flops_scale=self._believed)
        self.server.topology = topo
        self.topology = topo
        loop = _FleetLoop(
            log=AsyncRunLog(events=[
                AsyncPushEvent(
                    worker=w, sim_time=t, version=v, loss=loss,
                    retries=r, wait_s=ws,
                    result=PushResult(worker=rw, accepted=bool(acc),
                                      staleness=st, version=rv))
                for w, t, v, loss, r, ws, rw, acc, st, rv
                in meta["log"]]),
            parked=[int(w) for w in meta["parked"]],
            engine=EventQueue.from_state(meta["engine"],
                                         decode=lambda p: tuple(p)),
            now=float(meta["now"]), accepted=int(meta["accepted"]),
            attempts={int(w): n for w, n in meta["attempts"].items()},
            retries={int(w): n for w, n in meta["retries"].items()})
        L = len(self.specs)
        for w, seq, started, pin, loss, plan in meta["in_flight"]:
            loop.in_flight[int(w)] = _InFlight(
                seq=int(seq), started=float(started), pin=int(pin),
                loss=float(loss),
                grads=[flat(f"infl/{w}/{l}") for l in range(L)],
                plan=_plan_from_lists(plan))
        for i, (pin, done_t, w, loss, plan) in enumerate(meta["barrier"]):
            loop.barrier.append((int(pin), float(done_t), int(w),
                                 float(loss),
                                 [flat(f"bar/{i}/{l}") for l in range(L)],
                                 _plan_from_lists(plan)))
        self._loop = loop
