"""Run-time re-planning for the parameter-server subsystem (synchronous).

``repro_torch.dist.dynamic.DynamicTrainer`` closes the paper's run-time
loop for the flat ZeRO group; :class:`DynamicPSTrainer` closes it for the
paper's *actual* deployment topology.  A
:class:`repro_torch.ps.topology.TopologySchedule` makes the fabric
time-varying — per-link bandwidth/RTT and per-worker compute rates
shifting on epoch boundaries — and once per topology epoch the trainer
re-projects the active topology onto per-worker ``TopologyCosts``, re-runs
the straggler-minimizing ``consensus_decision`` through a memoising
:class:`~repro_torch.core.planner.Planner`, and swaps the step of the
pull/push plan from the shared :class:`repro_torch.runtime.replan.PlanStepCache`.
With ``cost_source="measured"``, per-layer fc/bc come from measured
timings of the per-layer applies (re-measured every ``remeasure_every``
topology epochs) rescaled to each worker's compute rate.  A compressor
rides along: plans are priced on its wire bytes and the step pushes its
round-tripped gradients.  The state layout (one ``FlatSpec`` flat buffer
per sched layer) is plan-independent, so states carry across swaps and
the loss trajectory is bitwise the one of statically running each epoch's
plan.

:class:`DynamicAsyncPSTrainer` is the asynchronous, event-driven
counterpart: once per topology epoch — a span of ``pushes_per_epoch``
*accepted* pushes — it re-runs per-worker ``schedule_topology`` (each
worker gets its own decomposition, matched to its own link and compute
rate) and swaps the plans and the simulated-clock costs into the resumable
:class:`repro_torch.ps.async_mode.AsyncPSTrainer` loop, under either
throttle (with optional BSP push aggregation).  As in the reference it is
not a ``ReplanMixin``: it has no step to cache.

Every re-plan records a reschedule event carrying the scheduling wall
time and the paper's Table I overhead-hidden check against the topology's
Δt + gt¹ idle window (the minimum over workers).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.buckets import BucketPlan, plan_from_decision
from repro_torch.core.costmodel import TopologyCosts
from repro_torch.core.planner import AsyncPlanner, Planner
from repro_torch.core.profiler import LayerProfile
from repro_torch.core.scheduler import TopologyScheduler
from repro_torch.models import model as model_lib
from repro_torch.models.profiles import layer_profiles
from repro_torch.optim import Optimizer
from repro_torch.ps.async_mode import AsyncPSTrainer, AsyncRunLog
from repro_torch.ps.topology import TopologySchedule, as_topology_schedule
from repro_torch.ps.worker import PSTrainer
from repro_torch.runtime.replan import ReplanMixin, sequential_plan

__all__ = ["DynamicPSTrainer", "AsyncRescheduleEvent",
           "DynamicAsyncPSTrainer", "profiles_from_specs"]


def profiles_from_specs(specs, *, flops_per_param: float = 4.0
                        ) -> Tuple[LayerProfile, ...]:
    """Synthesize layer workloads from flat-buffer specs (models without
    an analytic profile zoo entry, e.g. the small CNN): bytes are the
    exact parameter payloads, FLOPs a uniform multiple of the parameter
    count — enough structure for per-worker *relative* planning."""
    return tuple(LayerProfile(name=f"layer{l}", param_bytes=s.total * 4.0,
                              flops_fwd=flops_per_param * s.total)
                 for l, s in enumerate(specs))


@dataclasses.dataclass
class DynamicPSTrainer(ReplanMixin):
    """Topology-epoch re-planning trainer around :class:`PSTrainer` (sync).

    ``topology`` may be a static :class:`PSTopology` or a
    :class:`TopologySchedule`; its ``num_workers`` must equal the process
    group's size (one synchronous worker per rank, and workers cannot
    join or leave mid-run).

    ``cost_source="measured"`` times the per-layer applies on this rank's
    device (``repro_torch.runtime.measure``) every ``remeasure_every``
    topology epochs and projects the timings onto each worker by
    compute-rate scaling: the measured vectors are taken to describe a
    worker running at the fleet's fastest rate ``f_max``, so worker *w*
    sees them scaled by ``f_max / worker_flops[w]`` while pt/gt/Δt still
    come from its own links.
    """

    cfg: ArchConfig
    optimizer: Optimizer
    topology: Any                  # PSTopology | TopologySchedule
    steps_per_epoch: int
    input_shape: InputShape
    device: Any
    group: Optional[Any] = None
    strategy: str = "dynacomm"
    cost_source: str = "analytic"          # "analytic" | "measured"
    measure_iters: int = 3
    measure_warmup: int = 1
    remeasure_every: int = 1      # epochs between fc/bc re-measurements;
                                  # 0 = measure once
    zero3: bool = False
    aux_weight: float = 0.01
    compressor: Optional[Any] = None
    async_planning: bool = False  # pre-plan epoch e+1 in e's idle window
    plan_cache_size: int = 256    # memoized decisions kept (LRU)

    UNIT = "segments"

    def __post_init__(self):
        self._init_replan(functools.partial(TopologyScheduler,
                                            mode="consensus"))
        self.topology: TopologySchedule = as_topology_schedule(self.topology)
        self._profiles = layer_profiles(self.cfg, self.input_shape)
        self.base = PSTrainer(
            cfg=self.cfg, plan=sequential_plan(
                model_lib.num_sched_layers(self.cfg)),
            optimizer=self.optimizer, topology=self.topology.topology_at(0),
            device=self.device, group=self.group, zero3=self.zero3,
            aux_weight=self.aux_weight, compressor=self.compressor)
        self.device = self.base.device
        self.compressor = self.base.compressor   # "none" normalized away

    def costs_for_epoch(self, epoch: int, state=None, batch=None, *,
                        remeasure: bool = False) -> TopologyCosts:
        """The active topology's per-worker cost projection.

        Analytic by default.  With ``cost_source="measured"``, fc/bc come
        from measured timings rescaled per worker (see the class
        docstring); ``state``/``batch`` are required whenever a (re-)
        measurement is due — callers that only want the cached projection
        (timeline views, tests) can omit them.
        """
        topo = self.topology.topology_at(epoch)
        if self.cost_source == "analytic":
            return topo.topology_costs(self._profiles,
                                       compressor=self.compressor)
        fc, bc = self.measured_times(epoch, state, batch, force=remeasure)
        return topo.topology_costs_measured(
            self._profiles, fc=fc, bc=bc, compressor=self.compressor)

    def timeline(self, epoch: Optional[int] = None):
        """Per-worker timeline of the *active* plan against an epoch's
        topology costs (current epoch by default)."""
        from repro_torch.core.buckets import decision_from_plan
        from repro_torch.core.simulator import simulate_ps_iteration
        if self._plan is None:
            raise ValueError("no active plan yet — run at least one step")
        epoch = self.epoch if epoch is None else epoch
        return simulate_ps_iteration(self.costs_for_epoch(epoch),
                                     decision_from_plan(self._plan))

    def replan_timeline(self):
        """Re-planned vs frozen-epoch-0-plan makespans across the epochs
        re-scheduled so far (:func:`core.simulator.simulate_ps_replan`) —
        the stale-plan penalty this trainer exists to reclaim."""
        from repro_torch.core.buckets import decision_from_plan
        from repro_torch.core.simulator import simulate_ps_replan
        if not self.events:
            raise ValueError("no reschedule events yet")
        by_epoch = {e.epoch: e.plan for e in self.events}
        epochs = sorted(by_epoch)
        costs = [self.costs_for_epoch(e) for e in epochs]
        decisions = [decision_from_plan(by_epoch[e]) for e in epochs]
        return simulate_ps_replan(costs, decisions)

    # ------------------------------------------------------------------
    # the loop's own parts (the loop itself lives in ReplanMixin)
    # ------------------------------------------------------------------

    def _plan_step(self, plan):
        # the PS step is its contained ZeRO step: cache that trainer's
        # shallow ``with_plan`` copy (it shares the flat layouts)
        return self.base._zero.with_plan(plan).step

    def _submit(self, costs: TopologyCosts) -> None:
        self.planner.submit_topology(costs, self.strategy)

    def _enter_epoch(self, epoch: int) -> None:
        # the data path is topology-independent; the base trainer's
        # accounting views (segment owners, transfer bytes, timelines)
        # should reflect the active fabric
        self.base.topology = self.topology.topology_at(epoch)


@dataclasses.dataclass(frozen=True)
class AsyncRescheduleEvent:
    """One per-worker re-planning pass of the asynchronous trainer."""

    epoch: int
    at_push: int                  # accepted pushes when the pass ran
    worker_plans: Tuple[BucketPlan, ...]
    plan_changed: bool            # any worker's plan differed from before
    scheduling_seconds: float
    overhead_hidden: bool         # fits the topology's min Δt + gt¹ window


class DynamicAsyncPSTrainer:
    """Topology-epoch re-planning around :class:`AsyncPSTrainer`.

    Asynchronous execution has no shared step to swap — each worker plans
    for itself — so a topology epoch here is a span of
    ``pushes_per_epoch`` *accepted* pushes (the async loop's notion of
    progress), and a re-plan swaps per-worker plans and simulated-clock
    costs into the resumable event loop between epochs.
    """

    def __init__(self, *, init_layers: Sequence[Any],
                 loss_fn: Callable[[List[Any], Dict[str, Any]], Any],
                 optimizer: Optimizer, topology: Any,
                 pushes_per_epoch: int, staleness: int = 1,
                 throttle: str = "reject", aggregate: bool = False,
                 strategy: str = "dynacomm",
                 profiles: Optional[Sequence[LayerProfile]] = None,
                 compressor: Optional[Any] = None,
                 async_planning: bool = False,
                 plan_cache_size: int = 256):
        if pushes_per_epoch < 1:
            raise ValueError(f"pushes_per_epoch must be >= 1, got "
                             f"{pushes_per_epoch}")
        self.topology: TopologySchedule = as_topology_schedule(topology)
        self.pushes_per_epoch = pushes_per_epoch
        self.strategy = strategy
        self.async_planning = async_planning
        planner_cls = AsyncPlanner if async_planning else Planner
        self.planner = planner_cls(cache_size=plan_cache_size)
        self.scheduler = TopologyScheduler(strategy=strategy,
                                           reschedule_every=1,
                                           mode="per-worker",
                                           planner=self.planner)
        self.events: List[AsyncRescheduleEvent] = []
        self._planned_epoch = 0
        # plan epoch 0 before building the trainer (it needs plans)
        self.trainer = AsyncPSTrainer(
            init_layers=init_layers, loss_fn=loss_fn, optimizer=optimizer,
            topology=self.topology.topology_at(0),
            plan=sequential_plan(len(init_layers)),
            staleness=staleness, throttle=throttle, aggregate=aggregate,
            compressor=compressor)
        self.compressor = self.trainer.compressor   # "none" normalized away
        self._profiles = (tuple(profiles) if profiles is not None
                          else profiles_from_specs(self.trainer.specs))
        self._worker_plans: Optional[Tuple[BucketPlan, ...]] = None
        self._replan(0)

    def _accepted(self) -> int:
        return 0 if self.trainer.log is None \
            else len(self.trainer.log.accepted)

    @property
    def epoch(self) -> int:
        """The current topology epoch — a pure function of *accepted*
        pushes, so progress is identical whether a caller drives one
        ``run_pushes(N)`` or N chunked ``run_pushes(1)`` calls."""
        return self._accepted() // self.pushes_per_epoch

    @property
    def worker_plans(self) -> Tuple[BucketPlan, ...]:
        return self._worker_plans

    @property
    def planner_stats(self) -> Dict[str, float]:
        """Memo-cache / async-planning counters (``PlannerStats``)."""
        return self.planner.stats.as_dict()

    def costs_for_epoch(self, epoch: int) -> TopologyCosts:
        return self.topology.topology_at(epoch).topology_costs(
            self._profiles, compressor=self.compressor)

    def _replan(self, epoch: int) -> None:
        costs = self.costs_for_epoch(epoch)
        L = costs.num_layers
        # reschedule_every=1: every decision_for_iteration call re-plans
        decisions = self.scheduler.decision_for_iteration(costs)
        plans = tuple(plan_from_decision(*d, L) for d in decisions)
        prev = self._worker_plans
        self._worker_plans = plans
        self.trainer.set_plans(plans, costs,
                               topology=self.topology.topology_at(epoch))
        self.events.append(AsyncRescheduleEvent(
            epoch=epoch, at_push=self._accepted(), worker_plans=plans,
            plan_changed=prev is not None and plans != prev,
            scheduling_seconds=self.scheduler.last_scheduling_seconds,
            overhead_hidden=self.scheduler.scheduling_overhead_hidden(
                costs)))
        if self.async_planning:
            # phase one: the async-PS cost projection is always analytic
            # (a pure function of the epoch), so epoch e+1's per-worker
            # DPs can run in this epoch's idle window
            self.planner.submit_topology(self.costs_for_epoch(epoch + 1),
                                         self.strategy)

    def run(self, num_epochs: int,
            batch_fn: Callable[[int, int], Any]) -> AsyncRunLog:
        """Run ``num_epochs`` topology epochs of ``pushes_per_epoch``
        accepted pushes each, re-planning per-worker on each boundary.
        Returns the cumulative :class:`AsyncRunLog`."""
        if num_epochs < 1:
            raise ValueError(f"num_epochs must be >= 1, got {num_epochs}")
        return self.run_pushes(num_epochs * self.pushes_per_epoch, batch_fn)

    def run_pushes(self, num_pushes: int,
                   batch_fn: Callable[[int, int], Any]) -> AsyncRunLog:
        """Run ``num_pushes`` more accepted pushes: a per-worker re-plan
        whenever the cumulative accepted count crosses a
        ``pushes_per_epoch`` boundary.  Epoch position is derived from
        the accepted count, never from how callers chunk their calls —
        ``run_pushes(1)`` six times re-plans at exactly the same pushes
        as one ``run_pushes(6)``."""
        if num_pushes < 1:
            raise ValueError(f"num_pushes must be >= 1, got {num_pushes}")
        log: Optional[AsyncRunLog] = None
        # account by *accepted* pushes, not requested chunks: under BSP
        # aggregation a run may commit a whole same-version group and
        # overshoot its chunk — re-reading the accepted count keeps the
        # total overshoot bounded by one group (W - 1) for the whole call
        target = self._accepted() + num_pushes
        while (accepted := self._accepted()) < target:
            epoch = accepted // self.pushes_per_epoch
            if epoch != self._planned_epoch:
                self._replan(epoch)
                self._planned_epoch = epoch
            # stop at the next epoch boundary so the re-plan lands there
            chunk = min(target - accepted,
                        self.pushes_per_epoch -
                        accepted % self.pushes_per_epoch)
            log = self.trainer.run(chunk, batch_fn,
                                   reset=self.trainer.log is None)
        return log

    def reset_loop(self) -> None:
        """Discard the event loop (a checkpoint restore rolled the server
        back): progress returns to zero accepted pushes and re-planning
        restarts from topology epoch 0 (recorded as a fresh reschedule
        event)."""
        self.trainer.reset_loop()
        self._planned_epoch = 0
        self._replan(0)
