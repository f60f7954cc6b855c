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

Every re-plan records a reschedule event carrying the scheduling wall
time and the paper's Table I overhead-hidden check against the topology's
Δt + gt¹ idle window (the minimum over workers).  The asynchronous trainer
(the reference's ``DynamicAsyncPSTrainer``) waits for the async PS slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.buckets import plan_from_decision
from repro_torch.core.costmodel import TopologyCosts
from repro_torch.core.planner import AsyncPlanner, Planner
from repro_torch.core.profiler import LayerTimingHook
from repro_torch.core.scheduler import TopologyScheduler
from repro_torch.models import model as model_lib
from repro_torch.models.profiles import layer_profiles
from repro_torch.optim import Optimizer
from repro_torch.ps.topology import TopologySchedule, as_topology_schedule
from repro_torch.ps.worker import PSTrainer
from repro_torch.runtime.measure import measure_layer_times, measurement_due
from repro_torch.runtime.replan import ReplanMixin, sequential_plan

__all__ = ["DynamicPSTrainer"]


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

    def __post_init__(self):
        if self.steps_per_epoch < 1:
            raise ValueError(f"steps_per_epoch must be >= 1, got "
                             f"{self.steps_per_epoch}")
        if self.cost_source not in ("analytic", "measured"):
            raise ValueError(f"cost_source must be 'analytic' or 'measured', "
                             f"got {self.cost_source!r}")
        if self.remeasure_every < 0:
            raise ValueError(f"remeasure_every must be >= 0, got "
                             f"{self.remeasure_every}")
        self.topology: TopologySchedule = as_topology_schedule(self.topology)
        planner_cls = AsyncPlanner if self.async_planning else Planner
        self.planner = planner_cls(cache_size=self.plan_cache_size)
        self.scheduler = TopologyScheduler(
            strategy=self.strategy, reschedule_every=self.steps_per_epoch,
            mode="consensus", planner=self.planner)
        self.hook = LayerTimingHook(warmup=self.measure_warmup)
        self._profiles = layer_profiles(self.cfg, self.input_shape)
        self.base = PSTrainer(
            cfg=self.cfg, plan=sequential_plan(
                model_lib.num_sched_layers(self.cfg)),
            optimizer=self.optimizer, topology=self.topology.topology_at(0),
            device=self.device, group=self.group, zero3=self.zero3,
            aux_weight=self.aux_weight, compressor=self.compressor)
        self.device = self.base.device
        self.compressor = self.base.compressor   # "none" normalized away
        self._init_replan()
        self._step_idx = 0
        self._costs: Optional[TopologyCosts] = None
        self._measured_fc_bc: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._measured_epoch = -1

    # ------------------------------------------------------------------
    # state / introspection
    # ------------------------------------------------------------------

    def init_state(self, gen):
        return self.base.init_state(gen)

    @property
    def step_index(self) -> int:
        return self._step_idx

    @property
    def epoch(self) -> int:
        return self._step_idx // self.steps_per_epoch

    @property
    def planner_stats(self) -> Dict[str, float]:
        """Memo-cache / async-planning counters (``PlannerStats``)."""
        return self.planner.stats.as_dict()

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
        if measurement_due(self._measured_fc_bc, self._measured_epoch,
                           epoch, self.remeasure_every, force=remeasure):
            if state is None or batch is None:
                # view accessors may read the cached projection without
                # re-measuring; only the very first measurement has
                # nothing to serve
                if self._measured_fc_bc is None:
                    raise ValueError(
                        "cost_source='measured' needs state and batch for "
                        "the first measurement")
            else:
                measure_layer_times(self.base._zero, self.hook, state,
                                    batch, iters=self.measure_iters)
                Ls = self.base.num_layers
                self._measured_fc_bc = (self.hook.median("fc", Ls),
                                        self.hook.median("bc", Ls))
                self._measured_epoch = epoch
        fc, bc = self._measured_fc_bc
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
    # the dynamic loop
    # ------------------------------------------------------------------

    def _maybe_reschedule(self, i: int, state, batch) -> None:
        boundary = i % self.steps_per_epoch == 0
        if boundary:
            epoch = i // self.steps_per_epoch
            self._costs = self.costs_for_epoch(epoch, state, batch)
            # the data path is topology-independent; the base trainer's
            # accounting views (segment owners, transfer bytes, timelines)
            # should reflect the active fabric
            self.base.topology = self.topology.topology_at(epoch)
        decision = self.scheduler.decision_for_iteration(self._costs)
        # (``_step_fn is None`` off-boundary ⇒ loop state was just restored
        # from a checkpoint: rebuild the active plan's step, no event)
        if not boundary and self._step_fn is not None:
            return
        plan = plan_from_decision(*decision, self.base.num_layers)
        # the PS step is its contained ZeRO step: cache that trainer's
        # shallow ``with_plan`` copy (it shares the flat layouts)
        prev, retraced = self._activate_plan(
            plan, lambda: self.base._zero.with_plan(plan).step)
        if boundary:
            self._record_reschedule(
                step=i, epoch=i // self.steps_per_epoch, plan=plan,
                prev=prev, retraced=retraced, scheduler=self.scheduler,
                costs=self._costs)
        if boundary and self.async_planning and \
                self.cost_source == "analytic":
            # Phase one of the async protocol: epoch e+1's analytic
            # topology projection is a pure function of the epoch, so its
            # per-worker DPs can run now in the Δt + gt¹ idle window and
            # be collected at the next boundary.  Measured costs solve
            # inline (the planner's sync fallback).
            self.planner.submit_topology(
                self.costs_for_epoch(i // self.steps_per_epoch + 1),
                self.strategy)

    def step(self, state, batch):
        """One training step; re-plans on topology-epoch boundaries.
        Returns ``(new_state, mean_loss)``."""
        self._maybe_reschedule(self._step_idx, state, batch)
        new_state, loss = self._step_fn(state, batch)
        self._step_idx += 1
        return new_state, loss

    def run(self, state, batch_fn: Callable[[int], Any], num_steps: int, *,
            log_every: int = 0):
        """Drive ``num_steps`` steps with ``batch_fn(i) -> batch``.

        Returns ``(state, losses)`` with one float loss per step."""
        losses: List[float] = []
        for i in range(num_steps):
            state, loss = self.step(state, batch_fn(i))
            losses.append(float(loss))
            if log_every and (i + 1) % log_every == 0:
                f, b = (len(self._plan.forward), len(self._plan.backward))
                print(f"step {i + 1:4d}  epoch {self.epoch}  "
                      f"loss {losses[-1]:.4f}  segments {f}/{b}")
        return state, losses

    # ------------------------------------------------------------------
    # loop-state checkpointing — loop_state/save_loop_state come from
    # ReplanMixin unchanged; the restore re-points the base trainer's
    # accounting at the resumed epoch's topology
    # ------------------------------------------------------------------

    def restore_loop_state(self, path: str) -> None:
        self._restore_loop_common(path)
        self.base.topology = self.topology.topology_at(self.epoch)
