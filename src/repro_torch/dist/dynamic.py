"""Run-time dynamic re-scheduling for the bucketed ZeRO trainer.

This module closes the paper's run-time loop (Section IV): profiling →
DP decision → bucket plan → *live* plan swap, once per epoch.
``repro_torch.core`` decides, ``repro_torch.dist.zero`` executes, and
``DynamicTrainer`` is the trainer that connects them during training:

* per-sched-layer ``fc``/``bc`` come from *measured* timings of the
  per-layer applies on the trainer's device (``repro_torch.runtime.measure``:
  CUDA events on the card, the host clock on the CPU) or from the analytic
  profiles (deterministic; the default);
* ``pt``/``gt``/``Δt`` come from the *active* network model — a
  ``NetworkSchedule`` makes the network condition time-varying (e.g. the
  uplink dropping 10 Gbps → 1 Gbps at epoch k), which is what makes
  re-scheduling visible;
* on every epoch boundary the ``DynaCommScheduler`` re-plans through a
  memoising :class:`~repro_torch.core.planner.Planner`; when the decision
  changes, the plan is converted with ``plan_from_decision`` and the step
  of the trainer's ``with_plan`` copy is swapped in.  The step cache, the
  ``RescheduleEvent`` bookkeeping and the Table I idle-window check live in
  :class:`repro_torch.runtime.replan.ReplanMixin`, shared with the
  PS-regime trainer (``repro_torch.ps.dynamic``).

Because the ZeRO state layout (one ``FlatSpec`` flat buffer per sched
layer) is plan-independent, states carry across plan swaps unchanged, and
the loss trajectory of a dynamic run is bitwise the one of running the
same plan sequence statically (``tests/test_torch_dynamic.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.buckets import plan_from_decision
from repro_torch.core.costmodel import LayerCosts
from repro_torch.core.netmodel import NetworkSchedule, as_schedule
from repro_torch.core.planner import AsyncPlanner, Planner
from repro_torch.core.profiler import (LayerTimingHook, _block,
                                       costs_from_profiles)
from repro_torch.core.scheduler import Decision, DynaCommScheduler
from repro_torch.dist.zero import ZeroTrainer
from repro_torch.models import model as model_lib
from repro_torch.models.profiles import layer_profiles
from repro_torch.optim import Optimizer
from repro_torch.runtime.measure import measure_layer_times, measurement_due
from repro_torch.runtime.replan import ReplanMixin, sequential_plan

__all__ = ["DynamicTrainer"]


@dataclasses.dataclass
class DynamicTrainer(ReplanMixin):
    """Epoch-boundary re-scheduling trainer around :class:`ZeroTrainer`.

    ``network`` may be a static model or a :class:`NetworkSchedule`;
    ``cost_source`` picks deterministic analytic profiles (default) or
    measured per-layer timings for fc/bc.
    """

    cfg: ArchConfig
    optimizer: Optimizer
    network: Any
    steps_per_epoch: int
    device: Any
    group: Optional[Any] = None
    strategy: str = "dynacomm"
    cost_source: str = "analytic"          # "analytic" | "measured"
    input_shape: Optional[InputShape] = None
    compute_flops_per_s: Optional[float] = 1e12
    measure_iters: int = 3
    measure_warmup: int = 1
    remeasure_every: int = 1      # epochs between fc/bc re-measurements;
                                  # 0 = measure once
    drift_detector: Optional[Any] = None   # e.g. core.EwmaDriftDetector
    zero3: bool = False
    aux_weight: float = 0.01
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
        self.network: NetworkSchedule = as_schedule(self.network)
        planner_cls = AsyncPlanner if self.async_planning else Planner
        self.planner = planner_cls(cache_size=self.plan_cache_size)
        self.scheduler = DynaCommScheduler(strategy=self.strategy,
                                           reschedule_every=self.steps_per_epoch,
                                           planner=self.planner)
        self.hook = LayerTimingHook(warmup=self.measure_warmup)
        Ls = model_lib.num_sched_layers(self.cfg)
        self.base = ZeroTrainer(cfg=self.cfg, plan=sequential_plan(Ls),
                                optimizer=self.optimizer, device=self.device,
                                group=self.group, zero3=self.zero3,
                                aux_weight=self.aux_weight)
        self.device = self.base.device
        self._init_replan()
        self._step_idx = 0
        self._decision: Optional[Decision] = None
        self._costs: Optional[LayerCosts] = None
        self._measured_fc_bc: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._measured_epoch = -1
        self._drift_pending = False

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

    def timeline(self):
        """Per-phase timeline of the active plan against the most recent
        cost vectors (``None`` before the first step)."""
        from repro_torch.core.buckets import decision_from_plan
        from repro_torch.core.simulator import simulate_iteration
        if self._plan is None or self._costs is None:
            return None
        return simulate_iteration(self._costs,
                                  *decision_from_plan(self._plan))

    # ------------------------------------------------------------------
    # cost vectors
    # ------------------------------------------------------------------

    def _input_shape_for(self, batch) -> InputShape:
        if self.input_shape is not None:
            return self.input_shape
        if "tokens" not in batch:
            raise ValueError("cannot derive an InputShape from a batch "
                             "without 'tokens'; pass input_shape= explicitly")
        B, T = batch["tokens"].shape
        return InputShape("dynamic", int(T), int(B), "train")

    def costs_for_epoch(self, epoch: int, state, batch, *,
                        remeasure: bool = False) -> LayerCosts:
        """fc/bc from the configured source; pt/gt/Δt from the epoch's
        network model.

        With ``cost_source="measured"``, fc/bc are re-measured every
        ``remeasure_every`` re-schedule epochs (so *compute* drift is seen,
        not just network drift); ``remeasure=True`` forces a fresh
        measurement (the drift-detector path).
        """
        net = self.network.model_at(epoch)
        if self.cost_source == "analytic":
            return costs_from_profiles(
                layer_profiles(self.cfg, self._input_shape_for(batch)),
                net=net, compute_flops_per_s=self.compute_flops_per_s)
        if measurement_due(self._measured_fc_bc, self._measured_epoch,
                           epoch, self.remeasure_every, force=remeasure):
            measured = self.measure_costs(state, batch, net=net)
            self._measured_fc_bc = (measured.fc, measured.bc)
            self._measured_epoch = epoch
            return measured
        fc, bc = self._measured_fc_bc
        pb = np.asarray(model_lib.sched_layer_bytes(self.cfg), np.float64)
        return LayerCosts(pt=net.transfer_time(pb), fc=fc, bc=bc,
                          gt=net.transfer_time(pb), dt=net.dt)

    def measure_costs(self, state, batch, *, net=None) -> LayerCosts:
        """Measured per-sched-layer fc/bc via
        :func:`repro_torch.runtime.measure.measure_layer_times`; pt/gt/Δt
        stay analytic from ``net``."""
        net = self.network.model_at(self.epoch) if net is None else net
        measure_layer_times(self.base, self.hook, state, batch,
                            iters=self.measure_iters)
        pb = np.asarray(model_lib.sched_layer_bytes(self.cfg), np.float64)
        return self.hook.costs(param_bytes=pb, net=net)

    # ------------------------------------------------------------------
    # the dynamic loop
    # ------------------------------------------------------------------

    def _maybe_reschedule(self, i: int, state, batch) -> None:
        drift = self._drift_pending
        self._drift_pending = False
        boundary = i % self.steps_per_epoch == 0 or drift
        with (tracing.span("runtime.replan") if boundary
              else contextlib.nullcontext()):
            self._reschedule(i, state, batch, boundary, drift)

    def _reschedule(self, i: int, state, batch, boundary: bool,
                    drift: bool) -> None:
        """The costs (a measurement where due), the decision and the
        plan swap of step ``i``."""
        if boundary:
            self._costs = self.costs_for_epoch(i // self.steps_per_epoch,
                                               state, batch, remeasure=drift)
            if drift:
                self.scheduler.invalidate()
        decision = self.scheduler.decision_for_iteration(self._costs)
        changed = decision != self._decision
        # (``_step_fn is None`` off-boundary ⇒ loop state was just restored
        # from a checkpoint: rebuild the active plan's step, no event)
        if not boundary and not changed and self._step_fn is not None:
            return
        plan = plan_from_decision(*decision, self.base.num_layers)
        prev, retraced = self._activate_plan(
            plan, lambda: self.base.with_plan(plan).step)
        self._decision = decision
        if boundary or changed:
            self._record_reschedule(
                step=i, epoch=i // self.steps_per_epoch, plan=plan,
                prev=prev, retraced=retraced, scheduler=self.scheduler,
                costs=self._costs, trigger="drift" if drift else "epoch")
        if boundary and self.async_planning and \
                self.cost_source == "analytic":
            # Phase one of the async protocol: the analytic cost point of
            # epoch e+1 is a pure function of the epoch, so its DP can run
            # now, in this epoch's Δt + gt¹ idle window (Table I), and be
            # collected at the next boundary.  Measured costs aren't
            # predictable ahead of time — they solve inline (the planner's
            # sync fallback).
            nxt = i // self.steps_per_epoch + 1
            self.planner.submit(self.costs_for_epoch(nxt, state, batch),
                                self.strategy)

    def step(self, state, batch):
        """One training step; re-plans on epoch boundaries — and, when a
        ``drift_detector`` is attached, whenever *observed* step times
        shift persistently (the detector's verdict applies from the next
        step).  Returns ``(new_state, mean_loss)``."""
        self._maybe_reschedule(self._step_idx, state, batch)
        if self.drift_detector is None:
            new_state, loss = self._step_fn(state, batch)
        else:
            t0 = time.perf_counter()
            new_state, loss = self._step_fn(state, batch)
            _block(loss)               # the clock stops after the device
            if self.drift_detector.update(time.perf_counter() - t0):
                self._drift_pending = True
        self._step_idx += 1
        return new_state, loss

    # ------------------------------------------------------------------
    # loop-state checkpointing — the shared body lives in ReplanMixin;
    # this trainer adds the drift-detector extras
    # ------------------------------------------------------------------

    def loop_state(self) -> Dict[str, np.ndarray]:
        """The dynamic-loop bookkeeping as a checkpointable tree."""
        return super().loop_state(extra_meta={
            "drift_pending": self._drift_pending,
            "drift_detector": (self.drift_detector.state_dict()
                               if self.drift_detector is not None and
                               hasattr(self.drift_detector, "state_dict")
                               else None)})

    def restore_loop_state(self, path: str) -> None:
        meta = self._restore_loop_common(path)
        self._decision = self.scheduler._decision
        self._drift_pending = bool(meta.get("drift_pending", False))
        det_state = meta.get("drift_detector")
        if det_state is not None and self.drift_detector is not None and \
                hasattr(self.drift_detector, "load_state_dict"):
            self.drift_detector.load_state_dict(det_state)

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
                      f"loss {losses[-1]:.4f}  buckets {f}/{b}")
        return state, losses
