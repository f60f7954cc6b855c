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
  of the trainer's ``with_plan`` copy is swapped in.  The loop — the
  measured-cost cache, the step cache, the ``RescheduleEvent`` bookkeeping
  and the Table I idle-window check — lives in
  :class:`repro_torch.runtime.replan.ReplanMixin`, shared with the
  PS-regime trainer (``repro_torch.ps.dynamic``); this trainer adds its
  cost projection and an optional drift detector.

Because the ZeRO state layout (one ``FlatSpec`` flat buffer per sched
layer) is plan-independent, states carry across plan swaps unchanged, and
the loss trajectory of a dynamic run is bitwise the one of running the
same plan sequence statically (``tests/test_torch_dynamic.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.costmodel import LayerCosts
from repro_torch.core.netmodel import NetworkSchedule, as_schedule
from repro_torch.core.profiler import _block, costs_from_profiles
from repro_torch.core.scheduler import DynaCommScheduler
from repro_torch.dist.zero import ZeroTrainer
from repro_torch.models import model as model_lib
from repro_torch.models.profiles import layer_profiles
from repro_torch.optim import Optimizer
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

    UNIT = "buckets"

    def __post_init__(self):
        self._init_replan(DynaCommScheduler)
        self.network: NetworkSchedule = as_schedule(self.network)
        Ls = model_lib.num_sched_layers(self.cfg)
        self.base = ZeroTrainer(cfg=self.cfg, plan=sequential_plan(Ls),
                                optimizer=self.optimizer, device=self.device,
                                group=self.group, zero3=self.zero3,
                                aux_weight=self.aux_weight)
        self.device = self.base.device
        self._drift_pending = False

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
        fc, bc = self.measured_times(epoch, state, batch, force=remeasure)
        pb = np.asarray(model_lib.sched_layer_bytes(self.cfg), np.float64)
        return LayerCosts(pt=net.transfer_time(pb), fc=fc, bc=bc,
                          gt=net.transfer_time(pb), dt=net.dt)

    # ------------------------------------------------------------------
    # the loop's own parts: the plan's step, the async submit, the drift
    # detector (the loop itself lives in ReplanMixin)
    # ------------------------------------------------------------------

    def _plan_step(self, plan):
        return self.base.with_plan(plan).step

    def _submit(self, costs: LayerCosts) -> None:
        self.planner.submit(costs, self.strategy)

    def _drift_due(self) -> bool:
        """The detector's verdict of the last step (then cleared)."""
        drift, self._drift_pending = self._drift_pending, False
        return drift

    def _run_step(self, state, batch):
        """The active plan's step; with a ``drift_detector`` the step's
        time (the clock stops after the device) feeds it, and a
        persistent shift re-plans from the next step."""
        if self.drift_detector is None:
            return self._step_fn(state, batch)
        t0 = time.perf_counter()
        new_state, loss = self._step_fn(state, batch)
        _block(loss)
        if self.drift_detector.update(time.perf_counter() - t0):
            self._drift_pending = True
        return new_state, loss

    def loop_state(self) -> Dict[str, np.ndarray]:
        """The dynamic-loop bookkeeping as a checkpointable tree, with
        the drift detector's extras."""
        return super().loop_state(extra_meta={
            "drift_pending": self._drift_pending,
            "drift_detector": (self.drift_detector.state_dict()
                               if self.drift_detector is not None and
                               hasattr(self.drift_detector, "state_dict")
                               else None)})

    def restore_loop_state(self, path: str) -> Dict[str, Any]:
        meta = super().restore_loop_state(path)
        self._drift_pending = bool(meta.get("drift_pending", False))
        det_state = meta.get("drift_detector")
        if det_state is not None and self.drift_detector is not None and \
                hasattr(self.drift_detector, "load_state_dict"):
            self.drift_detector.load_state_dict(det_state)
        return meta
