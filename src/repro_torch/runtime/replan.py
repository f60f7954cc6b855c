"""Run-time re-planning machinery shared by every dynamic trainer.

The port of the reference's ``runtime/replan.py``:

* :class:`PlanStepCache` — ``BucketPlan``-keyed step cache.  PyTorch runs
  the step eagerly, so nothing is traced or compiled per plan: the cache
  keeps, per distinct plan, the step of the trainer's ``with_plan(plan)``
  copy (a shallow copy sharing the flat layouts; the training state stays
  with the caller, so no second copy of weights, moments, residuals or
  gathered buffers is held) and the trace of the plan's first step
  (:func:`repro_torch.analysis.trace.record_collectives`: every
  collective it ran, with its operand bytes), where the reference keeps
  the compiled HLO; ``trace_of(plan)`` takes the place of ``hlo_text``
  and ``collective_counts(plan)`` of ``hlo_counts``.  ``traces`` counts
  first uses of a plan and ``hits`` plan swaps served from the cache, as
  the reference's compile misses and hits.  The reference's bounded HLO
  text retention (``hlo_retention`` / ``hlo_evictions``) is dropped: a
  trace is a few records a bucket;
* :class:`RescheduleEvent` — one scheduling pass (paper Table I
  bookkeeping: scheduling wall time + the overhead-hidden check against
  the Δt + gt¹ idle window); ``retraced`` is True on a plan's first
  activation, as in the reference;
* :class:`ReplanMixin` — the synchronous re-planning loop both dynamic
  trainers share (checks, planner, timing hook, measured-cost cache, the
  boundary pass, ``step`` and ``run``), and the loop-state checkpoint
  (keys and JSON meta equal the reference's);
* plan/event (de)serialization helpers used by that checkpoint.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import tracing
from repro_torch.analysis.trace import (CollectiveRecord, collective_counts,
                                        record_collectives)
from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
from repro_torch.core.buckets import BucketPlan, plan_from_decision
from repro_torch.core.planner import AsyncPlanner, Planner
from repro_torch.core.profiler import LayerTimingHook
from repro_torch.runtime.measure import measure_layer_times, measurement_due


def sequential_plan(num_layers: int) -> BucketPlan:
    """The whole model as one pull and one push bucket (always valid)."""
    return BucketPlan(forward=(tuple(range(num_layers)),),
                      backward=(tuple(range(num_layers - 1, -1, -1)),))


@dataclasses.dataclass(frozen=True)
class RescheduleEvent:
    """One scheduling pass (paper Table I bookkeeping)."""

    step: int                     # global step index at the epoch boundary
    epoch: int
    plan: BucketPlan              # plan active after this pass
    plan_changed: bool            # decision differed from the previous epoch
    retraced: bool                # False ⇒ step-cache hit (or no swap)
    scheduling_seconds: float     # wall time of the DP re-plan
    overhead_hidden: bool         # fits in the Δt + gt¹ idle window (Table I)
    trigger: str = "epoch"        # "epoch" boundary | "drift" detector


class PlanStepCache:
    """``BucketPlan``-keyed step cache (see module docstring)."""

    def __init__(self) -> None:
        self._steps: Dict[BucketPlan, Callable] = {}
        self._traces: Dict[BucketPlan, Tuple[CollectiveRecord, ...]] = {}
        self.traces = 0                # first uses of a plan
        self.hits = 0                  # plan *swaps* served from the cache

    @property
    def plans(self) -> Tuple[BucketPlan, ...]:
        return tuple(self._steps)

    def trace_of(self, plan: BucketPlan) -> Tuple[CollectiveRecord, ...]:
        """The collectives a cached plan's first step ran."""
        if plan not in self._traces:
            raise KeyError(f"plan {plan} has not run a step yet")
        return self._traces[plan]

    def collective_counts(self, plan: BucketPlan) -> Tuple[int, int]:
        """(#all-gathers, #reduce-scatters) of one step of a cached plan,
        as its first step ran them."""
        counts = collective_counts(self.trace_of(plan))
        return counts["all-gather"], counts["reduce-scatter"]

    def step_for(self, plan: BucketPlan, build_step: Callable[[], Callable],
                 *, count_hit: bool) -> Tuple[Callable, bool]:
        """The step for ``plan``, built via ``build_step()`` on a miss.
        Returns ``(step_fn, retraced)``; ``count_hit`` tells whether a
        cache hit is an actual plan swap (re-activating the unchanged plan
        after a restore is not)."""
        if plan in self._steps:
            if count_hit:
                self.hits += 1
            return self._steps[plan], False
        self.traces += 1
        step = build_step()

        def step_fn(state, batch):
            if plan in self._traces:
                return step(state, batch)
            with record_collectives() as trace:
                out = step(state, batch)
            self._traces[plan] = tuple(trace)
            return out

        self._steps[plan] = step_fn
        return step_fn, True


class ReplanMixin:
    """The synchronous re-planning loop of both dynamic trainers.

    A host is a dataclass with the loop's fields (``cfg``,
    ``steps_per_epoch``, ``strategy``, ``cost_source``, ``measure_iters``,
    ``measure_warmup``, ``remeasure_every``, ``aux_weight``,
    ``async_planning``, ``plan_cache_size``) that calls
    :meth:`_init_replan` first thing in its ``__post_init__``, then sets
    ``base`` (the trainer that owns the state layout) and ``device``.  It
    supplies what is its own: ``UNIT`` (the log line's word for a plan's
    pulls / pushes), ``costs_for_epoch`` (its cost projection),
    :meth:`_plan_step` and :meth:`_submit`, and may override
    :meth:`_enter_epoch`, :meth:`_drift_due` and :meth:`_run_step`.

    Per step the loop re-plans on an epoch boundary (or a drift verdict)
    — the costs, with a measurement where one is due, the decision, the
    plan swap through the :class:`PlanStepCache` and the
    ``RescheduleEvent`` with the paper's Table I
    ``scheduling_overhead_hidden`` check (the scheduler compares its last
    DP wall time against the costs' Δt + gt¹ idle window) — then runs the
    active plan's step.
    """

    def _init_replan(self, make_scheduler: Callable) -> None:
        """Check the loop's fields; build the planner, the scheduler
        (``make_scheduler(strategy=, reschedule_every=, planner=)``) and
        the timing hook; start the loop's bookkeeping."""
        if self.steps_per_epoch < 1:
            raise ValueError(f"steps_per_epoch must be >= 1, got "
                             f"{self.steps_per_epoch}")
        if self.cost_source not in ("analytic", "measured"):
            raise ValueError(f"cost_source must be 'analytic' or 'measured', "
                             f"got {self.cost_source!r}")
        if self.remeasure_every < 0:
            raise ValueError(f"remeasure_every must be >= 0, got "
                             f"{self.remeasure_every}")
        planner_cls = AsyncPlanner if self.async_planning else Planner
        self.planner = planner_cls(cache_size=self.plan_cache_size)
        self.scheduler = make_scheduler(
            strategy=self.strategy, reschedule_every=self.steps_per_epoch,
            planner=self.planner)
        self.hook = LayerTimingHook(warmup=self.measure_warmup)
        self.events: List[RescheduleEvent] = []
        self._cache = PlanStepCache()
        self._plan: Optional[BucketPlan] = None
        self._step_fn: Optional[Callable] = None
        self._step_idx = 0
        self._decision = None
        self._costs = None
        self._measured_fc_bc: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._measured_epoch = -1

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

    # -- introspection (uniform across trainers) -------------------------

    @property
    def plan(self) -> Optional[BucketPlan]:
        """The currently active bucket plan (None before the first step)."""
        return self._plan

    @property
    def plans_seen(self) -> Tuple[BucketPlan, ...]:
        return self._cache.plans

    @property
    def traces(self) -> int:
        """Step-cache misses (one per distinct plan)."""
        return self._cache.traces

    @property
    def cache_hits(self) -> int:
        """Plan swaps served from the step cache."""
        return self._cache.hits

    def collective_counts(self, plan: Optional[BucketPlan] = None
                          ) -> Tuple[int, int]:
        """(#all-gathers, #reduce-scatters) one step of a cached plan
        launched (the reference's ``hlo_counts``)."""
        return self._cache.collective_counts(
            self._plan if plan is None else plan)

    # -- measured costs --------------------------------------------------

    def measured_times(self, epoch: int, state=None, batch=None, *,
                       force: bool = False
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """The per-sched-layer ``(fc, bc)`` medians of the last
        measurement, re-measured on ``state`` / ``batch`` first where
        :func:`~repro_torch.runtime.measure.measurement_due` says so
        (``force``: a drift detector fired).  Without ``state`` / ``batch``
        the cache is served as it is (timeline views); only the very first
        measurement has nothing to serve."""
        if measurement_due(self._measured_fc_bc, self._measured_epoch,
                           epoch, self.remeasure_every, force=force):
            if state is not None and batch is not None:
                measure_layer_times(self.cfg, self.base, state, batch,
                                    self.hook, aux_weight=self.aux_weight,
                                    device=self.device,
                                    iters=self.measure_iters)
                Ls = self.base.num_layers
                self._measured_fc_bc = (self.hook.median("fc", Ls),
                                        self.hook.median("bc", Ls))
                self._measured_epoch = epoch
            elif self._measured_fc_bc is None:
                raise ValueError("cost_source='measured' needs state and "
                                 "batch for the first measurement")
        return self._measured_fc_bc

    # -- what a host may add to the loop ---------------------------------

    def _enter_epoch(self, epoch: int) -> None:
        """Called at every boundary, after the costs (and on restore)."""

    def _drift_due(self) -> bool:
        """Whether a drift verdict asks for a re-plan at this step."""
        return False

    def _run_step(self, state, batch):
        return self._step_fn(state, batch)

    # -- the loop ----------------------------------------------------------

    def _maybe_reschedule(self, i: int, state, batch) -> None:
        drift = self._drift_due()
        boundary = i % self.steps_per_epoch == 0 or drift
        with (tracing.span("runtime.replan") if boundary
              else contextlib.nullcontext()):
            self._reschedule(i, state, batch, boundary, drift)

    def _reschedule(self, i: int, state, batch, boundary: bool,
                    drift: bool) -> None:
        """The costs (a measurement where due), the decision and the
        plan swap of step ``i``."""
        epoch = i // self.steps_per_epoch
        if boundary:
            self._costs = self.costs_for_epoch(epoch, state, batch,
                                               remeasure=drift)
            self._enter_epoch(epoch)
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
            plan, lambda: self._plan_step(plan))
        self._decision = decision
        if boundary or changed:
            self.events.append(RescheduleEvent(
                step=i, epoch=epoch, plan=plan,
                plan_changed=prev is not None and plan != prev,
                retraced=retraced,
                scheduling_seconds=self.scheduler.last_scheduling_seconds,
                overhead_hidden=self.scheduler.scheduling_overhead_hidden(
                    self._costs),
                trigger="drift" if drift else "epoch"))
        if boundary and self.async_planning and \
                self.cost_source == "analytic":
            # Phase one of the async protocol: the analytic cost point of
            # epoch e+1 is a pure function of the epoch, so its DP can run
            # now, in this epoch's Δt + gt¹ idle window (Table I), and be
            # collected at the next boundary.  Measured costs aren't
            # predictable ahead of time — they solve inline (the planner's
            # sync fallback).
            self._submit(self.costs_for_epoch(epoch + 1, state, batch))

    def _activate_plan(self, plan: BucketPlan,
                       build_step: Callable[[], Callable]
                       ) -> Tuple[Optional[BucketPlan], bool]:
        """Make ``plan`` the active step if it differs from the current one
        (or none is active yet).  Returns ``(previous_plan, retraced)``."""
        prev = self._plan
        retraced = False
        if plan != prev or self._step_fn is None:
            self._step_fn, retraced = self._cache.step_for(
                plan, build_step, count_hit=plan != prev)
            self._plan = plan
        return prev, retraced

    def step(self, state, batch):
        """One training step; re-plans first where one is due.  Returns
        ``(new_state, mean_loss)``."""
        self._maybe_reschedule(self._step_idx, state, batch)
        new_state, loss = self._run_step(state, batch)
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
                      f"loss {losses[-1]:.4f}  {self.UNIT} {f}/{b}")
        return state, losses

    # -- (de)serialization for loop-state checkpointing -----------------

    @staticmethod
    def _plan_to_obj(plan: Optional[BucketPlan]):
        if plan is None:
            return None
        return {"forward": [list(b) for b in plan.forward],
                "backward": [list(b) for b in plan.backward]}

    @staticmethod
    def _plan_from_obj(obj) -> Optional[BucketPlan]:
        if obj is None:
            return None
        return BucketPlan(
            forward=tuple(tuple(b) for b in obj["forward"]),
            backward=tuple(tuple(b) for b in obj["backward"]))

    @classmethod
    def _events_to_obj(cls, events) -> List[Dict[str, Any]]:
        return [{
            "step": e.step, "epoch": e.epoch,
            "plan": cls._plan_to_obj(e.plan),
            "plan_changed": e.plan_changed, "retraced": e.retraced,
            "scheduling_seconds": e.scheduling_seconds,
            "overhead_hidden": e.overhead_hidden, "trigger": e.trigger,
        } for e in events]

    @classmethod
    def _events_from_obj(cls, obj) -> List[RescheduleEvent]:
        return [RescheduleEvent(
            step=e["step"], epoch=e["epoch"],
            plan=cls._plan_from_obj(e["plan"]),
            plan_changed=e["plan_changed"], retraced=e["retraced"],
            scheduling_seconds=e["scheduling_seconds"],
            overhead_hidden=e["overhead_hidden"],
            trigger=e.get("trigger", "epoch")) for e in obj]

    # -- loop-state checkpointing ----------------------------------------
    #
    # The *model* state is checkpointed separately; this captures the
    # re-planning bookkeeping — step/scheduler counters, active plan,
    # event history, measurement cache, planner caches — so a resumed run
    # replays the same plan sequence.  The restored plan's step is rebuilt
    # lazily on the first post-restore step (no scheduling event is
    # recorded).  A host adds its extras through ``extra_meta`` / the meta
    # dict ``restore_loop_state`` returns.

    def loop_state(self, *, extra_meta: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, np.ndarray]:
        """The re-planning loop bookkeeping as a checkpointable tree."""
        meta = {
            "scheduler": self.scheduler.state_dict(),
            "plan": self._plan_to_obj(self._plan),
            "events": self._events_to_obj(self.events),
            "measured_epoch": self._measured_epoch,
            "planner": self.planner.state_dict(),
        }
        if extra_meta:
            meta.update(extra_meta)
        state = {"step_idx": np.asarray(self._step_idx, np.int64),
                 "meta": np.asarray(json.dumps(meta))}
        if self._measured_fc_bc is not None:
            fc, bc = self._measured_fc_bc
            state["measured_fc"] = np.asarray(fc, np.float64)
            state["measured_bc"] = np.asarray(bc, np.float64)
        return state

    def save_loop_state(self, path: str) -> None:
        save_checkpoint(path, self.loop_state(), step=self._step_idx)

    def restore_loop_state(self, path: str) -> Dict[str, Any]:
        """Restore the loop state; returns the meta dict so the host can
        pick up its extras."""
        Ls = self.base.num_layers
        template: Dict[str, np.ndarray] = {
            "step_idx": np.zeros((), np.int64), "meta": np.asarray("")}
        if self.cost_source == "measured":
            with np.load(path) as probe:
                has_measured = "measured_fc" in probe.files
            if has_measured:       # absent ⇒ saved before 1st measurement
                template["measured_fc"] = np.zeros((Ls,), np.float64)
                template["measured_bc"] = np.zeros((Ls,), np.float64)
        tree, _ = load_checkpoint(path, template)
        meta = json.loads(str(tree["meta"]))
        self._step_idx = int(tree["step_idx"])
        self.scheduler.load_state_dict(dict(meta["scheduler"]))
        self._plan = self._plan_from_obj(meta["plan"])
        self._measured_epoch = int(meta.get("measured_epoch", -1))
        if "measured_fc" in tree:
            self._measured_fc_bc = (np.asarray(tree["measured_fc"]),
                                    np.asarray(tree["measured_bc"]))
        self.events = self._events_from_obj(meta["events"])
        if meta.get("planner") is not None:
            self.planner.load_state_dict(meta["planner"])
        self._step_fn = None       # rebuilt lazily on the next step
        self._costs = None
        self._decision = self.scheduler._decision
        self._enter_epoch(self.epoch)
        return meta
