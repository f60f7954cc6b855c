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
* :class:`ReplanMixin` — the swap-and-record loop body both trainers
  share, and the loop-state checkpoint (keys and JSON meta equal the
  reference's);
* plan/event (de)serialization helpers used by that checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analysis.trace import (CollectiveRecord, collective_counts,
                                        record_collectives)
from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
from repro_torch.core.buckets import BucketPlan


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
    """Shared plan-swap + event-record body of the dynamic trainers.

    A trainer calls :meth:`_init_replan` from its ``__post_init__``, then
    per scheduling pass :meth:`_activate_plan` (build-or-lookup, swap) and
    :meth:`_record_reschedule` (``RescheduleEvent`` with the paper's
    Table I ``scheduling_overhead_hidden`` check — the scheduler compares
    its last DP wall time against the costs' Δt + gt¹ idle window).
    """

    def _init_replan(self) -> None:
        self.events: List[RescheduleEvent] = []
        self._cache = PlanStepCache()
        self._plan: Optional[BucketPlan] = None
        self._step_fn: Optional[Callable] = None

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

    # -- the shared loop body -------------------------------------------

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

    def _record_reschedule(self, *, step: int, epoch: int, plan: BucketPlan,
                           prev: Optional[BucketPlan], retraced: bool,
                           scheduler, costs, trigger: str = "epoch") -> None:
        """Append the ``RescheduleEvent`` for one scheduling pass."""
        self.events.append(RescheduleEvent(
            step=step, epoch=epoch, plan=plan,
            plan_changed=prev is not None and plan != prev,
            retraced=retraced,
            scheduling_seconds=scheduler.last_scheduling_seconds,
            overhead_hidden=scheduler.scheduling_overhead_hidden(costs),
            trigger=trigger))

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

    # -- loop-state checkpointing (shared by both dynamic trainers) ------
    #
    # The *model* state is checkpointed separately; this captures the
    # re-planning bookkeeping — step/scheduler counters, active plan,
    # event history, measurement cache, planner caches — so a resumed run
    # replays the same plan sequence.  The restored plan's step is rebuilt
    # lazily on the first post-restore step (no scheduling event is
    # recorded).  Trainers expect the shared attribute set (scheduler,
    # _step_idx, cost_source, _measured_fc_bc, _measured_epoch,
    # base.num_layers) and add their extras through ``extra_meta`` / the
    # returned meta dict.

    def loop_state(self, *, extra_meta: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, np.ndarray]:
        """The re-planning loop bookkeeping as a checkpointable tree."""
        meta = {
            "scheduler": self.scheduler.state_dict(),
            "plan": self._plan_to_obj(self._plan),
            "events": self._events_to_obj(self.events),
            "measured_epoch": self._measured_epoch,
        }
        planner = getattr(self, "planner", None)
        if planner is not None:
            meta["planner"] = planner.state_dict()
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

    def _restore_loop_common(self, path: str) -> Dict[str, Any]:
        """Restore the shared loop state; returns the meta dict so the
        trainer can pick up its extras."""
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
        planner = getattr(self, "planner", None)
        if planner is not None and meta.get("planner") is not None:
            planner.load_state_dict(meta["planner"])
        self._step_fn = None       # rebuilt lazily on the next step
        self._costs = None
        return meta
