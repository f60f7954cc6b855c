"""Drive a built runtime through the conformance passes.

``verify_runtime(config)`` is the engine behind
``python -m repro_torch.analysis verify``: it builds the runtime via
:func:`repro_torch.runtime.build_runtime`, runs it, records the
collectives of the windows that matter with
:func:`~repro_torch.analysis.trace.record_collectives` (the port has no
compiled HLO to read), and checks

* the first executed step's trace against the active ``BucketPlan`` +
  ``FlatSpec`` byte math
  (:func:`~repro_torch.analysis.conformance.verify_schedule`); the
  dynamic regimes' step cache keeps each plan's first-step trace;
* the step cache: one first use per distinct plan
  (:func:`~repro_torch.analysis.conformance.verify_cache`);
* the compressed wire-byte accounting, exact to the integer
  (:func:`~repro_torch.analysis.conformance.verify_wire_model`, and for
  the event-loop regimes the per-worker ledger decomposition of
  :func:`~repro_torch.analysis.conformance.verify_push_ledger`);
* that windows with no scheduled communication (the local step, the
  async trainers' gradient computation, each pipeline stage's forward and
  backward) run zero cross-rank collectives.

A recording window covers the step or computation it checks and nothing
else: outside it, a checkpoint's ``ZeroTrainer.full_flat`` all-gathers
at world >= 2 and would read as a stray.

This module imports torch (via ``repro_torch.runtime``); the CLI imports
it lazily so ``lint`` stays torch-free.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from repro_torch.analysis.conformance import (segment_wire_bytes,
                                              verify_cache,
                                              verify_fleet_membership,
                                              verify_no_collectives,
                                              verify_push_ledger,
                                              verify_schedule,
                                              verify_wire_model)
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.trace import record_collectives

__all__ = ["verify_runtime"]


def verify_runtime(config: Any, *, steps: Optional[int] = None,
                   device: Any = None
                   ) -> Tuple[List[Finding], Dict[str, Any]]:
    """Verify one ``RuntimeConfig``; returns ``(findings, info)``.

    ``steps`` overrides how many units of progress to run (static regimes
    default to one step, the recorded one; dynamic regimes to one step
    past the first re-plan boundary; async regimes to a couple of
    committed pushes).  ``device`` is the runtime's (``None``: the
    current CUDA device, raising without one); the process group is the
    caller's when one is initialised, else a world-1 group.
    """
    from repro_torch.runtime import build_runtime
    rt = build_runtime(config, device=device)
    regime = config.runtime
    if regime == "local":
        return _verify_local(rt)
    if regime in ("zero", "ps"):
        return _verify_static(rt, config, steps)
    if regime in ("dynamic", "dynamic-ps"):
        return _verify_dynamic(rt, config, steps)
    if regime in ("ps-async", "dynamic-ps-async"):
        return _verify_async(rt, config, regime, steps)
    if regime == "fleet-async":
        return _verify_fleet(rt, config, steps)
    if regime == "pipeline":
        return _verify_pipeline(rt, config, steps)
    raise ValueError(f"no conformance driver for runtime {regime!r}")


def _info(regime: str, **extra: Any) -> Dict[str, Any]:
    return {"runtime": regime, **extra}


def _plan_obj(plan: Any) -> Dict[str, Any]:
    return {"forward": [list(b) for b in plan.forward],
            "backward": [list(b) for b in plan.backward]}


def _records(trace: Any) -> List[List[Any]]:
    """A window's collectives as ``[kind, operand bytes]`` pairs (the
    ``collectives`` entry of ``info``, which the reference lacks)."""
    return [[r.kind, r.bytes] for r in trace]


def _grad_trace(trainer: Any, rt: Any) -> list:
    """The collectives of one gradient computation of an async trainer at
    its head parameters (the computation every accepted push runs)."""
    batch = {k: v.to(trainer.device) for k, v in rt._batch_fn(0).items()}
    with record_collectives() as trace:
        trainer._grad_fn(trainer.layer_params(), batch)
    return trace


def _verify_local(rt: Any) -> Tuple[List[Finding], Dict[str, Any]]:
    with record_collectives() as trace:
        rt.fit(1)
    findings = verify_no_collectives(trace, context="local step")
    return findings, _info("local", checked=["no-collectives"],
                           collectives={"step": _records(trace)})


def _verify_static(rt: Any, config: Any, steps: Optional[int]
                   ) -> Tuple[List[Finding], Dict[str, Any]]:
    tr = rt.trainer
    n = steps if steps is not None else 1
    if n < 1:
        raise ValueError(f"the schedule check records a step: steps must "
                         f"be >= 1, got {n}")
    with record_collectives() as trace:
        rt.fit(1)
    compressor = getattr(tr, "compressor", None)
    zero3 = config.execution.zero3
    findings = verify_schedule(trace, rt.plan, tr.specs,
                               compressor=compressor, zero3=zero3,
                               context=f"{config.runtime} step")
    # ledger audit over a short run: the adapter's fleet-wide push wire
    # accounting must equal steps x workers x the independent per-segment
    # byte model
    rt.fit(n - 1)
    workers = tr.topology.num_workers if hasattr(tr, "topology") \
        else tr.axis_size
    expected_wire = n * workers * sum(
        segment_wire_bytes(tr.specs, b, compressor)
        for b in rt.plan.backward)
    recorded = rt.ledger["push_wire_bytes"]
    if recorded != expected_wire:
        findings.append(Finding(
            code="SCHED-LEDGER",
            message=f"runtime ledger records {recorded} push wire bytes "
                    f"over {n} step(s) x {workers} worker(s); the "
                    f"independent byte model gives {expected_wire}",
            detail={"recorded": recorded, "expected": expected_wire,
                    "steps": n, "workers": workers}))
    return findings, _info(
        config.runtime, plan=_plan_obj(rt.plan), steps_run=n,
        compression=getattr(compressor, "scheme", "none")
        if compressor else "none",
        checked=["schedule", "wire-model", "ledger"],
        collectives={"step": _records(trace)})


def _verify_dynamic(rt: Any, config: Any, steps: Optional[int]
                    ) -> Tuple[List[Finding], Dict[str, Any]]:
    # run one step past the first re-plan boundary so the cache holds at
    # least one (usually two) plans, each with its first step's trace
    n = steps if steps is not None else config.schedule.reschedule_every + 1
    rt.fit(n)
    tr = rt.trainer
    base = tr.base
    compressor = getattr(tr, "compressor", None)
    zero3 = config.execution.zero3
    findings = verify_cache(tr._cache, zero3=zero3,
                            context=f"{config.runtime} cache")
    for i, plan in enumerate(tr.plans_seen):
        findings.extend(verify_schedule(
            tr._cache.trace_of(plan), plan, base.specs,
            compressor=compressor, zero3=zero3,
            context=f"{config.runtime} plan {i}"))
    return findings, _info(
        config.runtime, steps_run=n, plans_seen=len(tr.plans_seen),
        traces=tr.traces, cache_hits=tr.cache_hits,
        compression=getattr(compressor, "scheme", "none")
        if compressor else "none",
        checked=["schedule", "cache", "wire-model"],
        plans=[_plan_obj(p) for p in tr.plans_seen],
        collectives={f"plan {i}": _records(tr._cache.trace_of(p))
                     for i, p in enumerate(tr.plans_seen)})


def _verify_async(rt: Any, config: Any, regime: str, steps: Optional[int]
                  ) -> Tuple[List[Finding], Dict[str, Any]]:
    async_tr = rt.trainer if regime == "ps-async" else rt.trainer.trainer
    # stay inside the first plan epoch so the per-worker ledger
    # decomposition runs against a single plan sequence per worker
    n = steps if steps is not None else 2
    if regime == "dynamic-ps-async":
        n = min(n, config.schedule.reschedule_every)
    rt.fit(n)

    # the async regimes communicate through explicit server messages;
    # their gradient computation must run zero collectives
    grad = _grad_trace(async_tr, rt)
    findings = verify_no_collectives(grad, context=f"{regime} grad")

    specs = async_tr.specs
    compressor = async_tr.compressor
    plans = async_tr.plans
    if compressor is not None:
        for plan in dict.fromkeys(plans):
            findings.extend(verify_wire_model(specs, plan, compressor,
                                              context=f"{regime} plan"))
    findings.extend(verify_push_ledger(
        async_tr.server.ledger, dict(enumerate(plans)), specs, compressor,
        context=f"{regime} ledger"))
    return findings, _info(
        regime, pushes_run=n, workers=len(plans),
        compression=getattr(compressor, "scheme", "none")
        if compressor else "none",
        checked=["no-collectives", "wire-model", "push-ledger"],
        collectives={"grad": _records(grad)})


def _verify_pipeline(rt: Any, config: Any, steps: Optional[int]
                     ) -> Tuple[List[Finding], Dict[str, Any]]:
    tr = rt.trainer
    n = steps if steps is not None else 1
    rt.fit(n)

    # each stage's forward and backward must be collective-free:
    # inter-stage bytes move only through the explicit boundary buffers
    # the ledger accounts
    findings: List[Finding] = []
    windows: Dict[str, List[List[Any]]] = {}
    batch = rt._batch_fn(0)
    for s, (fwd, bwd) in enumerate(tr.stage_traces(rt._state, batch)):
        for phase, trace in (("forward", fwd), ("backward", bwd)):
            windows[f"stage {s} {phase}"] = _records(trace)
            findings.extend(verify_no_collectives(
                trace, context=f"pipeline stage {s} {phase}"))

    # ledger audit: boundary bytes must equal the independent byte model
    # (per step: M activation flats down + M grad flats up per boundary,
    # plus the tied-embedding flat to/from the head stage)
    S, M = tr.num_stages, tr.num_microbatches
    act = tr.activation_bytes()
    embed_bytes = tr.specs[0].total * 4 if S > 1 else 0
    expected_pull = n * (M * sum(act) + embed_bytes)
    expected_push = n * (M * sum(act) + M * embed_bytes)
    led = rt.ledger
    for direction, expected in (("pull", expected_pull),
                                ("push", expected_push)):
        recorded = led[f"{direction}_bytes"]
        if recorded != expected:
            findings.append(Finding(
                code="PIPE-LEDGER",
                message=f"pipeline ledger records {recorded} {direction} "
                        f"bytes over {n} step(s); the boundary byte model "
                        f"gives {expected}",
                detail={"recorded": recorded, "expected": expected,
                        "steps": n, "stages": S, "microbatches": M}))

    # partition sanity + transfer-plan optimality vs the whole-tensor
    # baseline (the DP can never lose to a feasible decision)
    part = tr.partition
    if abs(max(part.loads) - part.bottleneck) > 1e-9 * max(part.bottleneck,
                                                           1.0):
        findings.append(Finding(
            code="PIPE-PARTITION",
            message=f"partition bottleneck {part.bottleneck} is not the "
                    f"max stage load {max(part.loads)}",
            detail=part.as_dict()))
    plans = tr.transfer_plans() or []
    for p in plans:
        if p.fwd_time > p.whole_fwd_time + 1e-12 or \
                p.bwd_time > p.whole_bwd_time + 1e-12:
            findings.append(Finding(
                code="PIPE-TRANSFER",
                message=f"boundary {p.boundary}: segmented transfer "
                        f"({p.fwd_time + p.bwd_time:.6f}s) loses to the "
                        f"whole-tensor baseline "
                        f"({p.whole_fwd_time + p.whole_bwd_time:.6f}s)",
                detail={"boundary": p.boundary,
                        "segmented": p.fwd_time + p.bwd_time,
                        "whole": p.whole_fwd_time + p.whole_bwd_time}))
    timeline = tr.timeline()
    return findings, _info(
        "pipeline", steps_run=n, stages=S, microbatches=M,
        schedule=tr.schedule_name, partition=part.as_dict(),
        boundary_speedups=[p.speedup for p in plans],
        bubble_fraction=(timeline.bubble_fraction
                         if timeline is not None else None),
        checked=["no-collectives", "ledger", "partition", "transfer-plans"],
        collectives=windows)


def _verify_fleet(rt: Any, config: Any, steps: Optional[int]
                  ) -> Tuple[List[Finding], Dict[str, Any]]:
    tr = rt.trainer
    # run far enough to fire the scripted membership events (the ledger
    # and membership audits are only interesting once churn happened)
    n = steps if steps is not None else 4
    rt.fit(n)

    grad = _grad_trace(tr, rt)
    findings = verify_no_collectives(grad, context="fleet-async grad")

    specs = tr.specs
    compressor = tr.compressor
    history = tr.push_history
    if compressor is not None:
        distinct = dict.fromkeys(p for entries in history.values()
                                 for p, _, _ in entries)
        for plan in distinct:
            findings.extend(verify_wire_model(specs, plan, compressor,
                                              context="fleet-async plan"))
    # the elastic form: each worker's ledger entry decomposes under its
    # own plan *history* (departed workers' entries close cleanly)
    findings.extend(verify_push_ledger(
        tr.server.ledger, history, specs, compressor,
        context="fleet-async ledger"))
    findings.extend(verify_fleet_membership(
        tr.log, tr.membership.joined_at, tr.membership.departed,
        staleness_bound=tr.staleness, context="fleet-async membership"))
    return findings, _info(
        "fleet-async", pushes_run=n, workers=tr.membership.num_active,
        replans=len(tr.replan_events),
        membership_events=len(tr.membership_events),
        compression=getattr(compressor, "scheme", "none")
        if compressor else "none",
        checked=["no-collectives", "wire-model", "push-ledger",
                 "fleet-membership"],
        collectives={"grad": _records(grad)})
