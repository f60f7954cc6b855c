"""Schedule-conformance verification over recorded traces (layer 1).

DynaComm's structural claim is that the running step carries *exactly*
the collectives the DP decision prescribes: one all-gather (parameter
pull) per forward bucket, one reduce-scatter (gradient push) per
backward bucket, each moving exactly the ``FlatSpec`` flat-buffer bytes
— and nothing else crossing ranks.  :func:`verify_schedule` checks the
trace of one executed step
(:func:`~repro_torch.analysis.trace.record_collectives`) against a
:class:`~repro_torch.core.buckets.BucketPlan` and the trainer's specs;
:func:`verify_cache` audits a
:class:`~repro_torch.runtime.replan.PlanStepCache` (one first-use trace
per distinct plan); :func:`verify_wire_model` and
:func:`verify_push_ledger` prove the compressed wire-byte accounting
exact against an *independent* reimplementation of the compressor byte
formulas.

Expected operand bytes (the reference's, pinned against XLA's
partitioner by its golden fixtures; the port's collectives are laid out
byte for byte the same):

* all-gather of forward bucket ``b`` operates on the concatenated local
  shards — ``4 * sum(padded_l // axis_size for l in b)`` bytes;
* reduce-scatter of backward bucket ``b`` operates on the stacked
  ``(axis_size, shard)`` gradient — ``4 * sum(padded_l for l in b)``
  bytes (compressed pushes roundtrip to f32 *before* the collective, so
  the operands stay f32 — wire compression is verified at the byte-model
  layer instead);
* one scalar all-reduce (the loss mean at world >= 2) is tolerated below
  ``small_collective_bytes``.

Unlike the reference, the count and byte checks run at any world size:
XLA elides a world-1 collective, but the port's eager calls always run
(on the card's world-1 NCCL group the bucket collectives still launch),
so a step that records none is a finding.

Pure stdlib + :mod:`repro_torch.analysis.trace`'s summaries: no torch
import, so conformance over hand-built traces runs anywhere.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.trace import (COLLECTIVES, CollectiveRecord,
                                        collective_summary)

__all__ = [
    "expected_ag_bytes", "expected_rs_bytes", "independent_wire_bytes",
    "segment_wire_bytes", "verify_schedule", "verify_no_collectives",
    "verify_cache", "verify_wire_model", "verify_push_ledger",
    "verify_fleet_membership",
]

# Int8 wire layout: 1 byte/element + one fp32 scale per quantization
# tile.  Deliberately NOT imported from
# repro_torch.kernels.compress.ops.TILE: this module re-derives the wire
# math independently of the code under audit (a test pins the two
# constants to each other).
INT8_TILE = 512

#: Collectives at or below this operand size are treated as scalar-loss
#: reductions (the mean of the per-rank loss) and not flagged.
SMALL_COLLECTIVE_BYTES = 1024

#: kinds the schedule accounts for; anything else in a step is stray
_SCHEDULED = ("all-gather", "reduce-scatter", "all-reduce")

Trace = Sequence[CollectiveRecord]


# ---------------------------------------------------------------------------
# expected byte math
# ---------------------------------------------------------------------------

def expected_ag_bytes(specs: Sequence[Any], plan: Any, *,
                      zero3: bool = False) -> List[int]:
    """Expected all-gather operand bytes, one entry per gather.

    With ``zero3`` every backward bucket containing a middle layer
    re-pulls its full bucket (one extra gather of the same byte shape as
    a forward gather of that bucket)."""
    def bucket_bytes(bucket):
        return 4 * sum(specs[l].padded // specs[l].axis_size for l in bucket)

    out = [bucket_bytes(b) for b in plan.forward]
    if zero3:
        num_layers = len(specs)
        out += [bucket_bytes(b) for b in plan.backward
                if any(0 < l < num_layers - 1 for l in b)]
    return out


def expected_rs_bytes(specs: Sequence[Any], plan: Any) -> List[int]:
    """Expected reduce-scatter operand bytes, one entry per backward
    bucket (the stacked ``(axis_size, shard)`` gradient)."""
    return [4 * sum(specs[l].padded for l in b) for b in plan.backward]


def independent_wire_bytes(compressor: Optional[Any],
                           logical_bytes: float) -> float:
    """Wire bytes of one fp32 buffer, re-derived from the published
    formulas rather than ``compressor.wire_bytes`` (which is the code
    under audit)."""
    scheme = getattr(compressor, "scheme", "none") if compressor else "none"
    if scheme == "none":
        return float(logical_bytes)
    n = logical_bytes / 4.0
    if scheme == "int8":
        return n + 4.0 * math.ceil(n / INT8_TILE)
    if scheme == "topk":
        return 8.0 * max(1.0, math.ceil(compressor.fraction * n))
    raise ValueError(f"unknown compression scheme {scheme!r}")


def segment_wire_bytes(specs: Sequence[Any], bucket: Sequence[int],
                       compressor: Optional[Any]) -> int:
    """Wire bytes of one push segment under the independent byte model
    (mirrors ``PSServer.push_wire_bytes``: per-layer payloads plus one
    per-segment header, rounded once)."""
    overhead = getattr(compressor, "segment_overhead_bytes", 0.0) \
        if compressor else 0.0
    return int(round(sum(independent_wire_bytes(compressor,
                                                specs[l].total * 4)
                         for l in bucket) + overhead))


# ---------------------------------------------------------------------------
# conformance passes
# ---------------------------------------------------------------------------

def _multiset_diff(expected: Sequence[int], observed: Sequence[int]
                   ) -> Tuple[List[int], List[int]]:
    """(missing-from-observed, unexpected-in-observed)."""
    exp, obs = Counter(expected), Counter(observed)
    missing = sorted((exp - obs).elements())
    extra = sorted((obs - exp).elements())
    return missing, extra


def verify_schedule(trace: Trace, plan: Any, specs: Sequence[Any], *,
                    compressor: Optional[Any] = None, zero3: bool = False,
                    small_collective_bytes: int = SMALL_COLLECTIVE_BYTES,
                    context: str = "") -> List[Finding]:
    """Check one executed step's trace against its ``BucketPlan``.

    Returns an empty list iff the step ran exactly one all-gather per
    forward bucket (plus zero3 re-gathers) and one reduce-scatter per
    backward bucket, with operand bytes matching the ``FlatSpec`` byte
    math as a multiset, and no other cross-rank communication (an
    all-reduce only at or below the scalar-loss threshold).  The checks
    run at any world size, world 1 included.  The wire-byte model
    (compression exactness) is checked by :func:`verify_wire_model`,
    appended here when a compressor is given.
    """
    findings: List[Finding] = []
    ctx = {"context": context} if context else {}
    summary = collective_summary(trace)

    exp_ag = expected_ag_bytes(specs, plan, zero3=zero3)
    exp_rs = expected_rs_bytes(specs, plan)
    obs_ag = [b for _, b in summary["all-gather"]]
    obs_rs = [b for _, b in summary["reduce-scatter"]]

    if len(obs_ag) != len(exp_ag):
        findings.append(Finding(
            code="SCHED-AG-COUNT",
            message=f"{len(obs_ag)} all-gathers ran, plan "
                    f"prescribes {len(exp_ag)} "
                    f"({len(plan.forward)} forward buckets"
                    + (", zero3 re-gathers included)" if zero3 else ")"),
            detail={"expected": len(exp_ag), "observed": len(obs_ag),
                    **ctx}))
    if len(obs_rs) != len(exp_rs):
        findings.append(Finding(
            code="SCHED-RS-COUNT",
            message=f"{len(obs_rs)} reduce-scatters ran, plan "
                    f"prescribes {len(exp_rs)} backward buckets",
            detail={"expected": len(exp_rs), "observed": len(obs_rs),
                    **ctx}))

    for code, kind, exp, obs in (
            ("SCHED-AG-BYTES", "all-gather", exp_ag, obs_ag),
            ("SCHED-RS-BYTES", "reduce-scatter", exp_rs, obs_rs)):
        missing, extra = _multiset_diff(exp, obs)
        if missing or extra:
            findings.append(Finding(
                code=code,
                message=f"{kind} operand bytes do not match the "
                        f"FlatSpec byte math: missing {missing}, "
                        f"unexpected {extra}",
                detail={"expected": sorted(exp),
                        "observed": sorted(obs), **ctx}))

    # stray cross-rank communication outside the plan
    for kind in [k for k in summary if k not in _SCHEDULED]:
        for rec, nbytes in summary[kind]:
            findings.append(Finding(
                code="SCHED-STRAY-COLLECTIVE",
                message=f"stray {kind} ({nbytes} operand bytes, "
                        f"%{rec.name}) — the plan prescribes none",
                detail={"opcode": kind, "name": rec.name,
                        "bytes": nbytes, **ctx}))
    for rec, nbytes in summary["all-reduce"]:
        if nbytes > small_collective_bytes:
            findings.append(Finding(
                code="SCHED-STRAY-COLLECTIVE",
                message=f"all-reduce of {nbytes} operand bytes "
                        f"(%{rec.name}) exceeds the scalar-loss "
                        f"threshold ({small_collective_bytes} B) — "
                        f"gradient traffic must go through the "
                        f"scheduled reduce-scatters",
                detail={"opcode": "all-reduce", "name": rec.name,
                        "bytes": nbytes, **ctx}))

    if compressor is not None:
        findings.extend(verify_wire_model(specs, plan, compressor,
                                          context=context))
    return findings


def verify_no_collectives(trace: Trace, *,
                          small_collective_bytes: int =
                          SMALL_COLLECTIVE_BYTES,
                          context: str = "") -> List[Finding]:
    """A window that must carry **no** cross-rank traffic at all (the
    local runtime's step, the async trainers' gradient computation, a
    pipeline stage — their communication is explicit server messages or
    boundary buffers, never collectives).  Sub-threshold scalar
    reductions of the five collective kinds are tolerated; any other
    communication call is always flagged."""
    findings: List[Finding] = []
    ctx = {"context": context} if context else {}
    for kind, entries in collective_summary(trace).items():
        for rec, nbytes in entries:
            if kind in COLLECTIVES and nbytes <= small_collective_bytes:
                continue
            findings.append(Finding(
                code="SCHED-STRAY-COLLECTIVE",
                message=f"{kind} of {nbytes} operand bytes "
                        f"(%{rec.name}) in a window that must carry "
                        f"no cross-rank collectives",
                detail={"opcode": kind, "name": rec.name,
                        "bytes": nbytes, **ctx}))
    return findings


def verify_wire_model(specs: Sequence[Any], plan: Any, compressor: Any, *,
                      context: str = "") -> List[Finding]:
    """Exactness of the compressed wire-byte accounting.

    Recomputes every backward segment's wire bytes from the published
    int8/top-k formulas (:func:`independent_wire_bytes`) and requires
    the repo's own ``compressor.wire_bytes`` accounting (what
    ``PSServer.push_wire_bytes`` and the ledgers record) to agree to the
    integer."""
    findings: List[Finding] = []
    ctx = {"context": context} if context else {}
    overhead = getattr(compressor, "segment_overhead_bytes", 0.0)
    for i, bucket in enumerate(plan.backward):
        expected = segment_wire_bytes(specs, bucket, compressor)
        actual = int(round(sum(
            float(compressor.wire_bytes(specs[l].total * 4))
            for l in bucket) + overhead))
        if actual != expected:
            findings.append(Finding(
                code="SCHED-WIRE-BYTES",
                message=f"backward segment {i} ({tuple(bucket)}): "
                        f"compressor accounts {actual} wire bytes, "
                        f"independent {compressor.scheme} formula gives "
                        f"{expected}",
                detail={"segment": list(bucket), "expected": expected,
                        "actual": actual, "scheme": compressor.scheme,
                        **ctx}))
    return findings


def verify_cache(cache: Any, *, zero3: bool = False,
                 context: str = "") -> List[Finding]:
    """Retrace audit of a ``PlanStepCache``: exactly one first use per
    distinct ``BucketPlan``, and each cached step's collective counts (as
    its first step's trace recorded them) match its plan's bucket counts
    — at any world size: a ``(0, 0)`` count is a finding."""
    findings: List[Finding] = []
    ctx = {"context": context} if context else {}
    plans = cache.plans
    if cache.traces != len(plans):
        findings.append(Finding(
            code="SCHED-CACHE-RETRACE",
            message=f"{cache.traces} compilations for {len(plans)} "
                    f"distinct plans — revisited plans must be served "
                    f"from the cache",
            detail={"traces": cache.traces, "plans": len(plans), **ctx}))
    for plan in plans:
        n_ag, n_rs = cache.collective_counts(plan)
        exp_ag = len(plan.forward)
        if zero3:
            num_layers = max(max(b) for b in plan.forward) + 1
            exp_ag += sum(1 for b in plan.backward
                          if any(0 < l < num_layers - 1 for l in b))
        exp_rs = len(plan.backward)
        if (n_ag, n_rs) != (exp_ag, exp_rs):
            findings.append(Finding(
                code="SCHED-CACHE-COUNTS",
                message=f"cached step for plan {plan} compiled "
                        f"{n_ag} all-gathers / {n_rs} reduce-scatters, "
                        f"expected {exp_ag} / {exp_rs}",
                detail={"expected": [exp_ag, exp_rs],
                        "observed": [n_ag, n_rs], **ctx}))
    return findings


def verify_push_ledger(ledger: Any, plans_by_worker: Dict[int, Any],
                       specs: Sequence[Any], compressor: Optional[Any], *,
                       context: str = "") -> List[Finding]:
    """Per-worker wire-byte audit of a ``TransferLedger``.

    Each worker's recorded ``pushed_bytes`` must decompose exactly into
    its plan's backward segments walked in order (whole iterations plus
    at most one partial), and the wire bytes implied by that
    decomposition under the independent byte model must equal the
    recorded ``pushed_wire_bytes`` to the integer — proving the
    compressed accounting exact for every committed push, including
    int8/top-k payloads.

    Elastic fleets re-plan workers mid-run, so a worker's bytes no
    longer decompose under ONE plan.  For those, ``plans_by_worker``
    maps the worker to its *push history* instead — a sequence of
    ``(plan, full_iterations, extra_segments)`` entries (the
    ``FleetTrainer.push_history`` format, ``extra_segments`` counting a
    trailing partial walk, e.g. a crash mid-push) — and the audit sums
    the exact decomposition those entries pin down.  A departed worker's
    ledger entry closes cleanly iff its history reproduces the recorded
    bytes; a joined worker simply has no entries before its join."""
    findings: List[Finding] = []
    ctx = {"context": context} if context else {}
    total_segments = 0
    for worker, logical_target in sorted(ledger.pushed_bytes.items()):
        plan = plans_by_worker[worker]
        if not hasattr(plan, "backward"):     # elastic: push history
            logical = wire = nseg = 0
            for entry_plan, full, extra in plan:
                seg_logical = [sum(specs[l].total * 4 for l in b)
                               for b in entry_plan.backward]
                seg_wire = [segment_wire_bytes(specs, b, compressor)
                            for b in entry_plan.backward]
                logical += full * sum(seg_logical) + sum(seg_logical[:extra])
                wire += full * sum(seg_wire) + sum(seg_wire[:extra])
                nseg += full * len(seg_logical) + extra
            if logical != logical_target:
                findings.append(Finding(
                    code="SCHED-LEDGER",
                    message=f"worker {worker}: recorded {logical_target} "
                            f"pushed bytes, but its push history "
                            f"decomposes to {logical}",
                    detail={"worker": worker, "recorded": logical_target,
                            "history_bytes": logical, **ctx}))
                continue
            recorded_wire = ledger.pushed_wire_bytes.get(worker, 0)
            if wire != recorded_wire:
                findings.append(Finding(
                    code="SCHED-LEDGER",
                    message=f"worker {worker}: ledger records "
                            f"{recorded_wire} pushed wire bytes, the "
                            f"independent byte model implies {wire} for "
                            f"its push history ({nseg} segments)",
                    detail={"worker": worker, "recorded": recorded_wire,
                            "expected": wire, "segments": nseg, **ctx}))
            total_segments += nseg
            continue
        seg_logical = [sum(specs[l].total * 4 for l in b)
                       for b in plan.backward]
        seg_wire = [segment_wire_bytes(specs, b, compressor)
                    for b in plan.backward]
        cap = 1 + len(seg_logical) * (
            1 + logical_target // max(1, sum(seg_logical)))
        logical = wire = nseg = 0
        while logical < logical_target and nseg < cap:
            logical += seg_logical[nseg % len(seg_logical)]
            wire += seg_wire[nseg % len(seg_wire)]
            nseg += 1
        if logical != logical_target:
            findings.append(Finding(
                code="SCHED-LEDGER",
                message=f"worker {worker}: recorded {logical_target} "
                        f"pushed bytes do not decompose into plan-order "
                        f"backward segments (nearest prefix {logical})",
                detail={"worker": worker, "recorded": logical_target,
                        "nearest_prefix": logical, **ctx}))
            continue
        recorded_wire = ledger.pushed_wire_bytes.get(worker, 0)
        if wire != recorded_wire:
            findings.append(Finding(
                code="SCHED-LEDGER",
                message=f"worker {worker}: ledger records "
                        f"{recorded_wire} pushed wire bytes, the "
                        f"independent byte model implies {wire} for the "
                        f"same {nseg} segments",
                detail={"worker": worker, "recorded": recorded_wire,
                        "expected": wire, "segments": nseg, **ctx}))
        total_segments += nseg
    if ledger.pushed_bytes and ledger.num_pushes != total_segments:
        findings.append(Finding(
            code="SCHED-LEDGER",
            message=f"ledger counts {ledger.num_pushes} push messages, "
                    f"the per-worker byte decomposition implies "
                    f"{total_segments} segments",
            detail={"num_pushes": ledger.num_pushes,
                    "segments": total_segments, **ctx}))
    return findings


def verify_fleet_membership(log: Any, joined_at: Dict[int, Tuple[float, int]],
                            departed: Dict[int, Tuple[float, str]], *,
                            staleness_bound: int,
                            context: str = "") -> List[Finding]:
    """Membership-coherence audit of an elastic-fleet run log.

    Against an ``AsyncRunLog`` and the roster history a
    ``FleetMembership`` records, checks that

    * every accepted push is within the staleness bound ``k`` — churn
      must not let a stale gradient slip past the SSP gate;
    * no worker commits outside its membership window: nothing before
      its join time, nothing after its departure (a departed worker's
      ledger closes cleanly);
    * a joined worker's pushes start at (or after) the server version it
      joined at — it can never have pulled older parameters than the
      join-time head.
    """
    findings: List[Finding] = []
    ctx = {"context": context} if context else {}
    for e in log.accepted:
        if e.result.staleness > staleness_bound:
            findings.append(Finding(
                code="FLEET-STALENESS",
                message=f"worker {e.worker} committed at staleness "
                        f"{e.result.staleness} > bound {staleness_bound} "
                        f"(t={e.sim_time})",
                detail={"worker": e.worker, "staleness": e.result.staleness,
                        "bound": staleness_bound, "time": e.sim_time,
                        **ctx}))
        if e.worker not in joined_at:
            findings.append(Finding(
                code="FLEET-MEMBER",
                message=f"worker {e.worker} committed at t={e.sim_time} "
                        f"but never joined the fleet",
                detail={"worker": e.worker, "time": e.sim_time, **ctx}))
            continue
        join_t, join_v = joined_at[e.worker]
        if e.sim_time < join_t:
            findings.append(Finding(
                code="FLEET-MEMBER",
                message=f"worker {e.worker} committed at t={e.sim_time}, "
                        f"before its join at t={join_t}",
                detail={"worker": e.worker, "time": e.sim_time,
                        "joined": join_t, **ctx}))
        if e.version < join_v:
            findings.append(Finding(
                code="FLEET-MEMBER",
                message=f"worker {e.worker} pushed against version "
                        f"{e.version}, older than the head at its join "
                        f"(version {join_v})",
                detail={"worker": e.worker, "version": e.version,
                        "join_version": join_v, **ctx}))
        if e.worker in departed and e.sim_time > departed[e.worker][0]:
            dep_t, reason = departed[e.worker]
            findings.append(Finding(
                code="FLEET-MEMBER",
                message=f"worker {e.worker} committed at t={e.sim_time}, "
                        f"after its departure ({reason}) at t={dep_t}",
                detail={"worker": e.worker, "time": e.sim_time,
                        "departed": dep_t, "reason": reason, **ctx}))
    return findings
