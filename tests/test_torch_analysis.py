"""The port's verification layer (``repro_torch.analysis``) against the
reference's ``repro.analysis``.

Held against the reference on identical inputs: the byte math (the four
strategies x zero3, reduced granite-3-2b's specs at A in {1, 2}), the wire
model, the push-ledger audits (static and elastic histories), the
membership audit and the cache audit — exact integers and equal findings
JSON, the reference's mutations included — and ``verify_schedule`` /
``verify_no_collectives`` over traces built from the reference's golden
HLO fixtures and synthesized modules (the same codes).  Then the port's
own: the recorder (each wrapped entry point, list operands, ``async_op``,
unknown calls as strays, no tensor op of its own), mutations on real
traces (a corrupted plan, tampered bytes, a stray all-reduce and a
broadcast, a retrace, ``(0, 0)`` at world 1), ``stage_traces`` leaving
the pipeline trainer bitwise as it was, ``verify_runtime``'s info against
the reference's, the CLI over the ten smoke configs (the four
process-group regimes at 2 gloo ranks in one subprocess), and the lints.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest
import torch
import torch.distributed as dist

from repro.analysis import conformance as ref_conf
from repro.analysis import findings as ref_findings
from repro.analysis import lints as ref_lints
from repro.analysis.hlo import collective_summary as ref_summary
from repro.compress.compressor import make_compressor as ref_make_compressor
from repro.configs import get_config as jax_get_config
from repro.core import plan_from_decision as ref_plan_from_decision
from repro.core import random_costs as ref_random_costs
from repro.core import schedule as ref_schedule
from repro.core.buckets import BucketPlan as RefBucketPlan
from repro.dist import collectives as jax_coll
from repro.models import init_params as jax_init_params
from repro.models import sched_layer_trees as jax_sched_trees
from repro_torch.analysis import (COLLECTIVES, CollectiveRecord,
                                  collective_counts, collective_summary,
                                  conformance, findings_to_json, lint_paths,
                                  lint_source, record_collectives,
                                  verify_cache, verify_no_collectives,
                                  verify_schedule)
from repro_torch.analysis.trace import OTHER_CALLS, RECORDED
from repro_torch.compress import make_compressor
from repro_torch.configs import get_config
from repro_torch.core import BucketPlan, plan_from_decision, random_costs, \
    schedule
from repro_torch.dist.collectives import make_flat_spec
from repro_torch.dist.zero import default_group
from repro_torch.models import param_shapes, sched_layer_trees
from repro_torch.runtime import RuntimeConfig, build_runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "examples", "runtime_configs")
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "hlo")
HELPER = os.path.join(ROOT, "tests", "helpers", "torch_verify_check.py")
STRATEGIES = ("sequential", "lbl", "ibatch", "dynacomm")
PG_CONFIGS = ("zero", "ps", "dynamic", "dynamic_ps")
ONE_RANK_CONFIGS = ("local", "ps_async", "ps_async_int8",
                    "dynamic_ps_async", "fleet_async", "pipeline")

sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_analysis import synth_hlo  # noqa: E402  (the reference's helper)


@pytest.fixture(scope="module")
def group():
    """The world-1 gloo group the port's CPU runtimes use."""
    return default_group(torch.device("cpu"))


def fake_specs(num_layers, axis_size=2, base=256):
    """The reference test's FlatSpec stand-ins: ``total`` not aligned."""
    specs = []
    for l in range(num_layers):
        total = base * (l + 1) + 3
        padded = -(-total // axis_size) * axis_size
        specs.append(SimpleNamespace(total=total, padded=padded,
                                     axis_size=axis_size))
    return specs


def plans_for(strat, num_layers=8):
    """The same plan as each package's ``BucketPlan`` (port, reference)."""
    f, b = schedule(random_costs(num_layers, seed=0, dt=1e-3), strat)
    rf, rb = ref_schedule(ref_random_costs(num_layers, seed=0, dt=1e-3),
                          strat)
    assert (f, b) == (rf, rb)
    return (plan_from_decision(f, b, num_layers),
            ref_plan_from_decision(rf, rb, num_layers))


def compressors(scheme):
    """(port, reference) compressors of ``scheme`` (None for "none")."""
    if scheme == "none":
        return None, None
    kwargs = {"topk_fraction": 0.01} if scheme == "topk" else {}
    return make_compressor(scheme, **kwargs), \
        ref_make_compressor(scheme, **kwargs)


def same_json(mine, theirs):
    """Both packages' findings serialize to the same JSON document."""
    got = findings_to_json(mine)
    assert got == ref_findings.findings_to_json(theirs)
    return json.loads(got)


def trace_of_hlo(text, group_size=2):
    """A trace holding the collectives the reference finds in an HLO
    module: kinds, names and operand bytes from its summary."""
    return [CollectiveRecord(kind=kind, name=instr.name, bytes=nbytes,
                             dtype="float32", group_size=group_size)
            for kind, entries in ref_summary(text).items()
            for instr, nbytes in entries]


def codes_of(findings):
    return sorted(f.code for f in findings)


# ---------------------------------------------------------------------------
# byte math, wire model, ledgers, membership, cache: equal to the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strat", STRATEGIES)
@pytest.mark.parametrize("zero3", [False, True], ids=["zero", "zero3"])
def test_byte_math_equals_the_reference(strat, zero3):
    plan, ref_plan = plans_for(strat)
    specs = fake_specs(8)
    assert conformance.expected_ag_bytes(specs, plan, zero3=zero3) == \
        ref_conf.expected_ag_bytes(specs, ref_plan, zero3=zero3)
    assert conformance.expected_rs_bytes(specs, plan) == \
        ref_conf.expected_rs_bytes(specs, ref_plan)
    for scheme in ("none", "int8", "topk"):
        comp, ref_comp = compressors(scheme)
        for bucket in plan.backward:
            assert conformance.segment_wire_bytes(specs, bucket, comp) == \
                ref_conf.segment_wire_bytes(specs, bucket, ref_comp)
        for nbytes in (4.0, 4096.0, 4 * 655872.0, 4 * 100669440.0):
            assert conformance.independent_wire_bytes(comp, nbytes) == \
                ref_conf.independent_wire_bytes(ref_comp, nbytes)


@pytest.mark.parametrize("axis", [1, 2])
def test_byte_math_on_reduced_granite_specs(axis):
    """Each package's own FlatSpecs of reduced granite-3-2b, the plans of
    the four strategies: the same integers."""
    cfg = jax_get_config("granite-3-2b").reduced()
    shapes = jax.eval_shape(functools.partial(jax_init_params, cfg),
                            jax.random.PRNGKey(0))
    ref_specs = [jax_coll.make_flat_spec(t, axis)
                 for t in jax_sched_trees(shapes)]
    specs = [make_flat_spec(t, axis) for t in sched_layer_trees(
        param_shapes(get_config("granite-3-2b").reduced()))]
    L = len(specs)
    for strat in STRATEGIES:
        plan, ref_plan = plans_for(strat, L)
        for zero3 in (False, True):
            assert conformance.expected_ag_bytes(specs, plan, zero3=zero3) \
                == ref_conf.expected_ag_bytes(ref_specs, ref_plan,
                                              zero3=zero3)
        assert conformance.expected_rs_bytes(specs, plan) == \
            ref_conf.expected_rs_bytes(ref_specs, ref_plan)
        for scheme in ("none", "int8", "topk"):
            comp, ref_comp = compressors(scheme)
            assert [conformance.segment_wire_bytes(specs, b, comp)
                    for b in plan.backward] == \
                [ref_conf.segment_wire_bytes(ref_specs, b, ref_comp)
                 for b in ref_plan.backward]


def test_int8_tile_pinned_to_the_kernel():
    from repro_torch.kernels.compress.ops import TILE
    assert conformance.INT8_TILE == TILE == ref_conf.INT8_TILE


class Lying:
    """A compressor whose accounting claims no compression happened."""
    scheme = "int8"
    segment_overhead_bytes = 0.0

    def wire_bytes(self, logical_bytes):
        return logical_bytes


@pytest.mark.parametrize("strat", STRATEGIES)
@pytest.mark.parametrize("scheme", ["int8", "topk", "lying"])
def test_wire_model_equals_the_reference(strat, scheme):
    plan, ref_plan = plans_for(strat)
    specs = fake_specs(8)
    comp, ref_comp = (Lying(), Lying()) if scheme == "lying" \
        else compressors(scheme)
    doc = same_json(conformance.verify_wire_model(specs, plan, comp),
                    ref_conf.verify_wire_model(specs, ref_plan, ref_comp))
    if scheme == "lying":
        assert doc["num_findings"] > 0 and {
            f["code"] for f in doc["findings"]} == {"SCHED-WIRE-BYTES"}
    else:
        assert doc["num_findings"] == 0


def _static_ledger(plans, specs, comp, segments_by_worker):
    """The reference test's ledger of whole and partial plan walks."""
    pushed, wire, n_push = {}, {}, 0
    for w, nseg in segments_by_worker.items():
        bwd = plans[w].backward
        pushed[w] = sum(sum(specs[l].total * 4 for l in bwd[i % len(bwd)])
                        for i in range(nseg))
        wire[w] = sum(ref_conf.segment_wire_bytes(specs, bwd[i % len(bwd)],
                                                  comp)
                      for i in range(nseg))
        n_push += nseg
    return SimpleNamespace(pushed_bytes=pushed, pushed_wire_bytes=wire,
                           num_pushes=n_push)


def _mutate(ledger, mutation):
    if mutation == "bytes":
        ledger.pushed_bytes[0] += 1
    elif mutation == "wire":
        ledger.pushed_wire_bytes[0] -= 1
    elif mutation == "count":
        ledger.num_pushes += 1
    return ledger


@pytest.mark.parametrize("scheme", ["none", "int8", "topk"])
@pytest.mark.parametrize("mutation", [None, "bytes", "wire", "count"])
def test_push_ledger_audit_equals_the_reference(scheme, mutation):
    comp, ref_comp = compressors(scheme)
    specs = fake_specs(8)
    pd, rd = plans_for("dynacomm")
    ps, rs = plans_for("sequential")
    plans, ref_plans = {0: pd, 1: ps}, {0: rd, 1: rs}
    nseg = {0: 2 * len(pd.backward) + 1, 1: len(ps.backward)}
    ledger = _mutate(_static_ledger(ref_plans, specs, ref_comp, nseg),
                     mutation)
    doc = same_json(
        conformance.verify_push_ledger(ledger, plans, specs, comp),
        ref_conf.verify_push_ledger(ledger, ref_plans, specs, ref_comp))
    assert (doc["num_findings"] > 0) == (mutation is not None)


def _elastic_ledger(histories, specs, comp):
    pushed, wire, n_push = {}, {}, 0
    for w, history in histories.items():
        logical = wb = 0
        for plan, full, extra in history:
            seg_l = [sum(specs[l].total * 4 for l in b)
                     for b in plan.backward]
            seg_w = [ref_conf.segment_wire_bytes(specs, b, comp)
                     for b in plan.backward]
            logical += full * sum(seg_l) + sum(seg_l[:extra])
            wb += full * sum(seg_w) + sum(seg_w[:extra])
            n_push += full * len(seg_l) + extra
        pushed[w], wire[w] = logical, wb
    return SimpleNamespace(pushed_bytes=pushed, pushed_wire_bytes=wire,
                           num_pushes=n_push)


@pytest.mark.parametrize("scheme", ["none", "int8"])
@pytest.mark.parametrize("mutation", [None, "bytes", "wire"])
def test_elastic_ledger_audit_equals_the_reference(scheme, mutation):
    """Push histories: re-planned after 2 iterations, then crashed one
    segment into an iteration; beside a static worker's plain plan."""
    comp, ref_comp = compressors(scheme)
    specs = fake_specs(8)
    (pa, ra), (pb, rb) = plans_for("dynacomm"), plans_for("sequential")
    hist = {0: ((pa, 2, 0), (pb, 3, 1))}
    ref_hist = {0: ((ra, 2, 0), (rb, 3, 1))}
    ledger = _elastic_ledger(ref_hist, specs, ref_comp)
    seg_l = [sum(specs[l].total * 4 for l in b) for b in ra.backward]
    ledger.pushed_bytes[1] = sum(seg_l)
    ledger.pushed_wire_bytes[1] = sum(
        ref_conf.segment_wire_bytes(specs, b, ref_comp) for b in ra.backward)
    ledger.num_pushes += len(ra.backward)
    hist[1], ref_hist[1] = pa, ra
    ledger = _mutate(ledger, mutation)
    doc = same_json(
        conformance.verify_push_ledger(ledger, hist, specs, comp),
        ref_conf.verify_push_ledger(ledger, ref_hist, specs, ref_comp))
    assert (doc["num_findings"] > 0) == (mutation is not None)


def _event(worker, t, version, staleness):
    return SimpleNamespace(worker=worker, sim_time=t, version=version,
                           result=SimpleNamespace(staleness=staleness))


MEMBERSHIP_CASES = {
    "clean": ([_event(0, 0.1, 0, 0), _event(7, 0.6, 5, 1),
               _event(0, 0.7, 6, 2)],
              {0: (0.0, 0), 7: (0.5, 5)}, {1: (0.4, "crash")}),
    "staleness": ([_event(0, 0.1, 0, 3)], {0: (0.0, 0)}, {}),
    "before-join": ([_event(7, 0.3, 5, 0)], {7: (0.5, 5)}, {}),
    "old-version": ([_event(7, 0.6, 3, 1)], {7: (0.5, 5)}, {}),
    "after-departure": ([_event(1, 0.9, 8, 0)], {1: (0.0, 0)},
                        {1: (0.4, "crash")}),
    "never-joined": ([_event(9, 0.2, 1, 0)], {0: (0.0, 0)}, {}),
}


@pytest.mark.parametrize("case", sorted(MEMBERSHIP_CASES))
def test_fleet_membership_audit_equals_the_reference(case):
    events, joined, departed = MEMBERSHIP_CASES[case]
    log = SimpleNamespace(accepted=events)
    doc = same_json(
        conformance.verify_fleet_membership(log, joined, departed,
                                            staleness_bound=2),
        ref_conf.verify_fleet_membership(log, joined, departed,
                                         staleness_bound=2))
    assert (doc["num_findings"] == 0) == (case == "clean")


class FakeCache:
    """A step cache double answering both packages' count methods."""

    def __init__(self, plans, traces=None, counts=None):
        self.plans = list(plans)
        self.traces = len(self.plans) if traces is None else traces
        self._counts = counts or {}

    def collective_counts(self, plan):
        key = (plan.forward, plan.backward)
        if key in self._counts:
            return self._counts[key]
        return (len(plan.forward), len(plan.backward))

    hlo_counts = collective_counts


@pytest.mark.parametrize("case", ["clean", "retrace", "counts"])
@pytest.mark.parametrize("zero3", [False, True], ids=["zero", "zero3"])
def test_cache_audit_equals_the_reference(case, zero3):
    pairs = [plans_for(s) for s in ("sequential", "lbl", "dynacomm")]
    mine = [p for p, _ in pairs]
    theirs = [r for _, r in pairs]
    kwargs = {"retrace": {"traces": 5},
              "counts": {"counts": {(mine[1].forward, mine[1].backward):
                                    (0, 0)}},
              "clean": {}}[case]
    doc = same_json(
        verify_cache(FakeCache(mine, **kwargs), zero3=zero3),
        ref_conf.verify_cache(FakeCache(theirs, **kwargs), zero3=zero3))
    want = {"clean": [], "retrace": ["SCHED-CACHE-RETRACE"],
            "counts": ["SCHED-CACHE-COUNTS"]}[case]
    if not zero3:       # the double counts a step without re-gathers
        assert [f["code"] for f in doc["findings"]] == want


def test_cache_audit_flags_zero_counts_at_world_one():
    """The reference accepts (0, 0) on one device (XLA elides the
    collectives); the port's eager calls always run, so it is a finding."""
    plan, ref_plan = plans_for("lbl")
    specs = fake_specs(8, axis_size=1)
    key = (plan.forward, plan.backward)
    assert ref_conf.verify_cache(FakeCache([ref_plan], counts={key: (0, 0)}),
                                 specs=specs) == []
    found = verify_cache(FakeCache([plan], counts={key: (0, 0)}))
    assert codes_of(found) == ["SCHED-CACHE-COUNTS"]


# ---------------------------------------------------------------------------
# verify_schedule / verify_no_collectives over the reference's modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(os.listdir(FIXTURES)))
def test_no_collectives_over_the_golden_fixtures(name):
    with open(os.path.join(FIXTURES, name)) as f:
        text = f.read()
    trace = trace_of_hlo(text)
    assert collective_counts(trace) == {
        k: len(v) for k, v in ref_summary(text).items()}
    assert codes_of(verify_no_collectives(trace)) == \
        codes_of(ref_conf.verify_no_collectives(text))


def _corrupt(plan):
    """The reference's mutation (the first two forward buckets merged),
    or the first bucket split where the plan has only one."""
    f = plan.forward
    f = (f[0] + f[1],) + f[2:] if len(f) > 1 else (f[0][:1], f[0][1:])
    return dataclasses.replace(plan, forward=f)


@pytest.mark.parametrize("strat", STRATEGIES)
@pytest.mark.parametrize("mutation", [None, "corrupt", "tamper", "stray"])
def test_schedule_over_synthesized_modules_gives_the_references_codes(
        strat, mutation):
    plan, ref_plan = plans_for(strat)
    specs = fake_specs(8)
    extra = ["  %all-to-all.50 = f32[2,64] all-to-all(f32[2,64] %x.1), "
             "replica_groups={{0,1}}, dimensions={0}",
             "  %all-reduce.51 = f32[1,4096] all-reduce(f32[1,4096] %g.9), "
             "to_apply=%sum"] if mutation == "stray" else ()
    text = synth_hlo(specs, ref_plan, extra_lines=extra)
    if mutation == "tamper":
        line = next(x for x in text.splitlines() if "reduce-scatter(" in x)
        text = text.replace(line, line.replace("f32[2,", "f32[2,7"))
    if mutation == "corrupt":
        plan, ref_plan = _corrupt(plan), _corrupt(ref_plan)
    mine = codes_of(verify_schedule(trace_of_hlo(text), plan, specs))
    assert mine == codes_of(ref_conf.verify_schedule(text, ref_plan, specs))
    assert bool(mine) == (mutation is not None)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def _example_call(name):
    """(args, operand bytes) of one call of ``name`` with f32 tensors of 6
    and 4 elements."""
    t, u, out = torch.zeros(6), torch.zeros(4), torch.zeros(12)
    table = {
        "all_gather_into_tensor": ((out, t), 24),
        "all_gather_single": ((out, t), 24),
        "_all_gather_base": ((out, t), 24),
        "all_gather": (([out], t), 24),
        "all_gather_coalesced": (([[out]], [t, u]), 40),
        "reduce_scatter_tensor": ((u, t), 24),
        "reduce_scatter_single": ((u, t), 24),
        "_reduce_scatter_base": ((u, t), 24),
        "reduce_scatter": ((u, [t, u]), 40),
        "all_reduce": ((t,), 24),
        "all_reduce_coalesced": (([t, u],), 40),
        "all_to_all_single": ((out, t), 24),
        "all_to_all": (([out], [t, u]), 40),
        "batch_isend_irecv": (([dist.P2POp(dist.isend, t, 0),
                                dist.P2POp(dist.irecv, u, 0)],), 24),
        "scatter": ((t, [t, u]), 64),
        "gather": ((t, [t, u]), 64),
    }
    if name in table:
        return table[name]
    if name.endswith("_object") or name.endswith("_object_list"):
        return (([None], [1]), 0)
    if "barrier" in name:
        return ((), 0)
    return ((t,), 24)                       # broadcast, send, recv, ...


@pytest.mark.parametrize("name", sorted(set(RECORDED) | set(OTHER_CALLS)))
def test_the_recorder_sees_each_wrapped_entry_point(name, group,
                                                    monkeypatch):
    """A call through each wrapped ``torch.distributed`` function is one
    record of its kind with its operand bytes (the function itself is
    replaced by a no-op first, so point-to-point calls need no peer)."""
    real = getattr(dist, name, None)
    if real is None:
        pytest.skip(f"torch.distributed.{name} is not in this torch build")
    args, nbytes = _example_call(name)
    monkeypatch.setattr(dist, name, functools.wraps(real)(
        lambda *a, **k: None))
    with record_collectives() as trace:
        getattr(dist, name)(*args)
    kind = RECORDED[name][0] if name in RECORDED else name
    assert [(r.kind, r.bytes, r.group_size) for r in trace] == \
        [(kind, nbytes, 1)]
    assert getattr(dist, name).__wrapped__ is real


def test_recorder_real_calls_lists_and_async(group):
    t, u = torch.arange(6.), torch.arange(4.)
    with record_collectives() as trace:
        dist.all_reduce(t)
        work = dist.all_reduce(u, async_op=True)
        work.wait()
        dist.reduce_scatter(torch.zeros(5), [t[:5]])
        dist.all_gather([torch.zeros(4)], u)
    assert [(r.kind, r.bytes, r.dtype) for r in trace] == [
        ("all-reduce", 24, "float32"), ("all-reduce", 16, "float32"),
        ("reduce-scatter", 20, "float32"), ("all-gather", 16, "float32")]
    assert [r.name for r in trace] == ["all_reduce.0", "all_reduce.1",
                                       "reduce_scatter.2", "all_gather.3"]


def test_recorder_windows_nest_and_restore(group):
    before = {n: getattr(dist, n, None) for n in (*RECORDED, *OTHER_CALLS)}
    with pytest.raises(ZeroDivisionError):
        with record_collectives() as outer:
            dist.all_reduce(torch.zeros(3))
            with record_collectives() as inner:
                dist.broadcast(torch.zeros(2), 0)
            1 / 0
    assert [r.kind for r in outer] == ["all-reduce", "broadcast"]
    assert [r.kind for r in inner] == ["broadcast"]
    assert {n: getattr(dist, n, None) for n in before} == before


def test_recorder_adds_no_tensor_op(group):
    """The window runs exactly the aten / c10d ops the calls run: no clone,
    no copy to the host, no ``item``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    x = torch.ones(300)

    def calls():
        dist.all_reduce(x)
        dist.all_gather_into_tensor(torch.zeros(300), x)
        dist.broadcast(x, 0)

    with Ops() as plain:
        calls()
    with Ops() as recorded:
        with record_collectives() as trace:
            calls()
    assert recorded.seen == plain.seen and len(trace) == 3


def test_unknown_calls_are_always_stray(group):
    with record_collectives() as trace:
        dist.broadcast(torch.zeros(1), 0)          # 4 bytes: still stray
        dist.barrier()
    summary = collective_summary(trace)
    assert list(summary) == [*COLLECTIVES, "broadcast", "barrier"]
    assert codes_of(verify_no_collectives(trace)) == \
        ["SCHED-STRAY-COLLECTIVE"] * 2
    plan = BucketPlan(forward=((0,),), backward=((0,),))
    spec = [SimpleNamespace(total=1, padded=1, axis_size=1)]
    assert codes_of(verify_schedule(trace, plan, spec)).count(
        "SCHED-STRAY-COLLECTIVE") == 2


# ---------------------------------------------------------------------------
# real traces of the port's runtimes, and their mutations
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def zero_run(group):
    """One recorded ``zero.json`` step on the CPU (world 1)."""
    rt = build_runtime(RuntimeConfig.load(os.path.join(CONFIGS,
                                                       "zero.json")),
                       device="cpu")
    with record_collectives() as trace:
        rt.fit(1)
    return rt, trace


def test_zero_step_trace_conforms_at_world_one(zero_run):
    rt, trace = zero_run
    specs, plan = rt.trainer.specs, rt.plan
    assert [(r.kind, r.bytes, r.group_size) for r in trace] == \
        [("all-gather", b, 1) for b in
         conformance.expected_ag_bytes(specs, plan)] + \
        [("reduce-scatter", b, 1) for b in
         conformance.expected_rs_bytes(specs, plan)]
    assert verify_schedule(trace, plan, specs) == []


@pytest.mark.parametrize("mutation", ["corrupt", "split", "tamper", "drop",
                                      "stray-all-reduce", "broadcast"])
def test_mutations_of_a_real_trace_are_flagged(zero_run, mutation):
    rt, trace = zero_run
    specs, plan = rt.trainer.specs, rt.plan
    trace = list(trace)
    if mutation == "corrupt":             # the reference's merged buckets
        plan = BucketPlan(forward=((0, 1), (2, 3)), backward=plan.backward)
        want = {"SCHED-AG-COUNT", "SCHED-AG-BYTES"}
    elif mutation == "split":             # one bucket split in two
        first = plan.forward[0]
        plan = BucketPlan(forward=(first[:1], first[1:]) + plan.forward[1:],
                          backward=plan.backward)
        want = {"SCHED-AG-COUNT", "SCHED-AG-BYTES"}
    elif mutation == "tamper":
        i = next(i for i, r in enumerate(trace)
                 if r.kind == "reduce-scatter")
        trace[i] = dataclasses.replace(trace[i], bytes=trace[i].bytes + 28)
        want = {"SCHED-RS-BYTES"}
    elif mutation == "drop":              # (0, 0): nothing ran at world 1
        trace = []
        want = {"SCHED-AG-COUNT", "SCHED-AG-BYTES", "SCHED-RS-COUNT",
                "SCHED-RS-BYTES"}
    else:
        with record_collectives() as extra:
            if mutation == "broadcast":
                dist.broadcast(torch.zeros(2), 0)
            else:                         # > 1 KB of gradient all-reduce
                dist.all_reduce(torch.zeros(257))
        trace += extra
        want = {"SCHED-STRAY-COLLECTIVE"}
    assert set(codes_of(verify_schedule(trace, plan, specs))) == want


@pytest.fixture(scope="module")
def dynamic_run(group):
    rt = build_runtime(RuntimeConfig.load(os.path.join(CONFIGS,
                                                       "dynamic.json")),
                       device="cpu")
    rt.fit(rt.config.schedule.reschedule_every + 1)
    return rt


def test_dynamic_cache_keeps_each_plans_first_step_trace(dynamic_run):
    tr = dynamic_run.trainer
    specs = tr.base.specs
    assert len(tr.plans_seen) == 2 and tr.traces == 2
    for plan in tr.plans_seen:
        trace = tr._cache.trace_of(plan)
        assert tr.collective_counts(plan) == (len(plan.forward),
                                              len(plan.backward))
        assert verify_schedule(trace, plan, specs) == []
    assert verify_cache(tr._cache) == []


def test_a_retrace_and_zero_counts_are_flagged(dynamic_run):
    tr = dynamic_run.trainer
    cache = tr._cache
    retraced = SimpleNamespace(plans=cache.plans, traces=cache.traces + 1,
                               collective_counts=cache.collective_counts)
    assert codes_of(verify_cache(retraced)) == ["SCHED-CACHE-RETRACE"]
    silent = SimpleNamespace(plans=cache.plans, traces=cache.traces,
                             collective_counts=lambda plan: (0, 0))
    assert codes_of(verify_cache(silent)) == ["SCHED-CACHE-COUNTS"] * 2


def _trainer_snapshot(rt):
    st = rt._state
    bufs = [*st["flat_params"], *st["opt"].mu, *st["opt"].nu,
            st["opt"].step, st["step"]]
    return [b.clone() for b in bufs], json.dumps(
        rt.trainer.ledger, sort_keys=True, default=str)


def test_stage_traces_leave_the_pipeline_trainer_bitwise(group):
    rt = build_runtime(RuntimeConfig.load(os.path.join(CONFIGS,
                                                       "pipeline.json")),
                       device="cpu")
    rt.fit(1)
    bufs, ledger = _trainer_snapshot(rt)
    traces = rt.trainer.stage_traces(rt._state, rt._batch_fn(0))
    assert len(traces) == rt.trainer.num_stages
    assert all(fwd == [] and bwd == [] for fwd, bwd in traces)
    after, after_ledger = _trainer_snapshot(rt)
    assert after_ledger == ledger
    for a, b in zip(bufs, after):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)


def test_a_collective_inside_a_stage_is_flagged(group, monkeypatch):
    """The pipeline check can fail: a broadcast slipped into a stage's
    forward shows in that stage's trace."""
    from repro_torch.analysis.runtime_verify import verify_runtime
    from repro_torch.pipeline import trainer as pipe
    real = pipe.PipelineTrainer._stage_forward

    def leaky(self, s, *args):
        if s == 1:
            dist.broadcast(torch.zeros(4), 0)
        return real(self, s, *args)

    monkeypatch.setattr(pipe.PipelineTrainer, "_stage_forward", leaky)
    findings, _ = verify_runtime(RuntimeConfig.load(os.path.join(
        CONFIGS, "pipeline.json")), device="cpu")
    assert [(f.code, f.detail["context"]) for f in findings] == [
        ("SCHED-STRAY-COLLECTIVE", "pipeline stage 1 forward")]


# ---------------------------------------------------------------------------
# verify_runtime against the reference's, in process (world 1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["local", "ps", "dynamic", "ps_async_int8",
                                  "pipeline", "fleet_async"])
def test_verify_runtime_info_equals_the_references(name, group):
    from repro.analysis.runtime_verify import \
        verify_runtime as ref_verify_runtime
    from repro.runtime.config import RuntimeConfig as JaxRuntimeConfig
    from repro_torch.analysis.runtime_verify import verify_runtime
    path = os.path.join(CONFIGS, f"{name}.json")
    ref_found, ref_info = ref_verify_runtime(JaxRuntimeConfig.load(path))
    found, info = verify_runtime(RuntimeConfig.load(path), device="cpu")
    assert found == [] and ref_found == []
    shared = sorted(set(info) & set(ref_info))
    assert shared == sorted(ref_info)
    assert set(info) - set(ref_info) <= {"collectives", "plans"}
    assert json.loads(json.dumps({k: info[k] for k in shared})) == \
        json.loads(json.dumps({k: ref_info[k] for k in shared}))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _run(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)


@pytest.mark.parametrize("name", ONE_RANK_CONFIGS)
def test_cli_verifies_each_one_rank_config(name, group, tmp_path, capsys):
    from repro_torch.analysis.cli import main
    out = tmp_path / "verify.json"
    assert main(["verify", "--config", os.path.join(CONFIGS, f"{name}.json"),
                 "--device", "cpu", "--json", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["num_findings"] == 0 and doc["ranks"] == 1
    assert doc["command"] == "verify" and doc["device"] == "cpu"
    assert "no findings" in capsys.readouterr().out


def test_process_group_configs_at_two_gloo_ranks(tmp_path):
    """zero / ps / dynamic / dynamic-ps at 2 ranks (one subprocess), the
    loss's 4-byte all-reduce at world 2, and the padded byte math."""
    out = tmp_path / "check.json"
    res = _run(HELPER, str(out))
    assert res.returncode == 0, res.stdout + res.stderr
    doc = json.loads(out.read_text())
    for name in PG_CONFIGS:
        assert doc["configs"][name]["findings"] == [], name
    assert doc["configs"]["dynamic"]["info"]["plans_seen"] == 2
    for rank in doc["ranks"]:
        assert rank["findings"] == []
        assert rank["unpadded_codes"] == ["SCHED-AG-BYTES", "SCHED-RS-BYTES"]
        assert rank["padded"] == [t + 1 for t in rank["totals"]]
        specs = [SimpleNamespace(total=t, padded=p, axis_size=2)
                 for t, p in zip(rank["totals"], rank["padded"])]
        plan = RefBucketPlan(forward=((0, 1), (2, 3)),
                             backward=((3, 2), (1,), (0,)))
        assert [r[1] for r in rank["records"]] == \
            ref_conf.expected_ag_bytes(specs, plan) + \
            ref_conf.expected_rs_bytes(specs, plan)
        assert {(r[2], r[3]) for r in rank["records"]} == {("float32", 2)}
        assert [k for k, _ in rank["zero_step"]] == \
            ["all-gather", "reduce-scatter", "reduce-scatter", "all-reduce"]
        assert rank["zero_step"][-1][1] == 4


def test_cli_spawns_gloo_ranks(tmp_path):
    out = tmp_path / "verify.json"
    res = _run("-m", "repro_torch.analysis", "verify", "--config",
               os.path.join(CONFIGS, "zero.json"), "--device", "cpu",
               "--json", str(out))
    assert res.returncode == 0, res.stdout + res.stderr
    doc = json.loads(out.read_text())
    assert doc["ranks"] == 2 and doc["num_findings"] == 0
    assert "[zero, cpu, 2 rank(s)]: 0 finding(s)" in res.stdout


def test_cli_exits_one_on_a_finding(group, tmp_path, monkeypatch, capsys):
    from repro_torch.analysis.cli import main
    from repro_torch.dist import collectives
    real = collectives.gather_bucket

    def twice(shards, specs, bucket, group=None):
        real(shards, specs, bucket, group)        # one pull too many
        return real(shards, specs, bucket, group)

    monkeypatch.setattr(collectives, "gather_bucket", twice)
    monkeypatch.setattr("repro_torch.dist.zero.gather_bucket", twice)
    out = tmp_path / "verify.json"
    assert main(["verify", "--config", os.path.join(CONFIGS, "zero.json"),
                 "--device", "cpu", "--devices", "1",
                 "--json", str(out)]) == 1
    codes = {f["code"] for f in json.loads(out.read_text())["findings"]}
    assert codes == {"SCHED-AG-COUNT", "SCHED-AG-BYTES"}
    assert "SCHED-AG-COUNT" in capsys.readouterr().out


def test_verify_on_the_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.analysis.cli import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["verify", "--config", os.path.join(CONFIGS, "local.json")])


# ---------------------------------------------------------------------------
# the lints
# ---------------------------------------------------------------------------


def test_port_tree_and_chip_smoke_are_lint_clean():
    found = lint_paths([os.path.join(ROOT, "src", "repro_torch"),
                        os.path.join(ROOT, "chip_smoke.py")])
    assert found == [], "\n".join(f.format() for f in found)


@pytest.mark.parametrize("source", [
    "import torch\ntorch.randn(3)\n",
    "import torch as th\nx = th.rand(2, 2)\n",
    "import torch.nn\ntorch.randint(0, 5, (3,))\n",
    "from torch import randperm\nrandperm(4)\n",
    "import torch\ntorch.normal(0.0, 1.0, (3,))\n",
    "import torch\ntorch.bernoulli(p)\n",
    "import torch\ntorch.multinomial(p, 2)\n",
    "import torch\ntorch.randn_like(x)\n",
    "from torch import rand_like as rl\nrl(x)\n",
])
def test_a_torch_global_draw_is_flagged(source):
    assert [f.code for f in lint_source(source, "src/m.py")] == \
        ["DET-RANDOM"]
    seeded = source.replace(")\n", ", generator=g)\n")
    assert lint_source(seeded, "src/m.py") == []


@pytest.mark.parametrize("source,path", [
    ("import random\nrandom.random()\n", "ps/x.py"),
    ("import random\nrandom.shuffle(xs)\n", "ps/x.py"),
    ("import numpy as np\nnp.random.rand(3)\n", "ps/x.py"),
    ("import numpy.random as npr\nnpr.standard_normal()\n", "ps/x.py"),
    ("import numpy as np\nrng = np.random.default_rng(0)\nrng.random()\n",
     "ps/x.py"),
    ("import random\nr = random.Random()\n", "ps/x.py"),
    ("from random import random\n", "ps/x.py"),
    ("from numpy.random import rand\n", "ps/x.py"),
    ("import time\nt = time.time()\n", "ps/async_mode.py"),
    ("import time\nt = time.time()\n", "fleet/engine.py"),
    ("import time\nt = time.time()\n", "pipeline/trainer.py"),
    ("import time\nt = time.time()\n", "launch/bench.py"),
    ("from datetime import datetime\nt = datetime.now()\n",
     "core/simulator.py"),
    ("from time import monotonic\n", "ps/server.py"),
    ("for k, v in params.items():\n    pass\n", "ps/x.py"),
    ("for k in sorted(params.keys()):\n    pass\n", "ps/x.py"),
    ("xs = [k for k in grad_tree.keys()]\n", "ps/x.py"),
    ("f(interpret=True)\n", "kernels/foo/ops.py"),
    ("def op(x, interpret: bool = False):\n    return x\n",
     "kernels/foo/ops.py"),
    ("from {pkg}.dist.dynamic import PlanStepCache\n", "ps/x.py"),
    ("from {pkg}.ps.dynamic import sequential_plan\n", "ps/x.py"),
    ("from {pkg}.dist.dynamic import DynamicTrainer\n", "ps/x.py"),
    ("import random\nrandom.random()  # noqa: DET-RANDOM\n", "ps/x.py"),
    ("import random\nrandom.random()  # noqa: DET-DICT-ORDER\n", "ps/x.py"),
    ("def broken(:\n", "ps/x.py"),
])
def test_lints_give_the_references_codes(source, path):
    mine = [f.code for f in lint_source(source.format(pkg="repro_torch"),
                                        f"src/repro_torch/{path}")]
    theirs = [f.code for f in ref_lints.lint_source(
        source.format(pkg="repro"), f"src/repro/{path}")]
    assert mine == theirs


def test_cli_lint_exit_codes_json_and_no_torch(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import random\nimport torch\nrandom.random()\n"
                   "torch.randn(3)\n")
    out = tmp_path / "lint.json"
    code = ("import sys\nfrom repro_torch.analysis.cli import main\n"
            f"rc = main(['lint', {str(bad)!r}, '--json', {str(out)!r}])\n"
            "assert 'torch' not in sys.modules\nsys.exit(rc)\n")
    res = _run("-c", code)
    assert res.returncode == 1, res.stdout + res.stderr
    doc = json.loads(out.read_text())
    assert doc["command"] == "lint" and doc["num_errors"] == 2
    assert [f["code"] for f in doc["findings"]] == ["DET-RANDOM"] * 2
    assert [f["line"] for f in doc["findings"]] == [3, 4]
    res = _run("-m", "repro_torch.analysis", "lint",
               os.path.join(ROOT, "src", "repro_torch"),
               os.path.join(ROOT, "chip_smoke.py"))
    assert res.returncode == 0 and "no findings" in res.stdout
