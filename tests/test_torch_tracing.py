"""The port's spans and counters (``repro_torch.tracing``) on the CPU.

Tiny configurations under ``torch.profiler`` (CPU activity only): each
span of the ZeRO step, the MoE layer, the re-plan pass and the decode loop
is in the exported trace by name, as many times as the plan, the layers
and the tokens say, and nested where it belongs.  Without a profiler no
span is entered and nothing is counted; with one, no loss, parameter,
optimizer moment or served token changes by a bit.
"""

import collections
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.core import bandwidth_shift
from repro_torch.core.buckets import BucketPlan
from repro_torch.data.pipeline import SyntheticText
from repro_torch.dist.dynamic import DynamicTrainer
from repro_torch.dist.zero import ZeroTrainer
from repro_torch.models import model, moe
from repro_torch.optim import adamw
from repro_torch.serve import decode, graphs

PLAN = BucketPlan(forward=((0, 1), (2, 3)), backward=((3,), (2, 1, 0)))
# a tiny MoE that drops assignments: 8 experts, top-2, capacity 0.5
DROPPING = dict(num_experts=8, top_k=2, capacity_factor=0.5)
# autograd nodes only the MoE layer makes (dispatch and combine)
MOE_NODES = ("IndexSelectBackward0", "IndexAddBackward0")


def _cfg(name="granite-3-2b", **changes):
    return dataclasses.replace(get_config(name).reduced(), **changes)


def _moe_cfg():
    return _cfg("granite-moe-1b-a400m", **DROPPING)


def _batch(cfg, b=2, t=16, seed=0):
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, t))).long()
    return {"tokens": toks, "labels": toks.roll(-1, dims=1)}


def _trainer(cfg, plan=PLAN, **kw):
    return ZeroTrainer(cfg=cfg, plan=plan, optimizer=adamw(1e-3),
                       device="cpu", **kw)


def _traced(fn, tmp_path):
    """``fn()`` under the profiler: (its result, the trace's spans and
    autograd nodes as (name, start, end, thread))."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"], e["tid"])
             for e in events if e.get("cat") == "user_annotation"]
    nodes = [(e["name"], e["ts"], e["ts"] + e["dur"], e["tid"])
             for e in events if e["name"].startswith(
                 "autograd::engine::evaluate_function")]
    return out, spans, nodes


def _named(spans, name):
    return [s for s in spans if s[0] == tracing.PREFIX + name]


def _counts(spans):
    return collections.Counter(s[0][len(tracing.PREFIX):] for s in spans
                               if s[0].startswith(tracing.PREFIX))


def _inside(inner, outers):
    """Whether ``inner`` lies within one of ``outers`` (by time)."""
    return any(o[1] <= inner[1] and inner[2] <= o[2] for o in outers)


def _two_steps(tr, cfg):
    state = tr.init_state(torch.Generator().manual_seed(0))
    losses = []
    for i in range(2):
        state, loss = tr.step(state, _batch(cfg, seed=i))
        losses.append(loss)
    return state, losses


# ---------------------------------------------------------------------------
# the ZeRO step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("zero3", [False, True])
def test_zero_step_spans_follow_the_plan(zero3, tmp_path):
    """One ``zero.pull`` a forward bucket (and, under ZeRO-3, one a
    backward bucket holding a middle layer), one ``zero.backward`` and one
    ``zero.push`` a backward bucket, one forward and one optimizer update;
    in the step's order, none inside another."""
    cfg = _cfg()
    tr = _trainer(cfg, zero3=zero3)
    state = tr.init_state(torch.Generator().manual_seed(0))
    _, spans, _ = _traced(lambda: tr.step(state, _batch(cfg)), tmp_path)
    Ls = tr.num_layers
    repulls = sum(any(0 < l < Ls - 1 for l in b) for b in PLAN.backward)
    assert _counts(spans) == {
        "zero.pull": len(PLAN.forward) + (repulls if zero3 else 0),
        "zero.forward": 1, "zero.backward": len(PLAN.backward),
        "zero.push": len(PLAN.backward), "zero.optimizer": 1}
    order = sorted((s for s in spans if s[0].startswith(tracing.PREFIX)),
                   key=lambda s: s[1])
    names = [s[0][len(tracing.PREFIX) + len("zero."):] for s in order]
    pull_back = ["pull"] if zero3 else []
    assert names == ["pull"] * len(PLAN.forward) + ["forward"] + (
        ["backward", "push"] + pull_back + ["backward", "push"]) \
        + ["optimizer"]
    for a, b in zip(order, order[1:]):
        assert a[2] <= b[1], (a, b)


def test_moe_step_spans_route_and_backward(tmp_path):
    """Each MoE layer routes twice a step (the forward and the recompute),
    inside ``zero.forward`` and ``zero.backward``; its backward is one
    ``moe.backward`` span inside ``zero.backward`` that covers the
    dispatch's and the combine's autograd nodes."""
    cfg = _moe_cfg()
    tr = _trainer(cfg)
    state = tr.init_state(torch.Generator().manual_seed(0))
    _, spans, nodes = _traced(lambda: tr.step(state, _batch(cfg)), tmp_path)
    layers = cfg.num_layers
    counts = _counts(spans)
    assert counts["moe.route"] == 2 * layers
    assert counts["moe.backward"] == layers
    routes = _named(spans, "moe.route")
    fwd, bwd = _named(spans, "zero.forward"), _named(spans, "zero.backward")
    assert sum(_inside(r, fwd) for r in routes) == layers
    assert sum(_inside(r, bwd) for r in routes) == layers
    backs = _named(spans, "moe.backward")
    assert all(_inside(b, bwd) for b in backs)
    moe_nodes = [n for n in nodes if n[0].endswith(MOE_NODES)]
    assert len(moe_nodes) == len(MOE_NODES) * layers
    assert all(_inside(n, backs) for n in moe_nodes)
    for b in backs:
        assert sum(_inside(n, [b]) for n in moe_nodes) == len(MOE_NODES)


def test_kept_share_counts_the_routed_keep(tmp_path, monkeypatch):
    """Under the profiler the counters hold the assignments and the kept
    ones of every routing the step made: their share is the mean of
    ``Routing.keep`` over the same calls, and the MoE drops some."""
    cfg = _moe_cfg()
    tr = _trainer(cfg)
    state = tr.init_state(torch.Generator().manual_seed(0))
    keeps, route = [], moe.route

    def keeping(probs, c, cap):
        r = route(probs, c, cap)
        keeps.append(r.keep)
        return r

    monkeypatch.setattr(moe, "route", keeping)
    tracing.reset_counters()
    _traced(lambda: tr.step(state, _batch(cfg)), tmp_path)
    c = tracing.counters()
    tracing.reset_counters()
    assert len(keeps) == 2 * cfg.num_layers
    assert c["moe.assignments"] == sum(k.numel() for k in keeps)
    assert c["moe.kept"] == int(sum(k.sum() for k in keeps))
    share = c["moe.kept"] / c["moe.assignments"]
    assert share == float(torch.cat(keeps).double().mean())
    assert 0.0 < share < 1.0
    assert isinstance(c["moe.kept"], int)
    assert tracing.counters() == {}


def _hybrid_cfg():
    """Two Mamba-2 layers of granite-4.0-h-small (4 sched layers, as
    ``PLAN``), experts 2-3 of 8 held, chunk 8 over T = 16."""
    return dataclasses.replace(
        _cfg("granite-4.0-h-small"), num_experts=8, top_k=2,
        experts_first=2, experts_held=2, mamba_chunk=8)


def test_mamba_spans_mixer_scan_and_backward(tmp_path):
    """Each Mamba-2 layer opens ``mamba.mixer`` twice a step (the forward,
    inside ``zero.forward``, and the recompute, inside ``zero.backward``),
    with one ``mamba.scan`` inside each; its backward is one
    ``mamba.backward`` span inside ``zero.backward``."""
    cfg = _hybrid_cfg()
    assert cfg.layer_kinds() == ("mamba2", "mamba2")
    tr = _trainer(cfg)
    state = tr.init_state(torch.Generator().manual_seed(0))
    _, spans, _ = _traced(lambda: tr.step(state, _batch(cfg)), tmp_path)
    tracing.reset_counters()
    counts = _counts(spans)
    assert (counts["mamba.mixer"], counts["mamba.scan"],
            counts["mamba.backward"]) == (4, 4, 2)
    mixers = _named(spans, "mamba.mixer")
    assert all(_inside(s, mixers) for s in _named(spans, "mamba.scan"))
    fwd, bwd = _named(spans, "zero.forward"), _named(spans, "zero.backward")
    assert sum(_inside(m, fwd) for m in mixers) == 2
    assert sum(_inside(m, bwd) for m in mixers) == 2
    assert all(_inside(b, bwd) for b in _named(spans, "mamba.backward"))


def test_held_share_counts_the_routed_assignments(tmp_path):
    """Under the profiler a step of a model holding 2 of 8 experts counts
    every assignment in ``moe.routed`` (N k a routing, twice a layer) and
    those to its experts in ``moe.assignments``."""
    cfg = _hybrid_cfg()
    tr = _trainer(cfg)
    state = tr.init_state(torch.Generator().manual_seed(0))
    tracing.reset_counters()
    _traced(lambda: tr.step(state, _batch(cfg)), tmp_path)
    c = tracing.counters()
    tracing.reset_counters()
    assert c["moe.routed"] == 2 * cfg.num_layers * 2 * 16 * cfg.top_k
    assert 0 < c["moe.kept"] <= c["moe.assignments"] < c["moe.routed"]


def test_without_a_profiler_no_mamba_span_is_entered(monkeypatch):
    """A ZeRO step of the hybrid with no profiler: ``record_function`` is
    never built, no backward hook is registered and no counter holds a
    value."""
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

    monkeypatch.setattr(tracing, "record_function", Counting)
    tracing.reset_counters()
    cfg = _hybrid_cfg()
    _two_steps(_trainer(cfg), cfg)
    assert entered == []
    assert tracing.counters() == {}


def test_tracing_changes_no_bit_of_the_hybrids_training(tmp_path):
    cfg = _hybrid_cfg()
    plain, plain_losses = _two_steps(_trainer(cfg), cfg)
    (traced, traced_losses), _, _ = _traced(
        lambda: _two_steps(_trainer(cfg), cfg), tmp_path)
    tracing.reset_counters()
    assert _equal(plain_losses, traced_losses)
    assert _equal(plain["flat_params"], traced["flat_params"])


def _mla_cfg():
    """Moonlight's two reduced blocks (4 sched layers, as ``PLAN``): the
    dense layer 0 and an MoE layer of 8 experts, top-2, both latent
    attention."""
    return _cfg("moonlight-16b-a3b", num_experts=8, top_k=2)


def test_mla_spans_attention_and_backward(tmp_path):
    """Each latent-attention layer opens ``mla.attention`` twice a step
    (the forward, inside ``zero.forward``, and the recompute, inside
    ``zero.backward``); its backward is one ``mla.backward`` span inside
    ``zero.backward``."""
    cfg = _mla_cfg()
    assert (cfg.layer_kinds(), cfg.mlp_kinds()) == (("mla", "mla"),
                                                    ("dense", "moe"))
    tr = _trainer(cfg)
    state = tr.init_state(torch.Generator().manual_seed(0))
    _, spans, _ = _traced(lambda: tr.step(state, _batch(cfg)), tmp_path)
    tracing.reset_counters()
    counts = _counts(spans)
    assert (counts["mla.attention"], counts["mla.backward"]) == (4, 2)
    mixers = _named(spans, "mla.attention")
    fwd, bwd = _named(spans, "zero.forward"), _named(spans, "zero.backward")
    assert sum(_inside(m, fwd) for m in mixers) == 2
    assert sum(_inside(m, bwd) for m in mixers) == 2
    assert all(_inside(b, bwd) for b in _named(spans, "mla.backward"))


def test_tracing_changes_no_bit_of_moonlights_training(tmp_path):
    cfg = _mla_cfg()
    plain, plain_losses = _two_steps(_trainer(cfg), cfg)
    (traced, traced_losses), _, _ = _traced(
        lambda: _two_steps(_trainer(cfg), cfg), tmp_path)
    tracing.reset_counters()
    assert _equal(plain_losses, traced_losses)
    assert _equal(plain["flat_params"], traced["flat_params"])


# ---------------------------------------------------------------------------
# the run-time loop and the decode
# ---------------------------------------------------------------------------


def _dynamic(cfg):
    return DynamicTrainer(cfg=cfg, optimizer=adamw(1e-3), device="cpu",
                          network=bandwidth_shift(10e9, 1e9, at_epoch=1),
                          steps_per_epoch=2, compute_flops_per_s=1e10,
                          cost_source="measured", measure_iters=1,
                          measure_warmup=1)


def test_replan_and_measure_spans_one_per_boundary(tmp_path):
    """Four steps of two-step epochs: two boundaries, each one
    ``runtime.replan`` span holding one ``runtime.measure`` span, and no
    step's spans inside a re-plan."""
    cfg = _cfg()
    dyn = _dynamic(cfg)
    data = SyntheticText(cfg.vocab_size, 16, 2, seed=0)

    def run():
        state = dyn.init_state(torch.Generator().manual_seed(0))
        return dyn.run(state, data.batch, 4)

    _, spans, _ = _traced(run, tmp_path)
    replans = _named(spans, "runtime.replan")
    measures = _named(spans, "runtime.measure")
    assert len(replans) == len(measures) == 2 == len(dyn.events)
    assert all(_inside(m, replans) for m in measures)
    assert _counts(spans)["zero.optimizer"] == 4
    steps = [s for s in spans if s[0].startswith(tracing.PREFIX + "zero.")]
    assert not any(_inside(s, replans) for s in steps)


def test_decode_spans_one_per_new_token(tmp_path):
    """One ``serve.decode_step`` a new token; the step hook runs outside
    every one of them."""
    cfg = _cfg()
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = _batch(cfg, b=2, t=12)["tokens"].to(torch.int32)
    marks = []

    def hook(i, logits, caches):
        with torch.profiler.record_function("hook"):
            marks.append(i)

    _, spans, _ = _traced(lambda: decode.batched_generate(
        cfg, params, prompts, max_new_tokens=5, on_step=hook), tmp_path)
    steps = _named(spans, "serve.decode_step")
    assert len(steps) == 5 and marks == list(range(6))
    hooks = [s for s in spans if s[0] == "hook"]
    assert len(hooks) == 6 and not any(_inside(h, steps) for h in hooks)


def test_nothing_is_counted_or_spanned_while_a_graph_is_captured(
        monkeypatch):
    """While the current stream captures a CUDA graph (here pretended),
    ``count`` adds nothing, with a tensor or an int, ``span`` enters no
    ``record_function`` and ``recording`` is false, even under the
    profiler: a graph captured under it is the one captured without it."""
    tracing.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
        assert tracing.capturing() and not tracing.recording()
        tracing.count("moe.kept", torch.tensor(3))
        tracing.count("moe.assignments", 4)
        assert tracing.span("serve.decode_step") is tracing._OFF
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: False)
        assert tracing.recording()
        tracing.count("moe.assignments", 4)
    try:
        assert tracing.counters() == {"moe.assignments": 4}
    finally:
        tracing.reset_counters()


def test_cpu_generate_makes_no_graph_and_counts_no_replay(tmp_path):
    """On the CPU ``batched_generate`` stays the eager loop: no key enters
    the graph store and, under the profiler, no capture or replay is
    counted."""
    cfg = _cfg()
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = _batch(cfg, b=2, t=12)["tokens"].to(torch.int32)
    before = dict(graphs._store)
    tracing.reset_counters()
    _traced(lambda: decode.batched_generate(cfg, params, prompts,
                                            max_new_tokens=4), tmp_path)
    try:
        c = tracing.counters()
        assert "serve.graph_replays" not in c
        assert "serve.graph_captures" not in c
        assert graphs._store == before
    finally:
        tracing.reset_counters()


# ---------------------------------------------------------------------------
# off: nothing entered; on: nothing changed
# ---------------------------------------------------------------------------


def test_without_a_profiler_no_span_is_entered(monkeypatch):
    """A MoE ZeRO step, a re-plan epoch and a decode with no profiler:
    ``record_function`` is never built and no counter holds a value."""
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tracing, "record_function", Counting)
    tracing.reset_counters()
    cfg = _moe_cfg()
    _two_steps(_trainer(cfg), cfg)
    dense = _cfg()
    dyn = _dynamic(dense)
    dyn.run(dyn.init_state(torch.Generator().manual_seed(0)),
            SyntheticText(dense.vocab_size, 16, 2, seed=0).batch, 3)
    params = model.init_params(dense, torch.Generator().manual_seed(0))
    decode.batched_generate(dense, params,
                            _batch(dense, t=8)["tokens"].to(torch.int32),
                            max_new_tokens=3)
    assert entered == []
    assert tracing.counters() == {}


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", ["granite-3-2b", "granite-moe-1b-a400m"])
def test_tracing_changes_no_bit_of_training(name, tmp_path):
    """Two ZeRO steps with the profiler and without it: the same losses,
    parameters and AdamW moments, bit for bit."""
    cfg = _moe_cfg() if name == "granite-moe-1b-a400m" else _cfg()
    plain, plain_losses = _two_steps(_trainer(cfg), cfg)
    (traced, traced_losses), _, _ = _traced(
        lambda: _two_steps(_trainer(cfg), cfg), tmp_path)
    tracing.reset_counters()
    assert _equal(plain_losses, traced_losses)
    assert _equal(plain["flat_params"], traced["flat_params"])
    assert _equal(plain["opt"].mu, traced["opt"].mu)
    assert _equal(plain["opt"].nu, traced["opt"].nu)
    assert int(plain["opt"].step) == int(traced["opt"].step) == 2


def test_tracing_changes_no_served_token(tmp_path):
    """The same greedy and sampled tokens with the profiler and without."""
    cfg = _cfg()
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = _batch(cfg, b=2, t=12)["tokens"].to(torch.int32)

    def serve():
        return [decode.batched_generate(
            cfg, params, prompts, max_new_tokens=6, greedy=greedy,
            generator=torch.Generator().manual_seed(5))
            for greedy in (True, False)]

    plain = serve()
    traced, _, _ = _traced(serve, tmp_path)
    assert _equal(plain, traced)
