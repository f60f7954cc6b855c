"""The ``dynamic`` runtime of the port (``repro_torch.dist.dynamic``) against
the reference's, on the CPU, and its claims re-proved torch against torch.

``examples/runtime_configs/dynamic.json`` (granite-3-2b reduced, batch 4,
seq 32, the uplink 10 → 1 Gbps at epoch 1, a re-plan every 2 steps) runs 6
steps in both packages from the reference's initial state, each scheduler
under the same fixed clock.  Exact: the plan sequence, every field of the
``RescheduleEvent`` stream, the planner's counters, the step cache's first
uses and hits, each plan's collective counts (the reference counts them in
the compiled HLO, the port counts the bucket collectives its step launches),
the ledgers, and the loop-state checkpoint's keys and JSON meta.  Losses:
rtol 1e-5 (another float32 sum order; measured on the CPU: 3.5e-7 over
these 6 steps, ``tests/helpers/torch_parity_report.py``).  Inside the
port: losses bitwise
equal to statically running the plan sequence, with and without async
planning, and across a save / restore in the middle of an epoch.
"""

import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.runtime import build_runtime as jax_build_runtime
from repro_torch.core import EwmaDriftDetector, bandwidth_shift
from repro_torch.data.pipeline import SyntheticText
from repro_torch.dist.dynamic import DynamicTrainer
from repro_torch.interop import zero_state_from_numpy
from repro_torch.optim import adamw
from repro_torch.runtime import RuntimeConfig, build_runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "examples", "runtime_configs")
LOSS_RTOL = 1e-5
STEPS = 6


def ticker():
    """A fixed clock: every reading half a second after the last."""
    t = [0.0]

    def clock():
        t[0] += 0.5
        return t[0]
    return clock


def event_fields(events):
    return [dataclasses.astuple(e) for e in events]


def plan_key(plan):
    """A plan of either package as plain tuples (the packages' BucketPlan
    classes differ, so their instances never compare equal)."""
    return plan.forward, plan.backward


def _config(**schedule):
    cfg = RuntimeConfig.load(os.path.join(CONFIGS, "dynamic.json"))
    return dataclasses.replace(cfg, schedule=dataclasses.replace(
        cfg.schedule, **schedule))


def _carry(rt, init):
    rt._state = zero_state_from_numpy(
        rt.trainer.base, init["flat_params"], init["opt"].mu, init["opt"].nu,
        int(init["opt"].step))


def _loop_npz(trainer, path):
    trainer.save_loop_state(path)
    with np.load(path) as f:
        return sorted(f.files), json.loads(str(f["meta"]))


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    rt = jax_build_runtime(JaxRuntimeConfig.load(
        os.path.join(CONFIGS, "dynamic.json")))
    rt.trainer.scheduler.clock = ticker()
    init = jax.tree_util.tree_map(np.asarray, rt._state)
    losses = rt.fit(STEPS)
    tr = rt.trainer
    keys, meta = _loop_npz(tr, str(tmp_path_factory.mktemp("ref") / "l.npz"))
    return dict(init=init, losses=losses, events=event_fields(tr.events),
                stats=tr.planner_stats, traces=tr.traces,
                hits=tr.cache_hits, ledger=rt.ledger,
                counts={plan_key(p): tr.hlo_counts(p) for p in tr.plans_seen},
                plans=[plan_key(p) for p in tr.plans_seen], keys=keys,
                meta=meta)


def test_dynamic_matches_reference(reference_run, tmp_path):
    ref = reference_run
    rt = build_runtime(_config(), device="cpu")
    rt.trainer.scheduler.clock = ticker()
    _carry(rt, ref["init"])
    losses = rt.fit(STEPS)
    tr = rt.trainer
    assert event_fields(tr.events) == ref["events"]
    assert [e.plan_changed for e in tr.events] == [False, True, False]
    assert tr.planner_stats == ref["stats"]
    assert (tr.traces, tr.cache_hits) == (ref["traces"], ref["hits"]) \
        == (2, 0)
    assert [plan_key(p) for p in tr.plans_seen] == ref["plans"]
    assert {plan_key(p): tr.collective_counts(p)
            for p in tr.plans_seen} == ref["counts"]
    for p in tr.plans_seen:
        assert tr.collective_counts(p) == (len(p.forward), len(p.backward))
    assert rt.ledger == ref["ledger"]
    keys, meta = _loop_npz(tr, str(tmp_path / "loop.npz"))
    assert keys == ref["keys"]
    assert meta == ref["meta"]
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)


def _static_losses(events, steps_per_epoch, steps):
    """The plan sequence of ``events`` run by plain ``ZeroTrainer.step``
    calls, from the dynamic runtime's initial state."""
    rt = build_runtime(_config(), device="cpu")
    plan_at = {e.epoch: e.plan for e in events}
    zero = rt.trainer.base
    state = zero.init_state(torch.Generator().manual_seed(0))
    pipe = SyntheticText(rt.arch.vocab_size, rt.config.seq, rt.config.batch,
                         seed=rt.config.seed)
    losses = []
    for i in range(steps):
        trainer = zero.with_plan(plan_at[i // steps_per_epoch])
        state, loss = trainer.step(state, pipe.batch(i))
        losses.append(float(loss))
    return losses


def test_losses_bitwise_static_sequence_and_async():
    """A live plan swap changes no bit: the dynamic run equals the static
    plan sequence, and async planning changes only where the DP runs."""
    runs = {}
    for async_planning in (False, True):
        rt = build_runtime(_config(async_planning=async_planning),
                           device="cpu")
        rt.trainer.scheduler.clock = ticker()
        runs[async_planning] = (rt.fit(STEPS), event_fields(rt.trainer.events),
                                rt.trainer.planner_stats)
        if async_planning:
            rt.trainer.planner.close()
    (sync_losses, sync_events, _), (async_losses, async_events, stats) = \
        runs[False], runs[True]
    assert async_losses == sync_losses
    assert async_events == sync_events
    assert stats["async_submitted"] >= 1
    events = build_runtime(_config(), device="cpu")
    events.fit(STEPS)
    assert _static_losses(events.trainer.events, 2, STEPS) == sync_losses


def _trainer(**kw):
    from repro_torch.configs import get_config
    base = dict(cfg=get_config("granite-3-2b").reduced(),
                optimizer=adamw(1e-3), device="cpu",
                network=bandwidth_shift(10e9, 1e9, at_epoch=2),
                steps_per_epoch=2, compute_flops_per_s=1e10)
    base.update(kw)
    return DynamicTrainer(**base)


@pytest.fixture(scope="module")
def pipe():
    from repro_torch.configs import get_config
    return SyntheticText(get_config("granite-3-2b").reduced().vocab_size, 32,
                         4, seed=0)


def test_resume_mid_epoch_is_bitwise(pipe, tmp_path):
    """The reference's ``TestDynamicLoopStateSingleDevice`` resume case:
    stop after step 3 (mid-epoch), restore the loop state into a fresh
    trainer, and the remaining losses and the event history are the
    straight run's."""
    ref = _trainer()
    state = ref.init_state(torch.Generator().manual_seed(0))
    state, ref_losses = ref.run(state, pipe.batch, STEPS)

    a = _trainer()
    sa = a.init_state(torch.Generator().manual_seed(0))
    losses = []
    for i in range(3):
        sa, loss = a.step(sa, pipe.batch(i))
        losses.append(float(loss))
    path = str(tmp_path / "loop.npz")
    a.save_loop_state(path)
    b = _trainer()
    b.restore_loop_state(path)
    assert b.step_index == 3 and b.plan == a.plan
    assert [e.step for e in b.events] == [e.step for e in a.events]
    for i in range(3, STEPS):
        sa, loss = b.step(sa, pipe.batch(i))
        losses.append(float(loss))
    assert losses == ref_losses
    assert [(e.step, e.epoch, e.plan) for e in b.events] == \
        [(e.step, e.epoch, e.plan) for e in ref.events]
    assert len(b.events) == len(ref.events)    # the rebuild is no event


def test_runtime_save_restore_mid_epoch_is_bitwise(tmp_path):
    path = str(tmp_path / "state.npz")
    rt = build_runtime(_config(), device="cpu")
    rt.fit(3)
    rt.save_state(path)
    tail = rt.fit(3)
    again = build_runtime(_config(), device="cpu")
    again.restore_state(path)
    assert again.fit(3) == tail
    assert event_fields(again.trainer.events)[:2] == \
        event_fields(rt.trainer.events)[:2]


class ScriptedTimes(EwmaDriftDetector):
    """The real EWMA detector fed a scripted step-time stream (the host's
    clock is not steady enough to script a shift with)."""

    def __init__(self, times, **kw):
        super().__init__(**kw)
        self._times = list(times)

    def update(self, seconds):
        return super().update(self._times.pop(0))


def test_drift_detector_forces_exactly_one_reschedule(pipe):
    """A persistent step-time shift (1 s → 2 s from step 5) fires the
    detector once, on the shift's second step, and the next step re-plans
    with trigger "drift" while the epoch alignment is kept."""
    det = ScriptedTimes([1.0] * 5 + [2.0] * 5, warmup=2, patience=2,
                        threshold=0.3)
    dyn = _trainer(drift_detector=det, steps_per_epoch=100)
    state = dyn.init_state(torch.Generator().manual_seed(0))
    for i in range(10):
        state, _ = dyn.step(state, pipe.batch(i))
    assert det.num_triggers == 1
    assert [(e.step, e.trigger) for e in dyn.events] == \
        [(0, "epoch"), (7, "drift")]
    assert dyn.scheduler._iter_seen == 10


def test_constructor_validation():
    with pytest.raises(ValueError, match="steps_per_epoch"):
        _trainer(steps_per_epoch=0)
    with pytest.raises(ValueError, match="cost_source"):
        _trainer(cost_source="psychic")
    with pytest.raises(ValueError, match="remeasure_every"):
        _trainer(remeasure_every=-1)


# ---------------------------------------------------------------------------
# the plan-step cache and the bucket collectives' launch counters
# ---------------------------------------------------------------------------


def _bucket_step(ag, rs):
    """A fake step that pulls a two-layer bucket ``ag`` times and pushes it
    ``rs`` times through the package's bucket collectives (one rank)."""
    from repro_torch.dist.collectives import (flatten_tree, gather_bucket,
                                              make_flat_spec,
                                              reduce_scatter_bucket)
    from repro_torch.dist.zero import default_group
    default_group(torch.device("cpu"))
    layer = {"w": torch.ones(3), "b": torch.zeros(2)}
    specs = [make_flat_spec(layer, 1)] * 2
    shards = [flatten_tree(layer, specs[0])] * 2

    def run(state, batch):
        for _ in range(ag):
            gather_bucket(shards, specs, (0, 1))
        for _ in range(rs):
            reduce_scatter_bucket({0: layer, 1: layer}, specs, (1, 0))
        return state, batch
    return run


def test_plan_step_cache_counts_first_uses_hits_and_collectives():
    from repro_torch.core import BucketPlan
    from repro_torch.runtime.replan import PlanStepCache

    a = BucketPlan(forward=((0, 1),), backward=((1, 0),))
    b = BucketPlan(forward=((0,), (1,)), backward=((1,), (0,)))
    cache = PlanStepCache()
    fn, retraced = cache.step_for(a, lambda: _bucket_step(1, 1),
                                  count_hit=True)
    assert retraced and cache.traces == 1
    with pytest.raises(KeyError, match="has not run"):
        cache.collective_counts(a)
    fn(None, None)
    fn(None, None)
    fn_b, _ = cache.step_for(b, lambda: _bucket_step(2, 3), count_hit=True)
    fn_b(None, None)
    again, retraced = cache.step_for(a, lambda: _bucket_step(9, 9),
                                     count_hit=True)
    assert again is fn and not retraced and cache.hits == 1
    cache.step_for(a, lambda: _bucket_step(9, 9), count_hit=False)
    assert cache.hits == 1 and cache.traces == 2
    assert cache.collective_counts(a) == (1, 1)
    assert cache.collective_counts(b) == (2, 3)
    assert cache.plans == (a, b)


@pytest.mark.parametrize("ag,rs", [(0, 0), (1, 0), (0, 2), (3, 1)])
def test_bucket_collectives_count_where_they_launch(ag, rs):
    """Each pull adds one to the all-gather count, each push one to the
    reduce-scatter count, and nothing else moves them."""
    from repro_torch.dist.collectives import collective_counts
    run = _bucket_step(ag, rs)
    before = collective_counts()
    run(None, None)
    after = collective_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (ag, rs)


# ---------------------------------------------------------------------------
# measured costs
# ---------------------------------------------------------------------------


def test_measured_costs_sample_every_layer(pipe):
    """``warmup + iters`` samples per (phase, layer), finite positive
    medians, and the plan is the planner's decision on those costs."""
    from repro_torch.core import schedule
    dyn = _trainer(cost_source="measured", measure_iters=2,
                   measure_warmup=1, steps_per_epoch=1)
    state = dyn.init_state(torch.Generator().manual_seed(0))
    state, _ = dyn.step(state, pipe.batch(0))
    L = dyn.base.num_layers
    for phase in ("fc", "bc"):
        for layer in range(L):
            assert dyn.hook.num_samples(phase, layer) == 3
    costs = dyn._costs
    for v in (costs.fc, costs.bc):
        assert v.shape == (L,) and np.all(np.isfinite(v)) and np.all(v > 0)
    assert dyn.events[0].plan == dyn.plan
    from repro_torch.core import plan_from_decision
    assert dyn.plan == plan_from_decision(*schedule(costs, "dynacomm"), L)
    assert dyn._measured_epoch == 0
    # the cache the costs came from, served as it is within the epoch
    fc, bc = dyn.measured_times(0)
    assert np.array_equal(fc, costs.fc) and np.array_equal(bc, costs.bc)


def test_measured_plan_equals_reference_on_fixed_times(pipe, monkeypatch):
    """With the hook fed fixed synthetic times, the port's plan per epoch
    is the reference's decision on the same times."""
    from repro import core as ref_core
    from repro.configs import get_config as ref_get_config
    from repro.models import model as ref_model
    import repro_torch.runtime.replan as port_replan

    L = 4
    fc = np.array([1e-3, 4e-3, 4e-3, 2e-3])

    def synthetic(cfg, layout, state, batch, hook, *, aux_weight, device,
                  iters):
        hook.reset()
        for l in range(L):
            for _ in range(hook.warmup + iters):
                hook.record("fc", l, fc[l])
                hook.record("bc", l, 2 * fc[l])

    monkeypatch.setattr(port_replan, "measure_layer_times", synthetic)
    dyn = _trainer(cost_source="measured", steps_per_epoch=1,
                   network=bandwidth_shift(10e9, 1e9, at_epoch=1))
    state = dyn.init_state(torch.Generator().manual_seed(0))
    for i in range(2):
        state, _ = dyn.step(state, pipe.batch(i))

    cfg = ref_get_config("granite-3-2b").reduced()
    pb = np.asarray(ref_model.sched_layer_bytes(cfg), np.float64)
    planner = ref_core.Planner()
    want = []
    for bw in (10e9, 1e9):
        hook = ref_core.LayerTimingHook(warmup=1)
        for l in range(L):
            for _ in range(4):
                hook.record("fc", l, fc[l])
                hook.record("bc", l, 2 * fc[l])
        costs = hook.costs(param_bytes=pb,
                           net=ref_core.EdgeNetworkModel(bandwidth_bps=bw))
        want.append(ref_core.plan_from_decision(
            *planner.decide(costs, "dynacomm"), L))
    assert [plan_key(e.plan) for e in dyn.events] == \
        [plan_key(p) for p in want]
    assert dyn.planner_stats == planner.stats.as_dict()


class _Standin:
    """Looks like a CUDA tensor to ``_block``."""

    is_cuda = True

    def __init__(self, device):
        self.device = device


@pytest.mark.parametrize("make", [
    lambda a, b: (a, b), lambda a, b: [a, [b]], lambda a, b: {"x": a, "y": (b,)},
    lambda a, b: a])
def test_block_synchronises_any_structure(make, monkeypatch):
    from repro_torch.core.profiler import _block
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    a, b = _Standin("cuda:0"), _Standin("cuda:1")
    out = make(a, b)
    assert _block(out) is out
    want = {"cuda:0", "cuda:1"} if out is not a else {"cuda:0"}
    assert set(synced) == want and len(synced) == len(want)
    synced.clear()
    assert _block((torch.ones(2), [torch.zeros(1)], {"k": 3})) is not None
    assert synced == []                       # nothing on a card: no wait


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

FLAG_SETS = [
    ["--runtime", "dynamic", "--reduced", "--steps-per-epoch", "2",
     "--batch", "4", "--seq", "32", "--bw-shift-gbps", "1"],
    ["--runtime", "dynamic", "--cost-source", "measured", "--drift-detect",
     "--async-planning", "--plan-cache-size", "8", "--shift-epoch", "3",
     "--bw-shift-gbps", "2"],
    ["--runtime", "dynamic-ps", "--reduced", "--steps-per-epoch", "4",
     "--batch", "4", "--seq", "32", "--up-gbps", "10", "--up-shift-gbps",
     "1", "--compress", "int8"],
    ["--runtime", "zero", "--strategy", "lbl", "--steps-per-epoch", "3"],
    ["--runtime", "ps", "--ps-servers", "3", "--compress", "topk",
     "--topk-fraction", "0.02", "--no-error-feedback"],
]


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_launcher_dumps_the_references_config(flags, capsys, monkeypatch):
    from repro.launch.train import main as ref_main
    from repro_torch.launch.train import main
    main(flags + ["--dump-config"])
    mine = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["train"] + flags + ["--dump-config"])
    ref_main()
    assert mine == capsys.readouterr().out
    assert RuntimeConfig.from_json(mine).runtime == flags[1]


def test_launcher_runs_dynamic_on_cpu(capsys):
    from repro_torch.launch.train import main
    losses = main(["--config", os.path.join(CONFIGS, "dynamic.json"),
                   "--steps", "3", "--log-every", "0", "--device", "cpu"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "2 pull / 2 push segments (collectives 2 ag / 2 rs)  unchanged" \
        in out
    assert "3 pull / 3 push segments (collectives 3 ag / 3 rs)  " \
        "re-segmented" in out
    assert "[dynamic] traces 2, cache hits 0" in out


def test_launcher_prints_no_events_for_static_runtimes(capsys):
    from repro_torch.launch.train import main
    main(["--config", os.path.join(CONFIGS, "local.json"), "--steps", "1",
          "--log-every", "0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[local] 1 steps" in out and "traces" not in out
