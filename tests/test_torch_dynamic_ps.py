"""The synchronous ``dynamic-ps`` runtime of the port
(``repro_torch.ps.dynamic``) against the reference's, on the CPU.

``examples/runtime_configs/dynamic_ps.json`` (granite-3-2b reduced, batch
4, seq 32, 2 servers, every uplink 10 → 1 Gbps at epoch 1, a consensus
re-plan every 2 steps) runs 6 steps in both packages from the reference's
initial state, plain and with int8 pushes, each scheduler under the same
fixed clock.  Exact, as in ``tests/test_torch_dynamic.py``: plans, the
event stream, planner counters, step-cache counts, per-plan collective
counts, ledgers (wire bytes included), the loop-state checkpoint, and the
re-plan timelines.  Losses: rtol 1e-5 (measured on the CPU over these 6
steps: plain 3.5e-7, int8 4.2e-7, ``tests/helpers/torch_parity_report.py``).
The plain run must re-segment its pushes at the shift; the int8 run, whose
compressed pushes stay cheap, must keep its plan, as in the reference.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.runtime import CompressionConfig as JaxCompressionConfig
from repro.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.runtime import build_runtime as jax_build_runtime
from repro_torch.interop import zero_state_from_numpy
from repro_torch.runtime import (CompressionConfig, RuntimeConfig,
                                 build_runtime)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "examples", "runtime_configs")
LOSS_RTOL = 1e-5
STEPS = 6
SCHEMES = ("none", "int8")


def ticker():
    t = [0.0]

    def clock():
        t[0] += 0.5
        return t[0]
    return clock


def plan_key(plan):
    return plan.forward, plan.backward


def _config(scheme):
    cfg = RuntimeConfig.load(os.path.join(CONFIGS, "dynamic_ps.json"))
    return dataclasses.replace(cfg, compression=CompressionConfig(scheme))


def _summary(rt, path):
    """Everything the two packages must agree on exactly after a run."""
    tr = rt.trainer
    tr.save_loop_state(path)
    with np.load(path) as f:
        keys, meta = sorted(f.files), json.loads(str(f["meta"]))
    counts = getattr(tr, "collective_counts", None) or tr.hlo_counts
    rp = tr.replan_timeline()
    return dict(
        events=[dataclasses.astuple(e) for e in tr.events],
        stats=tr.planner_stats, traces=tr.traces, hits=tr.cache_hits,
        counts=[(plan_key(p), counts(p)) for p in tr.plans_seen],
        ledger=rt.ledger, keys=keys, meta=meta,
        makespans=(rp.makespans, rp.frozen_makespans),
        timeline=rt.timeline().makespan)


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    out = {}
    for scheme in SCHEMES:
        cfg = dataclasses.replace(
            JaxRuntimeConfig.load(os.path.join(CONFIGS, "dynamic_ps.json")),
            compression=JaxCompressionConfig(scheme))
        rt = jax_build_runtime(cfg)
        rt.trainer.scheduler.clock = ticker()
        init = jax.tree_util.tree_map(np.asarray, rt._state)
        losses = rt.fit(STEPS)
        path = str(tmp_path_factory.mktemp(scheme) / "loop.npz")
        out[scheme] = dict(init=init, losses=losses,
                           summary=_summary(rt, path))
    return out


@pytest.mark.parametrize("scheme", SCHEMES)
def test_dynamic_ps_matches_reference(scheme, reference_runs, tmp_path):
    ref = reference_runs[scheme]
    rt = build_runtime(_config(scheme), device="cpu")
    rt.trainer.scheduler.clock = ticker()
    init = ref["init"]
    rt._state = zero_state_from_numpy(
        rt.trainer.base, init["flat_params"], init["opt"].mu, init["opt"].nu,
        int(init["opt"].step))
    losses = rt.fit(STEPS)
    mine = _summary(rt, str(tmp_path / "loop.npz"))
    assert mine == ref["summary"]
    changed = [e.plan_changed for e in rt.trainer.events]
    assert changed == ([False, True, False] if scheme == "none"
                       else [False, False, False])
    for plan in rt.trainer.plans_seen:
        assert rt.trainer.collective_counts(plan) == \
            (len(plan.forward), len(plan.backward))
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_losses_bitwise_static_plan_sequence(scheme):
    """The dynamic run equals each epoch's plan run statically through
    the sync PS step, and the same run with async planning."""
    from repro_torch.data.pipeline import SyntheticText
    runs = []
    for async_planning in (False, True):
        cfg = _config(scheme)
        cfg = dataclasses.replace(cfg, schedule=dataclasses.replace(
            cfg.schedule, async_planning=async_planning))
        rt = build_runtime(cfg, device="cpu")
        runs.append((rt.fit(STEPS),
                     [plan_key(e.plan) for e in rt.trainer.events]))
        if async_planning:
            rt.trainer.planner.close()
    assert runs[0] == runs[1]
    base = rt.trainer.base
    state = base.init_state(torch.Generator().manual_seed(0))
    pipe = SyntheticText(rt.arch.vocab_size, cfg.seq, cfg.batch, seed=0)
    plans = {e.epoch: e.plan for e in rt.trainer.events}
    static = []
    for i in range(STEPS):
        state, loss = base.with_plan(plans[i // 2]).step(state, pipe.batch(i))
        static.append(float(loss))
    assert static == runs[0][0]


def test_overhead_hidden_is_the_table_one_predicate():
    rt = build_runtime(_config("none"), device="cpu")
    rt.fit(4)
    for e in rt.trainer.events:
        window = rt.trainer.costs_for_epoch(e.epoch).idle_window
        assert e.overhead_hidden == (e.scheduling_seconds <= window)
        assert e.scheduling_seconds >= 0


def test_measured_costs_project_onto_the_topology(monkeypatch):
    """Measured fc/bc (fixed synthetic times here) reach the consensus
    plan through ``topology_costs_measured``, as in the reference."""
    import repro_torch.runtime.replan as port_replan
    from repro.core import Planner as RefPlanner
    from repro.core import plan_from_decision
    from repro.ps import PSTopology as RefPSTopology
    from repro.ps import uplink_degradation as ref_uplink_degradation
    from repro.configs import get_config as ref_get_config
    from repro.configs.base import InputShape as RefInputShape
    from repro.models.profiles import layer_profiles as ref_profiles

    fc = np.array([1e-3, 4e-3, 4e-3, 2e-3])

    def synthetic(cfg, layout, state, batch, hook, *, aux_weight, device,
                  iters):
        hook.reset()
        for l in range(len(fc)):
            for _ in range(hook.warmup + iters):
                hook.record("fc", l, fc[l])
                hook.record("bc", l, 2 * fc[l])

    monkeypatch.setattr(port_replan, "measure_layer_times", synthetic)
    cfg = _config("none")
    cfg = dataclasses.replace(
        cfg, measure=dataclasses.replace(cfg.measure, cost_source="measured"))
    rt = build_runtime(cfg, device="cpu")
    rt.fit(4)
    got = [plan_key(e.plan) for e in rt.trainer.events]

    arch = ref_get_config("granite-3-2b").reduced()
    profiles = ref_profiles(arch, RefInputShape("runtime", 32, 4, "train"))
    base = RefPSTopology.uniform(2, 1, down_bps=10e9, up_bps=10e9, flops=1e10)
    sched = ref_uplink_degradation(base, factor=10.0, at_epoch=1)
    planner = RefPlanner()
    want = []
    for epoch in range(2):
        costs = sched.topology_at(epoch).topology_costs_measured(
            profiles, fc=fc, bc=2 * fc)
        (f, b), _ = planner.consensus(costs, "dynacomm")
        want.append(plan_key(plan_from_decision(f, b, len(fc))))
    assert got == want
    assert rt.trainer.planner_stats == planner.stats.as_dict()


def test_constructor_validation():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.optim import adamw
    from repro_torch.ps import DynamicPSTrainer, PSTopology
    kw = dict(cfg=get_config("granite-3-2b").reduced(), optimizer=adamw(1e-3),
              input_shape=InputShape("x", 32, 4, "train"), device="cpu")
    with pytest.raises(ValueError, match="steps_per_epoch"):
        DynamicPSTrainer(topology=PSTopology.uniform(1, 1), steps_per_epoch=0,
                         **kw)
    with pytest.raises(ValueError, match="workers"):
        # a 4-worker topology on a 1-rank group
        DynamicPSTrainer(topology=PSTopology.uniform(1, 4),
                         steps_per_epoch=2, **kw)
