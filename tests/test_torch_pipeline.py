"""The pipeline runtime (``repro_torch.pipeline``) against the reference's
``repro.pipeline`` on the CPU.

Host modules (schedules, simulated timelines, partitions, boundary costs,
transfer plans, planner stats) are plain Python and must equal the
reference's exactly.  The trainer starts from the reference's
``init_state(PRNGKey(0))``, carried across as numpy, on reduced
granite-3-2b (d_model 256, vocab 512, 2 blocks: 4 sched layers), batch 4 x
seq 16, AdamW 1e-3, 2 steps.  Tolerances, each with its reason:

* losses rtol 1e-5: XLA and PyTorch sum forward, backward and AdamW in
  another order (measured at most 1.90e-7 relative);
* final flat parameters, per sched layer, relative L2 2e-5 and
  elementwise 2·lr·steps: AdamW's first steps are sign-like (±lr wherever
  |g| ≫ eps), so a roundoff difference in a near-zero gradient can move an
  element by up to 2·lr a step (measured: relative L2 at most 5.56e-6,
  the largest elementwise gap 2.62e-4, in 49 of 131,072 elements of a
  block);
* ledgers, partitions, activation bytes, plans, timelines and checkpoint
  keys exactly.

Inside the port, torch against torch, the pipeline proves what the
reference claims but cannot show across XLA programs: losses bitwise
across stage counts at one micro-batch, across S ∈ {2, 4} at two, and
between the GPipe and 1F1B orders; S = 1, M = 1 is bitwise the ZeRO step
on one rank.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import InputShape as JaxInputShape
from repro.core import EdgeNetworkModel as JaxEdgeNetworkModel
from repro.core import Planner as JaxPlanner
from repro.core import costs_from_profiles as jax_costs_from_profiles
from repro.models.profiles import layer_profiles as jax_layer_profiles
from repro.optim import adamw as jax_adamw
from repro import pipeline as jp
from repro.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.runtime import build_runtime as jax_build_runtime
from repro_torch import pipeline as tp
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import EdgeNetworkModel, Planner, costs_from_profiles
from repro_torch.dist.collectives import collective_counts
from repro_torch.interop import zero_state_from_numpy
from repro_torch.models.profiles import layer_profiles
from repro_torch.optim import adamw
from repro_torch.runtime import PipelineConfig, RuntimeConfig, build_runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "examples", "runtime_configs")
LOSS_RTOL = 1e-5
FLAT_REL_L2 = 2e-5
LR = 1e-3
S1_S2_RTOL = 1e-6    # the embedding grouping at M > 1 (9.5e-8 measured)
STEPS = 2
BANDWIDTH = 0.1e9    # tests/test_pipeline.py::test_transfer_plans_ride_...
CHUNKS = 2
RUNS = [(1, 1, "1f1b"), (2, 1, "1f1b"), (4, 1, "1f1b"), (1, 2, "1f1b"),
        (2, 2, "1f1b"), (4, 2, "1f1b"), (2, 2, "gpipe")]


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _plan_fields(p):
    return (p.boundary, p.decision, p.fwd_time, p.bwd_time,
            p.whole_fwd_time, p.whole_bwd_time, p.fwd_compute_s,
            p.bwd_compute_s, p.microbatches, p.chunks, p.speedup,
            p.effective_waits, p.whole_waits)


def _timeline_fields(tl):
    return (tl.makespan, tl.stage_busy, tl.stage_idle, tl.task_times,
            tl.bubble_fraction)


def _schedule_fields(sched):
    return (sched.name, sched.num_stages, sched.num_microbatches,
            tuple(tuple((t.stage, t.microbatch, t.kind) for t in stream)
                  for stream in sched.streams))


@pytest.fixture(scope="module")
def tiny():
    """Both packages' reduced granite-3-2b, one seeded batch, and the
    reference test's cost vectors and network (0.1 Gbps, 1e10 FLOP/s)."""
    rng = np.random.default_rng(3)
    cfg = get_config("granite-3-2b").reduced()
    toks = rng.integers(0, cfg.vocab_size, size=(4, 16)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    shape = ("t", 16, 4, "train")
    jnet = JaxEdgeNetworkModel(bandwidth_bps=BANDWIDTH)
    net = EdgeNetworkModel(bandwidth_bps=BANDWIDTH)
    jcfg = jax_get_config("granite-3-2b").reduced()
    return dict(
        cfg=cfg, jcfg=jcfg, net=net, jnet=jnet,
        batch={"tokens": torch.from_numpy(toks).long(),
               "labels": torch.from_numpy(labels).long()},
        jbatch={"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
        costs=costs_from_profiles(layer_profiles(cfg, InputShape(*shape)),
                                  net=net, compute_flops_per_s=1e10),
        jcosts=jax_costs_from_profiles(
            jax_layer_profiles(jcfg, JaxInputShape(*shape)), net=jnet,
            compute_flops_per_s=1e10))


@pytest.fixture(scope="module")
def reference_runs(tiny):
    """Each (S, M, schedule) of ``RUNS`` in the reference: 2 steps from
    ``init_state(PRNGKey(0))`` (the same initial state for every S)."""
    out = {}
    for S, M, name in RUNS:
        tr = jp.PipelineTrainer(
            cfg=tiny["jcfg"], optimizer=jax_adamw(LR), num_stages=S,
            num_microbatches=M, schedule_name=name, costs=tiny["jcosts"],
            net=tiny["jnet"], transfer_chunks=CHUNKS)
        state = tr.init_state(jax.random.PRNGKey(0))
        init = _np(state)
        losses = []
        for _ in range(STEPS):
            state, loss = tr.step(state, tiny["jbatch"])
            losses.append(float(loss))
        out[S, M, name] = dict(
            init=init, losses=losses, flats=_np(state["flat_params"]),
            ledger=tr.ledger, segments=tr.partition.segments,
            activation_bytes=tr.activation_bytes(),
            plans=[_plan_fields(p) for p in tr.transfer_plans()] if S > 1
            else [], timeline=_timeline_fields(tr.timeline()))
    return out


def _port_trainer(tiny, S, M, name="1f1b", **kw):
    return tp.PipelineTrainer(
        cfg=tiny["cfg"], optimizer=adamw(LR), device="cpu", num_stages=S,
        num_microbatches=M, schedule_name=name, costs=tiny["costs"],
        net=tiny["net"], transfer_chunks=CHUNKS, **kw)


def _port_run(tiny, init, S, M, name="1f1b", **kw):
    tr = _port_trainer(tiny, S, M, name, **kw)
    state = zero_state_from_numpy(
        tr, init["flat_params"], init["opt"].mu, init["opt"].nu,
        int(init["opt"].step))
    losses = []
    for _ in range(STEPS):
        state, loss = tr.step(state, tiny["batch"])
        losses.append(float(loss))
    return tr, state, losses


@pytest.fixture(scope="module")
def port_runs(tiny, reference_runs):
    init = reference_runs[RUNS[0]]["init"]
    return {key: _port_run(tiny, init, *key) for key in RUNS}


# ---------------------------------------------------------------------------
# host modules: exactly the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", tp.SCHEDULES)
def test_schedules_equal_the_reference(name):
    assert tp.SCHEDULES == jp.SCHEDULES
    for S in range(1, 6):
        for M in range(1, 7):
            assert _schedule_fields(tp.make_schedule(name, S, M)) == \
                _schedule_fields(jp.make_schedule(name, S, M))
            assert tp.analytic_bubble_fraction(S, M) == \
                jp.analytic_bubble_fraction(S, M)


@pytest.mark.parametrize("name,S,M", [("gpipe", 1, 1), ("1f1b", 2, 4),
                                      ("gpipe", 3, 2), ("1f1b", 4, 8),
                                      ("1f1b", 5, 3)])
def test_simulate_equals_the_reference(name, S, M):
    rng = np.random.default_rng(S * 10 + M)
    fwd, bwd = rng.uniform(0.1, 2.0, S), rng.uniform(0.1, 4.0, S)
    fx, bx = rng.uniform(0.0, 0.5, S - 1), rng.uniform(0.0, 0.5, S - 1)
    for kw in ({}, {"fwd_transfer": fx, "bwd_transfer": bx}):
        mine = tp.simulate(tp.make_schedule(name, S, M), fwd, bwd, **kw)
        theirs = jp.simulate(jp.make_schedule(name, S, M), fwd, bwd, **kw)
        assert _timeline_fields(mine) == _timeline_fields(theirs)


@pytest.mark.parametrize("seed", range(6))
def test_partition_loads_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    L = int(rng.integers(1, 30))
    loads = rng.uniform(0.01, 100.0, L).tolist()
    for S in sorted({1, min(2, L), min(4, L), L}):
        mine, theirs = tp.partition_loads(loads, S), \
            jp.partition_loads(loads, S)
        assert (mine.segments, mine.loads, mine.bottleneck,
                mine.stage_of) == (theirs.segments, theirs.loads,
                                   theirs.bottleneck, theirs.stage_of)


@pytest.mark.parametrize("stages", [2, 4])
def test_partition_profiles_at_full_width(stages):
    """granite-3-2b at its published widths, batch 2 x seq 1024, 1e10
    FLOP/s: the split the card's pipeline phase asserts."""
    shape = ("runtime", 1024, 2, "train")
    mine = tp.partition_profiles(
        layer_profiles(get_config("granite-3-2b"), InputShape(*shape)),
        stages, compute_flops_per_s=1e10)
    theirs = jp.partition_profiles(
        jax_layer_profiles(jax_get_config("granite-3-2b"),
                           JaxInputShape(*shape)),
        stages, compute_flops_per_s=1e10)
    assert mine.as_dict() == theirs.as_dict()
    if stages == 2:
        assert mine.segments == ((1, 22), (23, 42))
    with pytest.raises(ValueError, match="stages"):
        tp.partition_profiles(layer_profiles(
            get_config("granite-3-2b"), InputShape(*shape)), 43)


def test_full_width_plans_and_timeline_equal_the_reference():
    """granite-3-2b at its published widths, batch 2 x seq 1024, under
    ``pipeline.json``'s pipeline, schedule and measure blocks (the card's
    pipeline phase): each package's trainer built as its
    ``PipelineRuntime`` builds it, without weights, boundary layouts from
    the batch's shapes.  Partition, activation bytes, transfer plans and
    the simulated timeline equal the reference's."""
    from repro.runtime import NetworkConfig as JaxNetworkConfig
    from repro_torch.runtime import NetworkConfig
    config = RuntimeConfig.load(os.path.join(CONFIGS, "pipeline.json"))
    pcfg, flops = config.pipeline, config.measure.compute_flops_per_s
    assert config.schedule.network is None
    shape = ("runtime", 1024, 2, "train")
    common = dict(num_stages=pcfg.stages, num_microbatches=pcfg.microbatches,
                  schedule_name=pcfg.schedule, aux_weight=config.aux_weight,
                  transfer_strategy=config.schedule.strategy,
                  transfer_chunks=pcfg.chunks)
    trainers = []
    for mod, cfg, profiles_fn, shape_cls, costs_fn, planner, net, extra in (
            (tp, get_config("granite-3-2b"), layer_profiles, InputShape,
             costs_from_profiles, Planner, NetworkConfig().build(),
             dict(optimizer=adamw(LR), device="cpu")),
            (jp, jax_get_config("granite-3-2b"), jax_layer_profiles,
             JaxInputShape, jax_costs_from_profiles, JaxPlanner,
             JaxNetworkConfig().build(), dict(optimizer=jax_adamw(LR)))):
        profiles = profiles_fn(cfg, shape_cls(*shape))
        trainers.append(mod.PipelineTrainer(
            cfg=cfg, partition=mod.partition_profiles(
                profiles, pcfg.stages, compute_flops_per_s=flops),
            planner=planner(cache_size=config.schedule.plan_cache_size),
            costs=costs_fn(profiles, net=net, compute_flops_per_s=flops),
            net=net, **common, **extra))
    mine, theirs = trainers
    toks = np.zeros((2, 1024), np.int32)
    mine.prepare({"tokens": torch.from_numpy(toks).long(),
                  "labels": torch.from_numpy(toks).long()})
    theirs._ensure_compiled({"tokens": jnp.asarray(toks),   # shapes only
                             "labels": jnp.asarray(toks)})
    assert mine.partition.as_dict() == theirs.partition.as_dict()
    assert mine.activation_bytes() == theirs.activation_bytes() == \
        [2 // pcfg.microbatches * 1024 * 2048 * 4] * (pcfg.stages - 1)
    assert [_plan_fields(p) for p in mine.transfer_plans()] == \
        [_plan_fields(p) for p in theirs.transfer_plans()]
    assert _timeline_fields(mine.timeline()) == \
        _timeline_fields(theirs.timeline())


@pytest.mark.parametrize("seed", range(5))
def test_boundary_costs_and_plans_equal_the_reference(seed):
    rng = np.random.default_rng(100 + seed)
    nbytes = float(rng.uniform(1e4, 1e8))
    M, chunks = int(rng.integers(1, 7)), int(rng.integers(1, 5))
    f, b = float(rng.uniform(1e-4, 0.5)), float(rng.uniform(1e-4, 0.5))
    kw = dict(stage_fwd_s=f, stage_bwd_s=b, chunks=chunks)
    mine = tp.boundary_costs(nbytes, M, net=EdgeNetworkModel(
        bandwidth_bps=BANDWIDTH), **kw)
    theirs = jp.boundary_costs(nbytes, M, net=JaxEdgeNetworkModel(
        bandwidth_bps=BANDWIDTH), **kw)
    for field in ("pt", "fc", "bc", "gt"):
        np.testing.assert_array_equal(getattr(mine, field),
                                      getattr(theirs, field))
    assert mine.dt == theirs.dt
    assert tp.whole_tensor_decision(mine) == jp.whole_tensor_decision(theirs)
    for strategy in ("dynacomm", "lbl", "sequential"):
        assert _plan_fields(tp.plan_boundary(
            0, mine, strategy=strategy, microbatches=M, chunks=chunks)) == \
            _plan_fields(jp.plan_boundary(
                0, theirs, strategy=strategy, microbatches=M, chunks=chunks))
    # two homogeneous boundaries through a planner: one solve, one hit
    planners = Planner(cache_size=8), JaxPlanner(cache_size=8)
    for mod, costs, planner in ((tp, mine, planners[0]),
                                (jp, theirs, planners[1])):
        for boundary in (0, 1):
            mod.plan_boundary(boundary, costs, planner=planner,
                              microbatches=M, chunks=chunks)
    assert planners[0].stats.as_dict() == planners[1].stats.as_dict()
    assert (planners[0].stats.solves, planners[0].stats.hits) == (1, 1)


# ---------------------------------------------------------------------------
# the trainer against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", RUNS, ids=[f"S{s}M{m}-{n}"
                                           for s, m, n in RUNS])
def test_trainer_matches_the_reference(tiny, reference_runs, port_runs, key):
    ref = reference_runs[key]
    tr, state, losses = port_runs[key]
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
    for mine, theirs in zip(state["flat_params"], ref["flats"]):
        gap = mine.numpy().astype(np.float64) - theirs
        assert np.linalg.norm(gap) <= FLAT_REL_L2 * np.linalg.norm(theirs)
        assert np.abs(gap).max() <= 2 * LR * STEPS
    assert tr.ledger == ref["ledger"]
    assert tp.EMBED_LINK == jp.EMBED_LINK == -1
    if key[0] > 1:
        assert tp.EMBED_LINK in tr.ledger["boundary_pull_bytes"]
    assert tr.partition.segments == ref["segments"]
    assert tr.activation_bytes() == ref["activation_bytes"]
    assert [_plan_fields(p) for p in tr.transfer_plans() or []] == \
        ref["plans"]
    assert _timeline_fields(tr.timeline()) == ref["timeline"]


def test_activation_bytes_need_a_step_or_prepare(tiny):
    tr = _port_trainer(tiny, 2, 2)
    with pytest.raises(RuntimeError, match="run a step first"):
        tr.activation_bytes()
    assert tr.transfer_plans() is None
    tr.prepare(tiny["batch"])             # shapes only: no step, no ledger
    assert tr.activation_bytes() == [2 * 16 * tiny["cfg"].d_model * 4]
    assert tr.ledger["num_pulls"] == 0 and len(tr.transfer_plans()) == 1


# ---------------------------------------------------------------------------
# inside the port, torch against torch
# ---------------------------------------------------------------------------


def test_losses_bitwise_across_stage_counts_at_one_microbatch(port_runs):
    want = port_runs[1, 1, "1f1b"]
    for S in (2, 4):
        _, state, losses = port_runs[S, 1, "1f1b"]
        assert losses == want[2]
        for a, b in zip(state["flat_params"], want[1]["flat_params"]):
            assert torch.equal(a, b)


def test_losses_bitwise_across_stage_counts_past_one_stage(port_runs):
    _, s2, l2 = port_runs[2, 2, "1f1b"]
    _, s4, l4 = port_runs[4, 2, "1f1b"]
    assert l2 == l4
    for a, b in zip(s2["flat_params"], s4["flat_params"]):
        assert torch.equal(a, b)


def test_gpipe_bitwise_one_f_one_b(port_runs):
    _, a, la = port_runs[2, 2, "gpipe"]
    _, b, lb = port_runs[2, 2, "1f1b"]
    assert la == lb
    for x, y in zip(a["flat_params"], b["flat_params"]):
        assert torch.equal(x, y)


def test_one_stage_against_two_at_two_microbatches(port_runs):
    """S = 1 against S = 2 at M = 2 agree to fp32 roundoff, not bitwise:
    with the head on the embedding's stage the tied embedding's gradient
    is summed per micro-batch as ``(e_0 + h_0) + (e_1 + h_1)`` (embedding
    path plus head path); with the head on a later stage it is ``(e_0 +
    e_1) + (h_0 + h_1)`` (the reference's grouping, trainer.py:314–318 and
    511–520).  The losses of step 1 are equal (no gradient yet); step 2's
    measured 9.5e-8 apart."""
    _, _, l1 = port_runs[1, 2, "1f1b"]
    _, _, l2 = port_runs[2, 2, "1f1b"]
    assert l1[0] == l2[0]
    np.testing.assert_allclose(l1, l2, rtol=S1_S2_RTOL)


def test_one_stage_is_the_zero_step_on_one_rank(tiny, reference_runs,
                                                port_runs):
    """S = 1, M = 1 is bitwise the port's ``zero`` runtime (world 1) on
    the same weights and batch."""
    init = reference_runs[RUNS[0]]["init"]
    rt = build_runtime(RuntimeConfig(runtime="zero", reduced=True, batch=4,
                                     seq=16, lr=LR), device="cpu")
    try:
        tr = rt.trainer
        state = zero_state_from_numpy(
            tr, init["flat_params"], init["opt"].mu, init["opt"].nu,
            int(init["opt"].step))
        losses = []
        for _ in range(STEPS):
            state, loss = tr.step(state, tiny["batch"])
            losses.append(float(loss))
    finally:
        torch.distributed.destroy_process_group()
    _, pipe, want = port_runs[1, 1, "1f1b"]
    assert losses == want
    for a, b in zip(state["flat_params"], pipe["flat_params"]):
        assert torch.equal(a, b)


def test_stage_devices_on_one_device_are_bitwise_none(tiny, reference_runs,
                                                      port_runs):
    init = reference_runs[RUNS[0]]["init"]
    _, state, losses = _port_run(tiny, init, 2, 2,
                                 stage_devices=["cpu", "cpu"])
    _, want, want_losses = port_runs[2, 2, "1f1b"]
    assert losses == want_losses
    for a, b in zip(state["flat_params"], want["flat_params"]):
        assert torch.equal(a, b)


def test_a_step_launches_no_collective(monkeypatch):
    """No process group and no collective: every byte between stages
    moves through the boundary buffers the ledger accounts."""
    import repro_torch.dist.zero as zero

    def refuse(*_a, **_k):
        raise AssertionError("the pipeline asked for a process group")
    monkeypatch.setattr(zero, "default_group", refuse)
    monkeypatch.setattr(torch.distributed, "init_process_group", refuse)
    rt = build_runtime(RuntimeConfig.load(os.path.join(
        CONFIGS, "pipeline.json")), device="cpu")
    before = collective_counts()
    losses = rt.fit(1)
    assert collective_counts() == before
    assert np.isfinite(losses[0]) and not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# wiring
# ---------------------------------------------------------------------------


def test_pipeline_config_validation():
    with pytest.raises(ValueError, match="schedule"):
        PipelineConfig(schedule="interleaved")
    with pytest.raises(ValueError, match="pipeline"):
        RuntimeConfig(runtime="zero", batch=2, seq=16,
                      pipeline=PipelineConfig())
    with pytest.raises(ValueError, match="divisible|microbatches"):
        RuntimeConfig(runtime="pipeline", batch=3, seq=16,
                      pipeline=PipelineConfig(microbatches=2))
    assert RuntimeConfig(runtime="pipeline", batch=4,
                         seq=16).pipeline is not None


def test_smoke_config_builds_and_steps_on_the_cpu():
    cfg = RuntimeConfig.load(os.path.join(CONFIGS, "pipeline.json"))
    rt = build_runtime(cfg, device="cpu")
    assert rt.trainer.device == torch.device("cpu")
    losses = rt.fit(1)
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert rt.partition.num_stages == cfg.pipeline.stages
    assert rt.ledger["num_pulls"] > 0
    assert rt.ledger["push_compression_ratio"] == 1.0
    assert rt.timeline().makespan > 0


def test_save_restore_resumes_bitwise(tmp_path):
    cfg = RuntimeConfig.load(os.path.join(CONFIGS, "pipeline.json"))
    rt = build_runtime(cfg, device="cpu")
    rt.fit(2)
    path = str(tmp_path / "pipe.npz")
    rt.save_state(path)
    cont = rt.fit(2)
    again = build_runtime(cfg, device="cpu")
    again.restore_state(path)
    assert again.fit(2) == cont


def test_checkpoint_keys_equal_the_references(tmp_path):
    """The same keys as the reference's ``{"model": {"flat_params",
    "opt", "step"}}``, and a checkpoint the reference wrote resumes in the
    port to the reference's losses."""
    path = str(tmp_path / "ref.npz")
    jrt = jax_build_runtime(JaxRuntimeConfig.load(os.path.join(
        CONFIGS, "pipeline.json")))
    jrt.fit(1)
    jrt.save_state(path)
    rt = build_runtime(RuntimeConfig.load(os.path.join(
        CONFIGS, "pipeline.json")), device="cpu")
    mine = str(tmp_path / "port.npz")
    rt.save_state(mine)
    with np.load(path) as a, np.load(mine) as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.startswith("model/flat_params") for k in a.files)
    rt.restore_state(path)
    np.testing.assert_allclose(rt.fit(2), jrt.fit(2), rtol=LOSS_RTOL)


def test_launcher_flags_need_the_pipeline_runtime():
    from repro_torch.launch.train import main
    with pytest.raises(SystemExit, match="--runtime pipeline"):
        main(["--runtime", "local", "--stages", "2", "--steps", "1",
              "--device", "cpu"])


def test_launcher_runs_the_pipeline_on_the_cpu(capsys):
    from repro_torch.launch.train import main
    losses = main(["--config", os.path.join(CONFIGS, "pipeline.json"),
                   "--steps", "2", "--log-every", "0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[pipeline] arch granite-3-2b (reduced), strategy dynacomm, " \
        "S=2 M=2 (1f1b), device cpu" in out
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "(6 pulls, 8 pushes)" in out


@pytest.mark.parametrize("flags", [
    ["--runtime", "pipeline", "--reduced", "--batch", "4", "--seq", "16"],
    ["--runtime", "pipeline", "--stages", "4", "--microbatches", "2",
     "--pipeline-schedule", "gpipe", "--transfer-chunks", "3",
     "--bw-gbps", "1"]])
def test_launcher_dumps_the_references_config(flags, capsys, monkeypatch):
    import sys
    from repro.launch.train import main as ref_main
    from repro_torch.launch.train import main
    main(flags + ["--dump-config"])
    mine = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["train"] + flags + ["--dump-config"])
    ref_main()
    assert mine == capsys.readouterr().out
    assert RuntimeConfig.from_json(mine).pipeline is not None


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def test_microbatch_divisibility_enforced(tiny):
    tr = _port_trainer(tiny, 2, 3)
    state = tr.init_state(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="divisible"):
        tr.step(state, tiny["batch"])


@pytest.mark.parametrize("stages", [0, 5])
def test_stage_count_outside_the_layers(tiny, stages):
    with pytest.raises(ValueError, match=r"num_stages must be in \[1, 4\]"):
        _port_trainer(tiny, stages, 1)
    with pytest.raises(ValueError, match="num_microbatches"):
        _port_trainer(tiny, 1, 0)
    with pytest.raises(ValueError, match="one device per stage"):
        _port_trainer(tiny, 2, 1, stage_devices=["cpu"])
