"""The synchronous ``ps`` runtime of the port against the reference's, on
the CPU: ``examples/runtime_configs/ps.json`` plain, with int8 pushes and
with top-k (fraction 0.01) pushes.

Exact: topologies and their cost projections (with the compressor), the
consensus plans, wire bytes, ledgers, timelines, checkpoint keys, and the
compression of the reference's own gradients.  To tolerance: 3-step losses
at rtol 1e-5 for all three (measured on the CPU over 5 steps: plain 1.6e-7,
int8 4.6e-7, top-k 1.5e-7 relative).  The gradients of the two frameworks
differ by an ulp or two (another sum order), and a compressed push rounds
that difference through a quantization step or a top-k choice, but on
these inputs no quantization or choice flips far enough to show.  Inside
the port, plain ``ps`` equals ``zero`` bitwise.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import CompressionConfig as JaxCompressionConfig
from repro.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.runtime import build_runtime as jax_build_runtime
from repro_torch.interop import zero_state_from_numpy
from repro_torch.runtime import (CompressionConfig, RuntimeConfig,
                                 TopologyConfig, build_runtime)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "examples", "runtime_configs")
LOSS_RTOL = 1e-5
SCHEMES = {"none": None, "int8": None, "topk": 0.01}


def _config(scheme="none", **changes):
    cfg = RuntimeConfig.load(os.path.join(CONFIGS, "ps.json"))
    return dataclasses.replace(cfg, compression=CompressionConfig(
        scheme, topk_fraction=SCHEMES[scheme]), **changes)


def _jax_config(scheme="none"):
    cfg = JaxRuntimeConfig.load(os.path.join(CONFIGS, "ps.json"))
    return dataclasses.replace(cfg, compression=JaxCompressionConfig(
        scheme, topk_fraction=SCHEMES[scheme]))


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def reference_runs():
    out = {}
    for scheme in SCHEMES:
        rt = jax_build_runtime(_jax_config(scheme))
        init = _np_tree(rt._state)
        out[scheme] = dict(rt=rt, init=init, losses=rt.fit(3),
                           ledger=rt.ledger, plan=rt.plan,
                           makespan=rt.timeline().makespan)
    return out


def _carry_state(rt, init):
    """The reference's initial state in the port (residuals start at 0 in
    both)."""
    rt._state = zero_state_from_numpy(
        rt.trainer, init["flat_params"], init["opt"].mu, init["opt"].nu,
        int(init["opt"].step))
    if "residuals" in init:
        assert all(not r.any() for r in init["residuals"])
        assert all(not r.any() for r in rt._state["residuals"])


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_topology_costs_equal_reference(scheme, reference_runs):
    ref = reference_runs[scheme]["rt"]
    rt = build_runtime(_config(scheme), device="cpu")
    mine = rt.trainer.topology_costs(rt.shape)
    theirs = ref.trainer.topology_costs(ref.shape)
    assert rt.trainer.topology.num_servers == \
        ref.trainer.topology.num_servers == 2
    assert len(mine.workers) == len(theirs.workers) == 1
    for a, b in zip(mine.workers, theirs.workers):
        for field in ("pt", "fc", "bc", "gt"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
        assert (a.dt, a.dt_bwd) == (b.dt, b.dt_bwd)


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_plan_ledger_and_timeline_equal_reference(scheme, reference_runs):
    ref = reference_runs[scheme]
    rt = build_runtime(_config(scheme), device="cpu")
    assert (rt.plan.forward, rt.plan.backward) == \
        (ref["plan"].forward, ref["plan"].backward)
    tr, jtr = rt.trainer, ref["rt"].trainer
    assert tr.expected_transfers == jtr.expected_transfers
    assert tr.segment_owners() == jtr.segment_owners()
    assert tr.transfer_bytes() == jtr.transfer_bytes()
    assert tr.transfer_wire_bytes() == jtr.transfer_wire_bytes()
    assert rt.timeline().makespan == ref["makespan"]
    assert tr.estimated_step_seconds(rt.shape) == \
        jtr.estimated_step_seconds(ref["rt"].shape)
    rt.fit(3)
    assert rt.ledger == ref["ledger"]


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_losses_match_reference(scheme, reference_runs):
    ref = reference_runs[scheme]
    rt = build_runtime(_config(scheme), device="cpu")
    _carry_state(rt, ref["init"])
    np.testing.assert_allclose(rt.fit(3), ref["losses"], rtol=LOSS_RTOL)


def test_int8_and_topk_push_ratios():
    ratios = {}
    for scheme in ("int8", "topk"):
        rt = build_runtime(_config(scheme), device="cpu")
        rt.fit(1)
        ratios[scheme] = rt.ledger["push_compression_ratio"]
    assert 3.9 < ratios["int8"] < 4.0
    assert 49 < ratios["topk"] < 51


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compression_bitwise_on_the_references_own_gradients(scheme):
    """One jitted reference step with a spy compressor that keeps the
    corrected gradient as its "residual" hands over the reference's own
    gradients; the port's feedback round trip of them gives the residuals
    of the reference's real step bit for bit (for int8 that needs the
    fused multiply-add of the residual, see ``Int8Compressor``)."""
    from repro.compress.compressor import Int8Compressor as JaxInt8
    from repro.compress.compressor import TopKCompressor as JaxTopK
    from repro.ps import PSTrainer as JaxPSTrainer
    from repro_torch.compress import make_compressor
    base = {"int8": JaxInt8, "topk": JaxTopK}[scheme]

    @dataclasses.dataclass(frozen=True)
    class Spy(base):
        def feedback_roundtrip(self, flat, residual):
            corrected = flat + residual
            return self.roundtrip(corrected), corrected

    jrt = jax_build_runtime(_jax_config(scheme))
    batch = jrt._batch_fn(0)
    real, _ = jrt._step_fn(jrt._state, batch)
    tr = jrt.trainer
    kwargs = {"fraction": 0.01} if scheme == "topk" else {}
    spy = JaxPSTrainer(cfg=tr.cfg, mesh=tr.mesh, plan=tr.plan,
                       optimizer=tr.optimizer, topology=tr.topology,
                       compressor=Spy(error_feedback=True, use_kernel=False,
                                      **kwargs))
    fresh = jax_build_runtime(_jax_config(scheme))
    spied, _ = jax.jit(spy.build_train_step())(fresh._state, batch)
    comp = make_compressor(scheme, topk_fraction=SCHEMES[scheme])
    for grad, want in zip(spied["residuals"], real["residuals"]):
        flat = torch.from_numpy(np.array(grad[0]))
        residual = torch.zeros_like(flat)
        comp.feedback_roundtrip(flat, residual)
        np.testing.assert_array_equal(residual.numpy().view(np.int32),
                                      np.asarray(want[0]).view(np.int32))


def test_plain_ps_equals_zero_bitwise():
    """Sync PS is the ZeRO step (the reference asserts the same)."""
    zero = build_runtime(RuntimeConfig.load(os.path.join(
        CONFIGS, "zero.json")), device="cpu").fit(3)
    assert build_runtime(_config(), device="cpu").fit(3) == zero


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_save_restore_with_residuals_bitwise(scheme, tmp_path,
                                             reference_runs):
    path = str(tmp_path / "state.npz")
    rt = build_runtime(_config(scheme), device="cpu")
    rt.fit(2)
    assert any(r.abs().sum() > 0 for r in rt._state["residuals"])
    rt.save_state(path)
    tail = rt.fit(2)
    again = build_runtime(_config(scheme), device="cpu")
    again.restore_state(path)
    for a, b in zip(again._state["residuals"],
                    build_runtime(_config(scheme), device="cpu")._state[
                        "residuals"]):
        assert a.shape == b.shape
    assert again.fit(2) == tail
    # the reference's checkpoint keys
    jpath = str(tmp_path / "reference.npz")
    reference_runs[scheme]["rt"].save_state(jpath)
    with np.load(path) as mine, np.load(jpath) as theirs:
        assert sorted(mine.files) == sorted(theirs.files)
        assert any(k.startswith("model/residuals") or "residuals" in k
                   for k in mine.files)
        for k in mine.files:
            assert mine[k].shape == theirs[k].shape, k


def test_reference_checkpoint_with_residuals_resumes_in_port(tmp_path):
    path = str(tmp_path / "int8.npz")
    jrt = jax_build_runtime(_jax_config("int8"))
    jrt.fit(1)
    jrt.save_state(path)
    rt = build_runtime(_config("int8"), device="cpu")
    rt.restore_state(path)
    for mine, theirs in zip(rt._state["residuals"],
                            jrt._state["residuals"]):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs)[0])
    np.testing.assert_allclose(rt.fit(2), jrt.fit(2), rtol=LOSS_RTOL)


def test_no_error_feedback_keeps_no_residuals():
    cfg = dataclasses.replace(_config(), compression=CompressionConfig(
        "int8", error_feedback=False))
    rt = build_runtime(cfg, device="cpu")
    assert "residuals" not in rt._state
    assert np.isfinite(rt.fit(2)).all()


def test_scheme_none_compressor_is_dropped():
    from repro_torch.compress import Compressor
    from repro_torch.dist.zero import ZeroTrainer
    from repro_torch.ps import PSTrainer
    rt = build_runtime(_config(), device="cpu")
    assert rt.trainer.compressor is None
    tr = rt.trainer
    again = PSTrainer(cfg=tr.cfg, plan=tr.plan, optimizer=tr.optimizer,
                      topology=tr.topology, device="cpu",
                      compressor=Compressor())
    assert again.compressor is None and again._zero.compressor is None
    zero = ZeroTrainer(cfg=tr.cfg, plan=tr.plan, optimizer=tr.optimizer,
                       device="cpu", compressor=Compressor())
    assert zero.compressor is None


def test_worker_count_must_equal_the_group():
    from repro_torch.ps import PSTopology, PSTrainer
    rt = build_runtime(_config(), device="cpu")
    tr = rt.trainer
    with pytest.raises(ValueError, match="topology has 3 workers"):
        PSTrainer(cfg=tr.cfg, plan=tr.plan, optimizer=tr.optimizer,
                  topology=PSTopology.uniform(2, 3), device="cpu")
    cfg = dataclasses.replace(_config(), schedule=dataclasses.replace(
        _config().schedule, topology=TopologyConfig(workers=2)))
    with pytest.raises(ValueError, match="topology has 2 workers"):
        build_runtime(cfg, device="cpu")


def test_topology_config_builds_the_references_topology():
    from repro.runtime import TopologyConfig as JaxTopologyConfig
    for kwargs in (dict(), dict(servers=3, down_gbps=(10.0, 5.0),
                                up_gbps=0.5, worker_flops=(1e10, 2e10)),
                   dict(up_shift_factor=4.0, shift_epoch=2, workers=2)):
        mine = TopologyConfig(**kwargs).build(default_workers=1)
        theirs = JaxTopologyConfig(**kwargs).build(default_workers=1)
        assert type(mine).__name__ == type(theirs).__name__
        topos = ([(0, mine)], [(0, theirs)]) if not hasattr(mine, "knots") \
            else (mine.knots, theirs.knots)
        for (e1, a), (e2, b) in zip(*topos):
            assert e1 == e2 and a.num_servers == b.num_servers
            assert a.worker_flops == b.worker_flops
            for la, lb in zip(a.links, b.links):
                for d in ("down", "up"):
                    x, y = getattr(la, d), getattr(lb, d)
                    assert (x.bandwidth_bps, x.rtt_s, x.setup_s, x.dt) == \
                        (y.bandwidth_bps, y.rtt_s, y.setup_s, y.dt)


def test_with_plan_keeps_the_state():
    from repro_torch.core import BucketPlan
    want = build_runtime(_config("int8"), device="cpu").fit(3)
    rt = build_runtime(_config("int8"), device="cpu")
    got = rt.fit(1)
    n = rt.trainer.num_layers
    per_layer = BucketPlan(forward=tuple((l,) for l in range(n)),
                           backward=tuple((l,) for l in reversed(range(n))))
    rt.trainer = rt.trainer.with_plan(per_layer)
    assert rt.plan == per_layer and rt.trainer.compressor is not None
    got += rt.fit(2)
    assert got == want


def test_launcher_compress_flags(capsys):
    from repro_torch.launch.train import main
    cfg = os.path.join(CONFIGS, "ps.json")
    plain = main(["--config", cfg, "--steps", "2", "--log-every", "0",
                  "--device", "cpu"])
    assert "push wire" not in capsys.readouterr().out
    for scheme, ratio in (("int8", "3.97x"), ("topk", "49.99x")):
        losses = main(["--config", cfg, "--steps", "2", "--log-every", "0",
                       "--device", "cpu", "--compress", scheme])
        out = capsys.readouterr().out
        assert f"({scheme}, {ratio} vs fp32)" in out
        assert "1 pull / 2 push buckets" in out
        assert losses[0] == plain[0] and np.isfinite(losses).all()
    main(["--runtime", "ps", "--reduced", "--compress", "topk",
          "--topk-fraction", "0.05", "--no-error-feedback",
          "--ps-servers", "3", "--up-gbps", "0.5", "--dump-config"])
    dumped = RuntimeConfig.from_json(capsys.readouterr().out)
    assert dumped.runtime == "ps"
    assert dumped.compression == CompressionConfig(
        "topk", topk_fraction=0.05, error_feedback=False)
    assert dumped.schedule.topology.servers == 3
    assert dumped.schedule.topology.up_gbps == 0.5


def test_compressed_kernels_never_launch_on_the_cpu_path():
    from repro_torch.kernels import launch_counts
    before = launch_counts()
    build_runtime(_config("topk"), device="cpu").fit(1)
    assert launch_counts() == before


def test_global_residuals_have_the_references_layout():
    """The reference keeps one (A, padded) float32 residual per sched
    layer; the port's global state has the same shapes and dtype."""
    jrt = jax_build_runtime(_jax_config("int8"))
    rt = build_runtime(_config("int8"), device="cpu")
    whole = rt.trainer.global_state(rt._state)
    for mine, theirs in zip(whole["residuals"], jrt._state["residuals"]):
        assert tuple(mine.shape) == tuple(theirs.shape)
        assert theirs.dtype == jnp.float32 and mine.dtype == torch.float32
