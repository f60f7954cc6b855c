"""The slice as a whole: the checked-in smoke configs through the port's
``build_runtime(device="cpu")`` against ``repro.runtime.build_runtime`` on
one JAX CPU device, with the reference's weights carried across.

Tolerances, each with its reason: losses over 3 steps rtol 1e-5 — the
float32 sums of forward, backward and AdamW run in another order in XLA
and in PyTorch (measured on the CPU over 5 steps: at most 1.6e-7, one or
two float32 ulps of the loss); plans, ledgers and checkpoint layouts are exact;
everything the port claims inside itself (strategies, ZeRO-3, resume) is
bitwise.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.runtime import build_runtime as jax_build_runtime
from repro_torch.interop import params_from_numpy, zero_state_from_numpy
from repro_torch.runtime import RuntimeConfig, build_runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "examples", "runtime_configs")
LOSS_RTOL = 1e-5
STRATEGIES = ("sequential", "lbl", "ibatch", "dynacomm")


def _config(name, **changes):
    cfg = RuntimeConfig.load(os.path.join(CONFIGS, f"{name}.json"))
    return dataclasses.replace(cfg, **changes)


def _with_strategy(cfg, strategy, **execution):
    return dataclasses.replace(
        cfg, schedule=dataclasses.replace(cfg.schedule, strategy=strategy),
        execution=dataclasses.replace(cfg.execution, **execution))


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def reference_runs():
    """Each smoke config in the reference: initial state and 3 losses."""
    out = {}
    for name in ("zero", "local"):
        rt = jax_build_runtime(JaxRuntimeConfig.load(
            os.path.join(CONFIGS, f"{name}.json")))
        if name == "zero":
            init = _np_tree(rt._state)
        else:
            init = _np_tree(rt._params)
        out[name] = dict(init=init, losses=rt.fit(3), ledger=rt.ledger,
                         plan=getattr(rt, "plan", None))
    return out


def test_zero_matches_reference(reference_runs):
    ref = reference_runs["zero"]
    rt = build_runtime(_config("zero"), device="cpu")
    assert (rt.plan.forward, rt.plan.backward) == \
        (ref["plan"].forward, ref["plan"].backward)
    state = ref["init"]
    rt._state = zero_state_from_numpy(
        rt.trainer, state["flat_params"], state["opt"].mu, state["opt"].nu,
        int(state["opt"].step))
    for mine, theirs in zip(rt._state["flat_params"], state["flat_params"]):
        np.testing.assert_array_equal(mine.numpy(), theirs)
    losses = rt.fit(3)
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
    assert rt.ledger == ref["ledger"]


def test_local_matches_reference(reference_runs):
    ref = reference_runs["local"]
    rt = build_runtime(_config("local"), device="cpu")
    rt._params = params_from_numpy(ref["init"], requires_grad=True)
    rt._opt_state = rt.optimizer.init(
        [p for p in jax.tree_util.tree_leaves(rt._params)])
    losses = rt.fit(3)
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
    assert rt.ledger == ref["ledger"]


@pytest.mark.parametrize("name", ["zero", "local"])
def test_reference_checkpoint_resumes_in_port(name, tmp_path):
    """A checkpoint the reference wrote restores into the port (same keys,
    same layout) and training goes on to the reference's losses."""
    path = str(tmp_path / f"{name}.npz")
    jrt = jax_build_runtime(JaxRuntimeConfig.load(
        os.path.join(CONFIGS, f"{name}.json")))
    jrt.fit(1)
    jrt.save_state(path)
    rt = build_runtime(_config(name), device="cpu")
    rt.restore_state(path)
    np.testing.assert_allclose(rt.fit(2), jrt.fit(2), rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", ["zero", "local"])
def test_save_restore_resumes_bitwise(name, tmp_path):
    path = str(tmp_path / "state.npz")
    rt = build_runtime(_config(name), device="cpu")
    rt.fit(2)
    rt.save_state(path)
    tail = rt.fit(2)
    again = build_runtime(_config(name), device="cpu")
    again.restore_state(path)
    assert again.fit(2) == tail


def test_restore_refuses_another_runtimes_checkpoint(tmp_path):
    path = str(tmp_path / "local.npz")
    build_runtime(_config("local"), device="cpu").save_state(path)
    with pytest.raises(ValueError, match="written by runtime 'local'"):
        build_runtime(_config("zero"), device="cpu").restore_state(path)


def test_losses_bitwise_across_strategies_and_zero3():
    """The paper's "accuracy untouched", re-proved torch against torch."""
    base = _config("zero")
    runs = {}
    for strategy in STRATEGIES:
        for zero3 in (False, True):
            rt = build_runtime(_with_strategy(base, strategy, zero3=zero3),
                               device="cpu")
            runs[strategy, zero3] = (rt.fit(3), rt.plan)
    want = runs["dynacomm", False][0]
    assert all(losses == want for losses, _ in runs.values())
    plans = {(p.forward, p.backward) for _, p in runs.values()}
    assert len(plans) > 1            # the strategies really differ


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("zero3", [False, True])
def test_one_collective_per_bucket(strategy, zero3, monkeypatch):
    """A recording wrapper around torch.distributed stands in for the
    reference's HLO count: one all-gather per forward bucket (plus the
    ZeRO-3 re-pulls) and one reduce-scatter per backward bucket."""
    rt = build_runtime(_with_strategy(_config("zero"), strategy,
                                      zero3=zero3), device="cpu")
    calls = []
    for op in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        real = getattr(dist, op)
        monkeypatch.setattr(dist, op, lambda *a, _op=op, _real=real, **k: (
            calls.append(_op), _real(*a, **k))[1])
    rt.fit(1)
    plan, ls = rt.plan, rt.trainer.num_layers
    repull = sum(any(0 < l < ls - 1 for l in b) for b in plan.backward)
    assert calls.count("all_gather_into_tensor") == \
        len(plan.forward) + (repull if zero3 else 0)
    assert calls.count("reduce_scatter_tensor") == len(plan.backward)


def test_launcher_runs_on_cpu_and_dumps_config(capsys):
    from repro_torch.launch.train import main
    losses = main(["--config", os.path.join(CONFIGS, "zero.json"),
                   "--steps", "2", "--log-every", "0", "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "1 pull / 2 push buckets" in capsys.readouterr().out
    main(["--runtime", "zero", "--reduced", "--dump-config"])
    dumped = RuntimeConfig.from_json(capsys.readouterr().out)
    assert dumped.runtime == "zero" and dumped.reduced


def test_unported_runtimes_raise(monkeypatch):
    """Every name of the schema is registered; a name the registry lacks
    raises before anything is built."""
    from repro_torch.runtime import registry
    from repro_torch.runtime.config import RUNTIME_REGIMES
    assert registry.runtime_names() == tuple(sorted(RUNTIME_REGIMES))
    monkeypatch.delitem(registry.RUNTIMES, "pipeline")
    cfg = RuntimeConfig.load(os.path.join(CONFIGS, "pipeline.json"))
    with pytest.raises(ValueError, match="not ported"):
        build_runtime(cfg, device="cpu")


@pytest.mark.parametrize("name", ["ps_async", "ps_async_int8",
                                  "dynamic_ps_async"])
def test_async_runtimes_build(name):
    rt = build_runtime(RuntimeConfig.load(os.path.join(
        CONFIGS, f"{name}.json")), device="cpu")
    assert rt.timeline() is None and rt.ledger["num_pushes"] == 0
    loop = getattr(rt.trainer, "trainer", rt.trainer)     # the async loop
    assert loop.computations == 0 and loop.log is None


def test_fleet_runtime_builds():
    rt = build_runtime(RuntimeConfig.load(os.path.join(
        CONFIGS, "fleet_async.json")), device="cpu")
    assert rt.timeline() is None and rt.ledger["num_pushes"] == 0
    assert rt.events == () and rt.trainer.device == torch.device("cpu")
    assert rt.trainer.membership.active == (0, 1, 2)
    assert [e.kind for e in rt.trainer.schedule.events] == ["join", "fail"]


@pytest.mark.parametrize("name", ["dynamic", "dynamic_ps"])
def test_dynamic_runtimes_build(name):
    rt = build_runtime(RuntimeConfig.load(os.path.join(
        CONFIGS, f"{name}.json")), device="cpu")
    assert rt.plan is None and rt.events == ()     # plans at the first step


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_runtime(_config("zero"))


def test_with_plan_swaps_the_plan_and_keeps_the_state():
    from repro_torch.core import BucketPlan
    rt = build_runtime(_config("zero"), device="cpu")
    want = build_runtime(_config("zero"), device="cpu").fit(3)
    got = rt.fit(1)
    n = rt.trainer.num_layers
    per_layer = BucketPlan(forward=tuple((l,) for l in range(n)),
                           backward=tuple((l,) for l in reversed(range(n))))
    rt.trainer = rt.trainer.with_plan(per_layer)
    assert rt.plan == per_layer
    got += rt.fit(2)
    assert got == want
    with pytest.raises(ValueError, match="do not pull layers"):
        rt.trainer.with_plan(BucketPlan(forward=((1, 0),) + per_layer
                                        .forward[2:],
                                        backward=per_layer.backward))


def test_params_from_state_equals_reference(reference_runs):
    """The canonical tree out of a carried-across state is the
    reference's, leaf for leaf."""
    from repro.dist.zero import ZeroTrainer as JaxZeroTrainer
    from repro_torch import tree
    ref = reference_runs["zero"]
    rt = build_runtime(_config("zero"), device="cpu")
    state = ref["init"]
    mine = rt.trainer.params_from_state(zero_state_from_numpy(
        rt.trainer, state["flat_params"]))
    jrt = jax_build_runtime(JaxRuntimeConfig.load(
        os.path.join(CONFIGS, "zero.json")))
    assert isinstance(jrt.trainer, JaxZeroTrainer)
    theirs = jrt.trainer.params_from_state(jrt._state)
    for a, b in zip(tree.leaves(mine), jax.tree_util.tree_leaves(theirs)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
