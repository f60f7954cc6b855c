"""The port's MoE MLP (``repro_torch.models.moe``) and the trainers that run
it, against the reference's ``repro.models.moe`` on the CPU.

Weights and inputs are numpy, made from seeds (the reference's
initialisers, carried across by ``interop``).  The cases are chosen so
that routing faults show: reduced granite-moe with 8 experts at top-2 and
capacity factor 0.5 (tokens are dropped: the test asserts it), the same
with a zero router (every probability equal: ties decide), reduced
grok-1-314b (gated GELU, softcaps) and an ungated variant.

Tolerances, each with its reason:

* routing integers (``top_e``, ``slot``, ``keep``) bitwise: integer
  arithmetic on the same probabilities;
* ``apply_moe`` output atol 1e-5, aux rtol 1e-6, and every gradient
  leaf (the VJP, the block pull-back, the async loss's gradient) within
  4e-6 of the leaf's own largest magnitude (``chip_smoke.leaf_gap``):
  float32 sums in another order in XLA and PyTorch, and a router gradient
  entry is a sum over tokens (measured on the CPU: output 9.8e-7, aux
  equal, the worst leaf 2.0e-6 of its largest magnitude; the aux term
  moves the router's gradient by 1.5e-5 of it or more);
* trainer losses rtol 1e-5 and final flat parameters relative L2 1e-4 per
  sched layer: as ``tests/test_torch_pipeline.py`` / ``_async_ps.py`` —
  AdamW's sign-like first steps turn a roundoff gradient difference into
  a few elements up to a step apart (measured: losses 1.5e-7 at one and
  two ranks, 2.4e-7 on ps-async; flats 3.2e-6);
* plans, byte counts, FlatSpec offsets, ledgers and event streams exactly;
* inside the port, what the arithmetic fixes is bitwise: dense gradients
  under the aux-pulling ``model.layer_vjp``, the pipeline's parameters across stage
  counts at M = 1 and across schedules.
"""

import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pipeline as jp
from repro.configs import get_config as jax_get_config
from repro.configs.base import InputShape as JaxInputShape
from repro.core import BucketPlan as JaxBucketPlan
from repro.core import DynaCommScheduler as JaxScheduler
from repro.core import costs_from_profiles as jax_costs_from_profiles
from repro.core import plan_from_decision as jax_plan_from_decision
from repro.dist import collectives as jax_coll
from repro.dist.zero import ZeroTrainer as JaxZeroTrainer
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro.models.profiles import layer_profiles as jax_layer_profiles
from repro.optim import adamw as jax_adamw
from repro.runtime import NetworkConfig as JaxNetworkConfig
from repro.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.runtime import build_runtime as jax_build_runtime
from repro_torch import pipeline as tp
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import BucketPlan, DynaCommScheduler
from repro_torch.core import costs_from_profiles, plan_from_decision
from repro_torch.dist import collectives as coll
from repro_torch.dist.zero import ZeroTrainer
from repro_torch.interop import params_from_numpy, zero_state_from_numpy
from repro_torch.kernels import launch_counts
from repro_torch.kernels.moe_positions import ops as positions_ops
from repro_torch.kernels.moe_positions import ref as positions_ref
from repro_torch.models import model, moe
from repro_torch.models.profiles import layer_profiles
from repro_torch.optim import adamw
from repro_torch.ps.async_mode import value_and_grad
from repro_torch.runtime import NetworkConfig, RuntimeConfig, build_runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "examples", "runtime_configs")
HELPER = os.path.join(ROOT, "tests", "helpers", "torch_moe_check.py")
OUT_ATOL = 1e-5
AUX_RTOL = 1e-6
LOSS_RTOL = 1e-5
FLAT_REL_L2 = 1e-4
LR = 1e-3
STEPS = 2

# chip_smoke.py holds the dropping config (8 experts at top-2, capacity
# factor 0.5: reduced() alone drops nothing) and the gradient limit, which
# its card phase shares with these tests
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)
DROPPING = SMOKE.MOE_DROPPING
GRAD_SCALE_RTOL = SMOKE.GRAD_SCALE_RTOL
MOE_CASES = {
    "dropping": ("granite-moe-1b-a400m", DROPPING, False),
    "ties": ("granite-moe-1b-a400m", DROPPING, True),      # zero router
    "grok-1": ("grok-1-314b", {}, False),
    "ungated": ("granite-moe-1b-a400m",
                dict(DROPPING, gated_mlp=False, activation="gelu"), False),
}


def _configs(name, **changes):
    mine = dataclasses.replace(get_config(name).reduced(), **changes)
    theirs = dataclasses.replace(jax_get_config(name).reduced(), **changes)
    return mine, theirs


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _moe_case(case, tokens=(2, 16)):
    name, changes, zero_router = MOE_CASES[case]
    cfg, jcfg = _configs(name, **changes)
    params = _np(jax_moe.init_moe_params(jax.random.PRNGKey(4), jcfg))
    if zero_router:
        params["router"] = np.zeros_like(params["router"])
    rng = np.random.default_rng(7)
    x = rng.standard_normal((*tokens, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, params, x


def _t(x):
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.as_tensor(np.array(x))


def _close_to_scale(got, want, what=""):
    """|got - want| within GRAD_SCALE_RTOL of the leaf's own largest
    magnitude (``chip_smoke.leaf_gap``)."""
    gap = SMOKE.leaf_gap(_t(got), _t(want))
    assert gap <= GRAD_SCALE_RTOL, (what, gap)


def _differs(a, b):
    """``a`` and ``b`` (router gradients with and without the aux term)
    differ by more than twice the gap the comparison with the reference
    allows: a pull-back that left the term out would fail it."""
    assert SMOKE.leaf_gap(_t(a), _t(b)) > 2 * GRAD_SCALE_RTOL


def _jnp_routing(probs, jcfg, cap):
    """The reference's routing steps, written out in ``jnp``."""
    e, k = jcfg.num_experts, jcfg.top_k
    _, top_e = jax.lax.top_k(probs, k)
    flat_e = top_e.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=1)
    keep = pos < cap
    slot = flat_e * cap + jnp.where(keep, pos, 0)
    return np.asarray(top_e), np.asarray(slot), np.asarray(keep)


# ---------------------------------------------------------------------------
# apply_moe against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_routing_integers_bitwise(case):
    cfg, jcfg, params, x = _moe_case(case)
    n = x.shape[0] * x.shape[1]
    cap = moe.expert_capacity(n, cfg)
    assert cap == jax_moe.expert_capacity(n, jcfg)
    xf = x.reshape(n, -1)
    probs = np.array(jax.nn.softmax(
        jnp.asarray(xf) @ jnp.asarray(params["router"]), axis=-1))
    top_e, slot, keep = _jnp_routing(jnp.asarray(probs), jcfg, cap)
    r = moe.route(torch.from_numpy(probs), cfg, cap)
    np.testing.assert_array_equal(r.top_e.numpy(), top_e)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    if case != "grok-1":
        assert not keep.all()               # some assignments are dropped
    if case == "ties":                     # the lower experts first
        assert (top_e == np.arange(cfg.top_k)).all()
    # the port's own probabilities route the same way
    mine = moe.route(torch.softmax(torch.from_numpy(xf) @ torch.from_numpy(
        params["router"]), dim=-1), cfg, cap)
    np.testing.assert_array_equal(mine.top_e.numpy(), top_e)
    np.testing.assert_array_equal(mine.slot.numpy(), slot)


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_apply_moe_output_aux_and_vjp_match_reference(case):
    cfg, jcfg, params, x = _moe_case(case)
    rng = np.random.default_rng(11)
    ct_out = rng.standard_normal(x.shape).astype(np.float32)
    ct_aux = np.float32(0.37)
    (out, aux), vjp = jax.vjp(lambda p, xx: jax_moe.apply_moe(p, xx, jcfg),
                              params, x)
    g_params, g_x = vjp((jnp.asarray(ct_out), jnp.asarray(ct_aux)))

    tparams = params_from_numpy(params, requires_grad=True)
    tx = torch.from_numpy(x).requires_grad_()
    tout, taux = moe.apply_moe(tparams, tx, cfg)
    grads = torch.autograd.grad(
        [tout, taux], tree.leaves(tparams) + [tx],
        grad_outputs=[torch.from_numpy(ct_out), torch.tensor(ct_aux)])

    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out),
                               atol=OUT_ATOL)
    np.testing.assert_allclose(taux.item(), float(aux), rtol=AUX_RTOL)
    want = jax.tree_util.tree_leaves(g_params) + [g_x]
    paths = [p for p, _ in tree.leaves_with_paths(tparams)] + ["x"]
    assert len(grads) == len(want)
    for p, g, w in zip(paths, grads, want):
        _close_to_scale(g, w, p)
    # the router's gradient carries the aux term: it changes without it
    g0 = jax.vjp(lambda p: jax_moe.apply_moe(p, x, jcfg), params)[1](
        (jnp.asarray(ct_out), jnp.zeros((), jnp.float32)))[0]["router"]
    _differs(g0, g_params["router"])


def test_dropped_rows_add_exact_zeros():
    """Every slot holds at most one kept row; the dropped assignments
    point at a kept row's slot and add exact zeros there."""
    cfg, _, params, x = _moe_case("dropping")
    n = x.shape[0] * x.shape[1]
    cap = moe.expert_capacity(n, cfg)
    probs = torch.softmax(torch.from_numpy(x.reshape(n, -1)) @
                          torch.from_numpy(params["router"]), dim=-1)
    r = moe.route(probs, cfg, cap)
    kept = r.slot[r.keep]
    assert kept.unique().numel() == kept.numel()
    dropped = r.slot[~r.keep]
    assert dropped.numel() > 0
    assert torch.isin(dropped, kept).all()
    assert (dropped % cap == 0).all()


def _positions_counted(flat_e, first, held, cap):
    """The position kernel's contract counted out in Python: an
    assignment's position is the number of earlier ones to its expert."""
    seen, slot, keep = {}, [], []
    for e in flat_e.tolist():
        pos = seen.get(e, 0)
        seen[e] = pos + 1
        local = e - first
        kept = 0 <= local < held and pos < cap
        slot.append(local * cap + (pos if kept else 0)
                    if 0 <= local < held else 0)
        keep.append(kept)
    return torch.tensor(slot, dtype=torch.int64), torch.tensor(keep)


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_positions_ref_gives_the_routing_integers(case):
    """``kernels/moe_positions/ref.py`` on the routing cases: the
    reference's slot and keep with every expert held, and the contract
    counted out with a share of the experts held."""
    cfg, jcfg, params, x = _moe_case(case)
    n = x.shape[0] * x.shape[1]
    cap = moe.expert_capacity(n, cfg)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(n, -1))
                           @ jnp.asarray(params["router"]), axis=-1)
    top_e, slot, keep = _jnp_routing(probs, jcfg, cap)
    flat_e = torch.from_numpy(top_e.reshape(-1).astype(np.int64))
    e = cfg.num_experts
    got = positions_ref.moe_positions_ref(flat_e, e, 0, e, cap)
    np.testing.assert_array_equal(got[0].numpy(), slot)
    np.testing.assert_array_equal(got[1].numpy(), keep)
    for first, held in ((1, e // 2), (e - 1, 1)):
        got = positions_ref.moe_positions_ref(flat_e, e, first, held, cap)
        want = _positions_counted(flat_e, first, held, cap)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_positions_on_a_cpu_tensor_take_the_plain_version():
    """The wrapper and ``route`` on CPU tensors: the plain version's
    integers, and no launch."""
    flat_e = torch.randint(0, 8, (3001,),
                           generator=torch.Generator().manual_seed(0))
    got = positions_ops.moe_positions(flat_e, 8, 2, 4, 200)
    want = positions_ref.moe_positions_ref(flat_e, 8, 2, 4, 200)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    cfg, _, params, x = _moe_case("dropping")
    xf = torch.from_numpy(x.reshape(-1, cfg.d_model))
    moe.route(torch.softmax(xf @ torch.from_numpy(params["router"]), -1),
              cfg, moe.expert_capacity(xf.shape[0], cfg))
    assert positions_ops.LAUNCHES["moe_positions"] == 0
    assert launch_counts()["moe_positions"] == 0


@pytest.mark.parametrize("flat_e,num_experts,match", [
    (torch.zeros(16, dtype=torch.int32), 8, "int64"),
    (torch.zeros((4, 4), dtype=torch.int64), 8, "shape"),
    (torch.zeros(16, dtype=torch.int64), positions_ops.MAX_EXPERTS + 1,
     "shared memory"),
    (torch.zeros(16, dtype=torch.int64), 0, "experts"),
])
def test_positions_reject_what_the_kernel_does_not_take(flat_e, num_experts,
                                                        match):
    with pytest.raises(ValueError, match=match):
        positions_ops.moe_positions(flat_e, num_experts, 0, 1, 4)


def test_position_kernel_is_not_counted_as_a_matrix_product():
    """The benchmark sums kernels whose names match its GEMM pattern as
    the models' matrix products; the position kernel's name stays out."""
    from portbench.harness.trace import GEMM
    src = open(os.path.join(ROOT, "src", "repro_torch", "csrc",
                            "moe_positions.cu")).read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)\s*\(", src)
    assert names == ["moe_positions_kernel"]
    assert not GEMM.search(names[0])


# ---------------------------------------------------------------------------
# host-side: layouts, bytes and plans at full width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "grok-1-314b"])
def test_sched_layer_bytes_and_zero_plans_at_full_width(name):
    cfg, jcfg = get_config(name), jax_get_config(name)
    assert model.sched_layer_bytes(cfg) == jax_model.sched_layer_bytes(jcfg)
    assert model.param_count(cfg) == jax_model.param_count(jcfg)
    if name == "granite-moe-1b-a400m":
        assert model.param_count(cfg) == 1_334_628_352
        assert model.sched_layer_bytes(cfg) == \
            [201_338_880] + [214_048_768] * 24 + [4_096]
    config = RuntimeConfig.load(os.path.join(CONFIGS, "zero.json"))
    shape = ("runtime", 1024, 2, "train")
    costs = costs_from_profiles(
        layer_profiles(cfg, InputShape(*shape)), net=NetworkConfig().build(),
        compute_flops_per_s=config.measure.compute_flops_per_s)
    jcosts = jax_costs_from_profiles(
        jax_layer_profiles(jcfg, JaxInputShape(*shape)),
        net=JaxNetworkConfig().build(),
        compute_flops_per_s=config.measure.compute_flops_per_s)
    for strategy in ("sequential", "lbl", "ibatch", "dynacomm"):
        mine = DynaCommScheduler(strategy=strategy).decision_for_iteration(
            costs)
        theirs = JaxScheduler(strategy=strategy).decision_for_iteration(
            jcosts)
        assert mine == theirs
        n = model.num_sched_layers(cfg)
        plan, jplan = plan_from_decision(*mine, n), \
            jax_plan_from_decision(*theirs, n)
        assert (plan.forward, plan.backward) == (jplan.forward,
                                                 jplan.backward)


def test_moe_partition_at_full_width_equals_reference():
    """granite-moe-1b-a400m under ``pipeline.json``'s 2 stages at 1e10
    FLOP/s: the split the card's ``moe`` phase asserts."""
    shape = ("runtime", 1024, 2, "train")
    mine = tp.partition_profiles(
        layer_profiles(get_config("granite-moe-1b-a400m"), InputShape(*shape)),
        2, compute_flops_per_s=1e10)
    theirs = jp.partition_profiles(
        jax_layer_profiles(jax_get_config("granite-moe-1b-a400m"),
                           JaxInputShape(*shape)), 2,
        compute_flops_per_s=1e10)
    assert mine.as_dict() == theirs.as_dict()
    assert mine.segments == ((1, 14), (15, 26))


@pytest.mark.parametrize("axis", [1, 2, 3])
def test_moe_tree_flattens_as_the_reference(axis):
    """``params_from_numpy`` carries the MoE tree; its keys sort as down,
    gate, router, up, so every FlatSpec offset is the reference's."""
    _, jcfg = _configs("granite-moe-1b-a400m", **DROPPING)
    params = _np(jax_model.init_params(jcfg, jax.random.PRNGKey(0)))
    mine = model.sched_layer_trees(params_from_numpy(params))
    block = mine[1]
    assert [p for p, _ in tree.leaves_with_paths(block["moe"])] == \
        [("down",), ("gate",), ("router",), ("up",)]
    for t_ref, t in zip(jax_model.sched_layer_trees(params), mine):
        spec_ref = jax_coll.make_flat_spec(t_ref, axis)
        spec = coll.make_flat_spec(t, axis)
        for field in ("shapes", "offsets", "sizes", "total", "padded",
                      "shard_size"):
            assert getattr(spec, field) == getattr(spec_ref, field), field
        np.testing.assert_array_equal(
            coll.flatten_tree(t, spec).numpy(),
            np.asarray(jax_coll.flatten_tree(t_ref, spec_ref)))


# ---------------------------------------------------------------------------
# the trainers on a reduced MoE
# ---------------------------------------------------------------------------


def _batch(cfg, b=4, t=16, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _torch_batch(toks, labels):
    return {"tokens": torch.from_numpy(toks).long(),
            "labels": torch.from_numpy(labels).long()}


PLAN = ((0, 1), (2, 3)), ((3,), (2, 1, 0))     # 4 sched layers


def _flat_gaps(mine, theirs):
    return [float(np.linalg.norm(a - b) / np.linalg.norm(b))
            for a, b in zip(mine, theirs)]


@pytest.fixture(scope="module")
def zero_one_rank():
    """The reference's ZeRO trainer on one device and the port's on a
    world-1 gloo group, from the reference's initial state."""
    from jax.sharding import Mesh
    cfg, jcfg = _configs("granite-moe-1b-a400m", **DROPPING)
    toks, labels = _batch(cfg)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jtr = JaxZeroTrainer(cfg=jcfg, mesh=mesh, plan=JaxBucketPlan(*PLAN),
                         optimizer=jax_adamw(LR))
    state = jtr.init_state(jax.random.PRNGKey(0))
    init = _np(state)
    step = jax.jit(jtr.build_train_step())
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    ref = []
    for _ in range(STEPS):
        state, loss = step(state, jbatch)
        ref.append(float(loss))
    tr = ZeroTrainer(cfg=cfg, plan=BucketPlan(*PLAN), optimizer=adamw(LR),
                     device="cpu")
    mine = zero_state_from_numpy(tr, init["flat_params"])
    losses = []
    for _ in range(STEPS):
        mine, loss = tr.step(mine, _torch_batch(toks, labels))
        losses.append(float(loss))
    return dict(ref=ref, losses=losses, jtr=jtr, tr=tr,
                ref_flats=_np(state["flat_params"]),
                flats=[f.numpy() for f in mine["flat_params"]])


def test_zero_one_rank_matches_reference(zero_one_rank):
    run = zero_one_rank
    np.testing.assert_allclose(run["losses"], run["ref"], rtol=LOSS_RTOL)
    assert max(_flat_gaps(run["flats"], run["ref_flats"])) <= FLAT_REL_L2
    for spec, jspec in zip(run["tr"].specs, run["jtr"].specs):
        assert (spec.offsets, spec.sizes, spec.padded) == \
            (jspec.offsets, jspec.sizes, jspec.padded)


def _run_helper(mode, tmp_path, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               **(env_extra or {}))
    proc = subprocess.run([sys.executable, HELPER, mode, str(tmp_path),
                           json.dumps(DROPPING)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp_path / f"{mode}.npz"))


def test_zero_two_ranks_matches_reference_with_local_capacity(tmp_path):
    """2 ranks: each rank routes its half of the batch, so the capacity
    comes from the local tokens (the reference's ``shard_map``); the
    reference runs on 2 forged host devices, the port on 2 gloo ranks."""
    ref = _run_helper("reference", tmp_path,
                      {"JAX_PLATFORMS": "cpu"})
    got = _run_helper("port", tmp_path)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    n = int(ref["num_layers"])
    gaps = _flat_gaps([got[f"flat{l}"] for l in range(n)],
                      [ref[f"flat{l}"] for l in range(n)])
    assert max(gaps) <= FLAT_REL_L2, gaps
    np.testing.assert_array_equal(got["offsets"], ref["offsets"])
    # the local capacity differs from the global batch's
    assert int(ref["local_cap"]) != int(ref["global_cap"])


@pytest.fixture(scope="module")
def pipeline_runs():
    cfg, jcfg = _configs("granite-moe-1b-a400m", **DROPPING)
    toks, labels = _batch(cfg)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    out = {}
    init = None
    for S in (1, 2):
        tr = jp.PipelineTrainer(cfg=jcfg, optimizer=jax_adamw(LR),
                                num_stages=S, num_microbatches=2)
        state = tr.init_state(jax.random.PRNGKey(0))
        init = init or _np(state)
        losses = []
        for _ in range(STEPS):
            state, loss = tr.step(state, jbatch)
            losses.append(float(loss))
        out["ref", S, 2] = (losses, _np(state["flat_params"]))

    def port(S, M, name="1f1b"):
        tr = tp.PipelineTrainer(cfg=cfg, optimizer=adamw(LR), device="cpu",
                                num_stages=S, num_microbatches=M,
                                schedule_name=name)
        state = zero_state_from_numpy(tr, init["flat_params"])
        losses = []
        for _ in range(STEPS):
            state, loss = tr.step(state, _torch_batch(toks, labels))
            losses.append(float(loss))
        return losses, [f.clone() for f in state["flat_params"]]

    for key in ((1, 1), (2, 1), (1, 2), (2, 2)):
        out[key] = port(*key)
    out["gpipe"] = port(2, 2, "gpipe")
    return out


@pytest.mark.parametrize("S", [1, 2])
def test_pipeline_matches_reference(S, pipeline_runs):
    losses, flats = pipeline_runs[S, 2]
    ref_losses, ref_flats = pipeline_runs["ref", S, 2]
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    assert max(_flat_gaps([f.numpy() for f in flats], ref_flats)) <= \
        FLAT_REL_L2


def test_pipeline_bitwise_where_the_arithmetic_is_fixed(pipeline_runs):
    """Parameters bitwise across S at M = 1 (the aux cotangent is one
    constant whatever the grouping of the aux sum), and losses and
    parameters bitwise between gpipe and 1f1b; S = 1 and S = 2 at M = 2
    within roundoff (the embedding's and the aux's grouping)."""
    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    assert same(pipeline_runs[1, 1], pipeline_runs[2, 1])
    np.testing.assert_allclose(pipeline_runs[1, 1][0],
                               pipeline_runs[2, 1][0], rtol=1e-6)
    assert pipeline_runs["gpipe"][0] == pipeline_runs[2, 2][0]
    assert same(pipeline_runs["gpipe"], pipeline_runs[2, 2])
    np.testing.assert_allclose(pipeline_runs[1, 2][0],
                               pipeline_runs[2, 2][0], rtol=1e-6)


def _block_grads(cfg, params, h, ct, aux_weight):
    """One block's ZeRO pull-back, as ``ZeroTrainer.step`` takes it: the
    aux cotangent is ``None`` for a dense block."""
    kind = cfg.layer_kinds()[0]
    aux_ct = (torch.full((), aux_weight, dtype=torch.float32)
              if cfg.is_moe else None)
    return model.layer_vjp(
        lambda p, hh: model.apply_train_block(cfg, p, hh, kind),
        (params, h), (ct, aux_ct))


def test_zero_block_pullback_carries_the_router_aux():
    """The block VJP with the cotangent (ct, aux_weight) equals the
    reference's; at aux_weight 0 the router's gradient changes."""
    from repro.models import blocks as jax_blocks
    cfg, jcfg = _configs("granite-moe-1b-a400m", **DROPPING)
    params = _np(jax_model.init_params(jcfg, jax.random.PRNGKey(2)))
    block = params["layers"][0]
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(h.shape).astype(np.float32)
    kind = jcfg.layer_kinds()[0]
    _, vjp = jax.vjp(lambda p, x: jax_blocks.apply_block(
        p, x, jcfg, kind, mode="train")[::2], block, h)
    want_p, want_h = vjp((jnp.asarray(ct), jnp.float32(0.01)))
    g_p, g_h = _block_grads(cfg, params_from_numpy(block),
                            torch.from_numpy(h), torch.from_numpy(ct), 0.01)
    _close_to_scale(g_h, want_h, "h")
    for (p, g), w in zip(tree.leaves_with_paths(g_p),
                         jax.tree_util.tree_leaves(want_p)):
        _close_to_scale(g, w, p)
    g0, _ = _block_grads(cfg, params_from_numpy(block), torch.from_numpy(h),
                         torch.from_numpy(ct), 0.0)
    _differs(g0["moe"]["router"], g_p["moe"]["router"])


def test_dense_block_pullback_ignores_the_aux_cotangent():
    """A dense block's aux is a constant zero, pulled back with ``None``:
    pulling back (y, aux) gives the same bits as pulling back y alone."""
    cfg = get_config("granite-3-2b").reduced()
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    h = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    ct = torch.randn(h.shape, generator=torch.Generator().manual_seed(2))
    from repro_torch.models import blocks
    one = model.layer_vjp(
        lambda p, hh: blocks.apply_block(p, hh, cfg, "global_attn",
                                         mode="train")[0],
        (params["layers"][0], h), ct)
    pair = _block_grads(cfg, params["layers"][0], h, ct, 0.01)
    assert all(torch.equal(a, b) for a, b in
               zip(tree.leaves(one), tree.leaves(pair)))


def test_pullback_raises_on_an_aux_without_a_graph():
    """An MoE aux that lost its graph, pulled back with a cotangent, is an
    error, not a silently dropped router term."""
    cfg, _ = _configs("granite-moe-1b-a400m", **DROPPING)
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    h = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    from repro_torch.models import blocks
    kind = cfg.layer_kinds()[0]

    def detached(p, hh):
        y, _, aux = blocks.apply_block(p, hh, cfg, kind, mode="train")
        return y, aux.detach()
    with pytest.raises(RuntimeError):
        model.layer_vjp(detached, (params["layers"][0], h),
                        (torch.ones_like(h), torch.full((), 0.01)))


def test_async_gradient_equals_reference_with_the_aux_term():
    """``ps/async_mode.py::value_and_grad`` over ``train_loss`` (the async
    path's and the fleet's gradient) equals ``jax.value_and_grad`` of the
    reference's loss, aux included; without the aux the router's
    gradient differs."""
    cfg, jcfg = _configs("granite-moe-1b-a400m", **DROPPING)
    params = _np(jax_model.init_params(jcfg, jax.random.PRNGKey(6)))
    toks, labels = _batch(cfg, 2)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    out = {}
    for aux in (0.01, 0.0):
        want, jgrads = jax.value_and_grad(lambda p: jax_model.train_loss(
            jcfg, p, jbatch, aux_weight=aux))(params)
        fn = value_and_grad(lambda layers, b: model.train_loss(
            cfg, model.params_from_sched_layers(layers), b, aux_weight=aux,
            remat=True))
        loss, grads = fn(model.sched_layer_trees(params_from_numpy(params)),
                         _torch_batch(toks, labels))
        np.testing.assert_allclose(loss, float(want), rtol=LOSS_RTOL)
        for (p, g), w in zip(
                tree.leaves_with_paths(model.params_from_sched_layers(grads)),
                jax.tree_util.tree_leaves(jgrads)):
            _close_to_scale(g, w, p)
        out[aux] = grads[1]["moe"]["router"]
    _differs(out[0.01], out[0.0])


def test_ps_async_on_a_reduced_moe_equals_reference(tmp_path):
    """``ps_async.json`` on the dropping MoE: the port restores the
    reference's initial checkpoint; events and ledger exactly, losses
    within rtol 1e-5."""
    cfg, jcfg = _configs("granite-moe-1b-a400m", **DROPPING)
    path = os.path.join(CONFIGS, "ps_async.json")
    ref = jax_build_runtime(JaxRuntimeConfig.load(path), jcfg)
    init = str(tmp_path / "init.npz")
    ref.save_state(init)
    ref.restore_state(init)
    ref_losses = ref.fit(6)
    rt = build_runtime(RuntimeConfig.load(path), cfg, device="cpu")
    rt.restore_state(init)
    losses = rt.fit(6)

    def trace(log):
        return [(e.worker, e.sim_time, e.version, e.result.accepted,
                 e.result.staleness, e.result.version, e.retries, e.wait_s)
                for e in log.events]
    assert trace(rt.timeline()) == trace(ref.timeline())
    assert rt.ledger == ref.ledger
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)


def test_moe_zero_step_equals_the_pipeline_at_one_stage():
    """On the MoE, as on dense models, one rank's ZeRO step and the
    pipeline at S = 1, M = 1 run the same per-layer ops: the parameters
    are the same bits after 2 steps."""
    cfg, _ = _configs("granite-moe-1b-a400m", **DROPPING)
    toks, labels = _batch(cfg)
    batch = _torch_batch(toks, labels)
    gen = torch.Generator().manual_seed(0)
    tr = ZeroTrainer(cfg=cfg, plan=BucketPlan(*PLAN), optimizer=adamw(LR),
                     device="cpu")
    state = tr.init_state(gen)
    flats = [f.clone() for f in state["flat_params"]]
    ptr = tp.PipelineTrainer(cfg=cfg, optimizer=adamw(LR), device="cpu",
                             num_stages=1, num_microbatches=1)
    pstate = ptr.state_from_flats(flats)
    for _ in range(STEPS):
        state, _ = tr.step(state, batch)
        pstate, _ = ptr.step(pstate, batch)
    assert all(torch.equal(a, b) for a, b in
               zip(state["flat_params"], pstate["flat_params"]))
