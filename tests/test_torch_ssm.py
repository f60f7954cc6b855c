"""The port's RG-LRU slice against the reference (on the CPU): the
``rglru_scan`` wrapper and its gradient, the RG-LRU block, and
recurrentgemma-2b under the ``zero`` runtime.

The JAX side runs as its own tests run it: the Pallas kernel in interpret
mode, beside its associative-scan oracle.  On the CPU the port's wrapper
takes its plain loop (forward and, for the gradient, reverse).

Tolerances, each with its reason:
* scan forward atol 2e-6 (f32) and 3e-2 (bf16), gradients rtol 1e-4 /
  atol 1e-5 — the reference's own (``tests/test_kernels.py::TestRGLRUScan``);
  the associative scan multiplies in another order than the sequential
  loop (measured f32 gap at most 2.4e-7, gradients 2.9e-6);
* the backward's plain version (``ref.rglru_scan_backward_ref``, which the
  card's fused kernel is held to) bitwise against the gradient written out
  step by step, on ragged shapes in f32 and bf16;
* the RG-LRU block atol 1e-5, rtol 1e-4 — the reference's own
  ``test_rglru_block_uses_kernel`` bound (measured 1.4e-9);
* 3-step ``zero`` losses rtol 1e-5, as ``test_torch_runtime.py``;
* plans, flat layouts and checkpoint keys exact;
  losses bitwise across the four strategies inside the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.dist import collectives as jax_coll
from repro.kernels.rglru_scan import ops as jax_scan_ops
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_scan_ref
from repro.models import model as jax_model
from repro.models import ssm as jax_ssm
from repro.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.runtime import build_runtime as jax_build_runtime
from repro_torch.configs import get_config
from repro_torch.dist import collectives as coll
from repro_torch.interop import params_from_numpy, zero_state_from_numpy
from repro_torch.kernels import launch_counts
from repro_torch.kernels.rglru_scan import ops, scan_backward
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_backward_ref,
                                                rglru_scan_ref)
from repro_torch.models import model, ssm
from repro_torch.runtime import RuntimeConfig, ScheduleConfig, build_runtime

SCAN_SHAPES = [(2, 256, 128), (1, 200, 100), (3, 128, 384), (1, 1024, 256)]
# ragged: T = 1, W = 5, W = 33, W and T under one warp or one ring stage
BACKWARD_SHAPES = [(2, 33, 7), (1, 1, 5), (3, 17, 33), (1, 200, 100),
                   (2, 1, 1), (1, 70, 64)]
DTYPES = [(torch.float32, jnp.float32, 2e-6),
          (torch.bfloat16, jnp.bfloat16, 3e-2)]
LOSS_RTOL = 1e-5
STRATEGIES = ("sequential", "lbl", "ibatch", "dynacomm")
ARCH = "recurrentgemma-2b"
SEQ = 80          # past the reduced window of 64


def _scan_inputs(b, t, w, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.8, 0.999, (b, t, w)).astype(np.float32)
    x = (rng.standard_normal((b, t, w)) * 0.1).astype(np.float32)
    return a, x


def _bits(x):
    return x.view(torch.int32 if x.element_size() == 4 else torch.int16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------


class TestScan:
    @pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
    @pytest.mark.parametrize("b,t,w", SCAN_SHAPES)
    def test_forward_vs_interpret_kernel_and_oracle(self, b, t, w, dt):
        tdt, jdt, tol = dt
        a, x = _scan_inputs(b, t, w)
        got = ops.rglru_scan(torch.from_numpy(a).to(tdt),
                             torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt and got.shape == (b, t, w)
        ja, jx = jnp.asarray(a).astype(jdt), jnp.asarray(x).astype(jdt)
        for want in (jax_scan_ops.rglru_scan(ja, jx, interpret=True),
                     jax_scan_ref(ja, jx)):
            np.testing.assert_allclose(_np(got), _np(want), atol=tol)

    @pytest.mark.parametrize("b,t,w,seed", [(1, 128, 128, 1), (1, 64, 33, 2),
                                            (2, 40, 5, 3), (1, 1, 7, 4)])
    def test_gradients_vs_reference_custom_vjp(self, b, t, w, seed):
        a, x = _scan_inputs(b, t, w, seed=seed)
        a = np.clip(a, 0.8, 0.99)
        ta, tx = (torch.from_numpy(v).requires_grad_() for v in (a, x))
        (ops.rglru_scan(ta, tx) ** 2).sum().backward()
        want = jax.grad(lambda a, x: jnp.sum(jax_scan_ops.rglru_scan(
            a, x, interpret=True) ** 2), argnums=(0, 1))(a, x)
        for got, w in zip((ta.grad, tx.grad), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["f32", "bf16"])
    @pytest.mark.parametrize("b,t,w", BACKWARD_SHAPES)
    def test_backward_is_the_reverse_scan_of_the_shifted_a(self, b, t, w,
                                                           dtype):
        """The gradient bitwise equal to its definition written out: dh by
        the reverse recurrence over a_{t+1} on an fp32 carry, stored in the
        input dtype; da = dh·h_{t-1} (h_{-1} = 0), the product of the two
        stored values rounded once; dx = dh.  The plain backward gives it,
        and so does autograd through the wrapper, which on the CPU takes
        the plain backward and launches nothing."""
        a, x = (torch.from_numpy(v).to(dtype)
                for v in _scan_inputs(b, t, w, seed=2))
        g = torch.randn(b, t, w, generator=torch.Generator().manual_seed(0)
                        ).to(dtype)
        ta, tx = a.clone().requires_grad_(), x.clone().requires_grad_()
        before = launch_counts()
        h = ops.rglru_scan(ta, tx)
        h.backward(g)
        assert launch_counts() == before
        h = h.detach()
        carry = torch.zeros(b, w)
        dhs = torch.empty(b, t, w, dtype=dtype)
        for i in range(t - 1, -1, -1):
            nxt = a[:, i + 1].float() if i + 1 < t else torch.zeros(b, w)
            carry = nxt * carry + g[:, i].float()
            dhs[:, i] = carry.to(dtype)
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
        for da, dx in (rglru_scan_backward_ref(a, h, g),
                       (ta.grad, tx.grad)):
            assert da.dtype == dx.dtype == dtype
            assert torch.equal(_bits(dx), _bits(dhs))
            assert torch.equal(_bits(da), _bits(dhs * h_prev))

    def test_backward_of_an_expanded_cotangent(self):
        """``h.sum().backward()`` hands the backward a stride-0 cotangent."""
        a, x = (torch.from_numpy(v) for v in _scan_inputs(2, 9, 3, seed=5))
        ta, tx = a.clone().requires_grad_(), x.clone().requires_grad_()
        h = ops.rglru_scan(ta, tx)
        h.sum().backward()
        da, dx = rglru_scan_backward_ref(a, h.detach(), torch.ones_like(a))
        assert torch.equal(ta.grad, da) and torch.equal(tx.grad, dx)

    @pytest.mark.parametrize("reverse", [False, True])
    def test_plain_loop_definition(self, reverse):
        a, x = (torch.from_numpy(v) for v in _scan_inputs(2, 9, 5, seed=3))
        got = ops.scan(a, x, reverse=reverse)
        h = torch.zeros(2, 5)
        order = range(8, -1, -1) if reverse else range(9)
        for t in order:
            h = a[:, t] * h + x[:, t]
            assert torch.equal(got[:, t], h)
        flipped = rglru_scan_ref(a.flip(1), x.flip(1)).flip(1)
        assert torch.equal(got, flipped if reverse else rglru_scan_ref(a, x))

    def test_value_errors_and_cpu_launches_nothing(self):
        z = torch.zeros(1, 4, 3)
        with pytest.raises(ValueError, match="one \\(B, T, W\\) shape"):
            ops.rglru_scan(z, torch.zeros(1, 4, 2))
        with pytest.raises(ValueError, match="one \\(B, T, W\\) shape"):
            ops.rglru_scan(z[0], z[0])
        with pytest.raises(ValueError, match="one dtype"):
            ops.rglru_scan(z, z.double())
        with pytest.raises(ValueError, match="one dtype"):
            ops.rglru_scan(z.half(), z.half())
        meta = torch.zeros(1, 4, 3, device="meta")
        with pytest.raises(ValueError, match="CPU or a CUDA device"):
            ops.rglru_scan(meta, meta)
        before = launch_counts()
        ops.rglru_scan(z, z)
        ops.scan(z, z, reverse=True)
        assert launch_counts() == before
        assert "rglru_scan" in before

    def test_scan_backward_value_errors(self):
        z = torch.zeros(1, 4, 3)
        with pytest.raises(ValueError, match="one \\(B, T, W\\) shape"):
            scan_backward(z, z, torch.zeros(1, 4, 2))
        with pytest.raises(ValueError, match="one dtype"):
            scan_backward(z, z, z.bfloat16())
        with pytest.raises(ValueError, match="one dtype"):
            scan_backward(z.double(), z.double(), z.double())
        meta = torch.zeros(1, 4, 3, device="meta")
        with pytest.raises(ValueError, match="CPU or a CUDA device"):
            scan_backward(z, meta, z)
        assert "rglru_scan_bwd" in launch_counts()


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------


def _block_setup(seed=0):
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    params = jax.tree_util.tree_map(np.asarray, jax_ssm.init_rglru_params(
        jax.random.PRNGKey(seed), jcfg))
    x = (np.random.default_rng(seed + 1).standard_normal(
        (2, 64, cfg.d_model)) * 0.1).astype(np.float32)
    return cfg, jcfg, params, x


class TestRGLRUBlock:
    @pytest.mark.parametrize("use_kernel", [False, True])
    def test_apply_rglru_matches_reference(self, use_kernel):
        cfg, jcfg, params, x = _block_setup()
        want, _ = jax_ssm.apply_rglru(params, x, jcfg, mode="train",
                                      use_kernel=use_kernel)
        got, state = ssm.apply_rglru(params_from_numpy(params),
                                     torch.from_numpy(x), cfg, mode="train")
        assert state is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)

    def test_prefill_state_matches_reference(self):
        cfg, jcfg, params, x = _block_setup(seed=2)
        want, wstate = jax_ssm.apply_rglru(params, x, jcfg, mode="prefill")
        got, state = ssm.apply_rglru(params_from_numpy(params),
                                     torch.from_numpy(x), cfg,
                                     mode="prefill")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(state.h.numpy(), np.asarray(wstate.h),
                                   atol=2e-6)
        np.testing.assert_array_equal(state.conv.numpy(),
                                      np.asarray(wstate.conv))

    def test_gates_softplus_is_logaddexp_above_twenty(self):
        """``F.softplus`` turns into the identity above 20; the
        reference's ``logaddexp(x, 0)`` does not."""
        lam = np.array([-3.0, 0.0, 19.0, 20.5, 40.0], np.float32)
        np.testing.assert_array_equal(
            ssm._softplus(torch.from_numpy(lam)).numpy(),
            np.asarray(jax.nn.softplus(lam)))

    def test_param_shapes_keys_and_state(self):
        cfg, jcfg, params, _ = _block_setup()
        mine = ssm.init_rglru_params(torch.Generator().manual_seed(0), cfg)
        assert sorted(mine) == sorted(params) == [
            "conv", "in_gate", "in_x", "lam", "out", "w_igate", "w_rgate"]
        for k in mine:
            assert tuple(mine[k].shape) == params[k].shape, k
            assert mine[k].dtype == torch.float32
        meta = ssm.init_rglru_params(None, cfg, torch.bfloat16, "meta")
        assert meta["lam"].dtype == torch.float32          # always fp32
        assert meta["in_x"].dtype == torch.bfloat16
        # Λ lands a^c in (0.9, 0.999), as the reference's init
        a_c = torch.exp(-ssm._RGLRU_C * ssm._softplus(mine["lam"]))
        assert bool(((a_c > 0.9 - 1e-5) & (a_c < 0.999 + 1e-5)).all())
        st = ssm.init_rglru_state(cfg, 3)
        wst = jax_ssm.init_rglru_state(jcfg, 3)
        assert tuple(st.h.shape) == wst.h.shape
        assert tuple(st.conv.shape) == wst.conv.shape

    def test_decode_matches_reference(self):
        """The block's decode, 5 steps from its 64-token prefill state:
        the 4-tap conv over ``state.conv`` and the token, then ``h = a·h +
        x_in``; outputs within the block's bound, the state atol 2e-6 (its
        ``conv`` holds the input projection ``x @ in_x``, a float32 sum in
        another order)."""
        cfg, jcfg, params, x = _block_setup(seed=3)
        _, wstate = jax_ssm.apply_rglru(params, x, jcfg, mode="prefill")
        tp = params_from_numpy(params)
        _, state = ssm.apply_rglru(tp, torch.from_numpy(x), cfg,
                                   mode="prefill")
        rng = np.random.default_rng(9)
        for _ in range(5):
            xt = (rng.standard_normal((2, 1, cfg.d_model)) * 0.1
                  ).astype(np.float32)
            want, wstate = jax_ssm.apply_rglru(params, xt, jcfg,
                                               mode="decode", state=wstate)
            got, state = ssm.apply_rglru(tp, torch.from_numpy(xt), cfg,
                                         mode="decode", state=state)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(state.h.numpy(), np.asarray(wstate.h),
                                       atol=2e-6)
            np.testing.assert_allclose(state.conv.numpy(),
                                       np.asarray(wstate.conv), atol=2e-6)
        with pytest.raises(ValueError, match="one token and a state"):
            ssm.apply_rglru(tp, torch.from_numpy(x), cfg, mode="decode",
                            state=state)


# ---------------------------------------------------------------------------
# layout parity (bytes, profiles and plans: ``test_torch_models.py``)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axis", [1, 2, 3])
def test_full_width_flat_spec_layouts_equal_reference(axis):
    """Every sched layer's layout at the published widths, from shapes
    alone (the reduced model's values are held bitwise in
    ``test_torch_collectives.py``)."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    shapes = jax.eval_shape(lambda k: jax_model.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    mine = model.sched_layer_trees(model.param_shapes(cfg))
    theirs = jax_model.sched_layer_trees(shapes)
    assert len(mine) == len(theirs) == cfg.num_layers + 2
    for t, t_ref in zip(mine, theirs):
        spec, spec_ref = coll.make_flat_spec(t, axis), \
            jax_coll.make_flat_spec(t_ref, axis)
        for field in ("shapes", "offsets", "sizes", "total", "padded",
                      "axis_size", "shard_size"):
            assert getattr(spec, field) == getattr(spec_ref, field), field


# ---------------------------------------------------------------------------
# the slice as a whole: recurrentgemma-2b under ``zero``
# ---------------------------------------------------------------------------


def _runtime_configs(strategy="dynacomm"):
    kw = dict(runtime="zero", arch=ARCH, reduced=True, batch=2, seq=SEQ)
    return (RuntimeConfig(**kw, schedule=ScheduleConfig(strategy=strategy)),
            JaxRuntimeConfig(**kw))


def _archs():
    """Reduced recurrentgemma-2b with 3 layers: (rglru, rglru, local_attn),
    so the windowed attention runs beside the recurrence."""
    return (dataclasses.replace(get_config(ARCH).reduced(), num_layers=3),
            dataclasses.replace(jax_get_config(ARCH).reduced(),
                                num_layers=3))


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    config, jconfig = _runtime_configs()
    _, jarch = _archs()
    rt = jax_build_runtime(jconfig, model=jarch)
    init = jax.tree_util.tree_map(np.asarray, rt._state)
    path = str(tmp_path_factory.mktemp("ref") / "reference.npz")
    rt.save_state(path)
    return dict(init=init, losses=rt.fit(3), plan=rt.plan,
                ledger=rt.ledger, specs=rt.trainer.specs, ckpt=path)


def test_zero_matches_reference(reference_run, tmp_path):
    config, _ = _runtime_configs()
    arch, _ = _archs()
    assert arch.layer_kinds() == ("rglru", "rglru", "local_attn")
    rt = build_runtime(config, model=arch, device="cpu")
    ref = reference_run
    assert (rt.plan.forward, rt.plan.backward) == (ref["plan"].forward,
                                                   ref["plan"].backward)
    for spec, spec_ref in zip(rt.trainer.specs, ref["specs"]):
        for field in ("shapes", "offsets", "sizes", "total", "padded",
                      "axis_size", "shard_size"):
            assert getattr(spec, field) == getattr(spec_ref, field), field
    state = ref["init"]
    rt._state = zero_state_from_numpy(
        rt.trainer, state["flat_params"], state["opt"].mu, state["opt"].nu,
        int(state["opt"].step))
    losses = rt.fit(3)
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
    assert rt.ledger == ref["ledger"]
    path = str(tmp_path / "port.npz")
    rt.save_state(path)
    with np.load(path) as mine, np.load(ref["ckpt"]) as theirs:
        assert sorted(mine.files) == sorted(theirs.files)
        for k in mine.files:
            assert mine[k].shape == theirs[k].shape, k


def test_losses_bitwise_across_strategies():
    arch, _ = _archs()
    runs = {}
    for strategy in STRATEGIES:
        rt = build_runtime(_runtime_configs(strategy)[0], model=arch,
                           device="cpu")
        runs[strategy] = (rt.fit(3), (rt.plan.forward, rt.plan.backward))
    want = runs["dynacomm"][0]
    assert all(np.isfinite(want))
    assert all(losses == want for losses, _ in runs.values())
    assert len({plan for _, plan in runs.values()}) > 1


def test_launcher_recipe_on_the_cpu(capsys):
    from repro_torch.launch.train import main
    losses = main(["--arch", ARCH, "--reduced", "--runtime", "zero",
                   "--steps", "3", "--seq", str(SEQ), "--device", "cpu",
                   "--log-every", "0"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "[zero] 1 ranks; 2 pull / 2 push buckets" in out
