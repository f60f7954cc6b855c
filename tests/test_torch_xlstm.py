"""The port's xLSTM (``repro_torch.models.ssm``: mLSTM and sLSTM) and
xlstm-350m under the ``zero`` trainer, against the reference on the CPU.

Weights and inputs are numpy, made from seeds (the reference's
initialisers, carried across by ``interop``).  The mLSTM's three forms are
each held to the reference's own function: the parallel form (T <= 256),
the chunkwise form (T = 128, 320 and 512: 320 halves the chunk to 64) and
the decode step, run T times as the recurrence's oracle against the
chunkwise final state.  The sLSTM step includes the t = 0 tie of
``maximum(n, 1)``, whose gradient JAX splits in halves.

Tolerances, each with its reason:

* every output, state and gradient leaf of one form, one step or one
  block within 1e-4 of the leaf's own largest magnitude
  (``chip_smoke.leaf_gap``): float32 sums in another order in XLA and
  PyTorch (einsum contraction paths, cumulative sums), divided by the
  mLSTM's normaliser ``max(|Σ s·D|, exp(-m))``, which sits near
  cancellation for some rows (measured: the parallel form's output 2e-6
  of its scale, 4.2e-5 absolute on values up to 22; the float64 answer
  lies between the two float32 ones);
* the reference's own claim, chunkwise (chunk 32) against parallel, atol
  5e-4 (``tests/test_models.py::test_mlstm_chunkwise_matches_parallel``),
  here torch against torch;
* losses rtol 1e-5;
* the 8-layer model's gradients within 2e-3 of each leaf's largest
  magnitude: eight normalisers compound the roundoff (measured: 1.15e-3 at
  worst).  ``test_float64_witness_shows_the_model_gap_is_roundoff`` holds
  the reason: the port's and the reference's float32 gradients each lie
  within half that bound of the port's float64 gradient (measured 6.5e-4
  and 5.0e-4 at worst);
* the trainers take SGD steps for their loss trajectory: AdamW's first
  step is sign-like, so an entry whose gradient sits at roundoff level
  moves by ±lr either way (measured with AdamW: 3.7e-5 relative at step
  2); the step's gradients themselves are compared, flat by flat, and the
  second loss within 1e-5 plus the first-order reach of that gradient
  gap, lr·‖g‖·‖Δg‖ (measured at 8 layers: 9.5e-6 relative);
* byte counts, parameter keys, shapes and plans exactly.
"""

import dataclasses
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import blocks as jax_blocks
from repro.models import model as jax_model
from repro.models import ssm as jax_ssm
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import blocks, model, ssm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "helpers"))
import torch_trainer_parity as parity  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)

ARCH = "xlstm-350m"
LOSS_RTOL = 1e-5
LEAF_RTOL = 1e-4
MODEL_LEAF_RTOL = 2e-3    # 8 layers: see the float64 witness


def _configs(**changes):
    """Reduced xlstm-350m in both packages; 8 layers hold the pattern's one
    sLSTM block (``reduced()`` keeps 2 layers: both mLSTM)."""
    changes = dict({"num_layers": 8}, **changes)
    return (dataclasses.replace(get_config(ARCH).reduced(), **changes),
            dataclasses.replace(jax_get_config(ARCH).reduced(), **changes))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _gap(got, want):
    return SMOKE.leaf_gap(_t(_np(got)), _t(_np(want)))


def _leaf_close(got, want, what="", rtol=LEAF_RTOL):
    gap = _gap(got, want)
    assert gap <= rtol, f"{what}: {gap:.3g} of the leaf's scale"


def _forms_inputs(b, h, t, hd, seed=0):
    """q, k, v (B,H,T,hd) and the gates (B,H,T); the forget gate biased
    open, as ``test_mlstm_chunkwise_matches_parallel``."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, hd)).astype(np.float32)
               for _ in range(3))
    ig = rng.standard_normal((b, h, t)).astype(np.float32)
    fg = (rng.standard_normal((b, h, t)) + 2.0).astype(np.float32)
    return q, k, v, ig, fg


# ---------------------------------------------------------------------------
# the mLSTM's three forms
# ---------------------------------------------------------------------------


def test_mlstm_parallel_and_its_vjp_match_reference():
    inputs = _forms_inputs(2, 2, 128, 16)
    ct = np.random.default_rng(9).standard_normal(
        (2, 2, 128, 16)).astype(np.float32)
    want, vjp = jax.vjp(jax_ssm._mlstm_parallel, *inputs)
    wgrads = vjp(ct)
    args = [_t(x).requires_grad_() for x in inputs]
    got = ssm._mlstm_parallel(*args)
    grads = torch.autograd.grad(got, args, _t(ct))
    _leaf_close(got, want, "output")
    for name, g, w in zip("qkvif", grads, wgrads):
        _leaf_close(g, w, name)


@pytest.mark.parametrize("t", [128, 320, 512])
def test_mlstm_chunkwise_matches_reference(t):
    """Default chunk (256): T = 128 is one chunk of 128, T = 320 halves the
    chunk to 64 (``while t % chunk``), T = 512 is two chunks of 256."""
    inputs = _forms_inputs(1, 2, t, 16, seed=t)
    want, wstate = jax_ssm._mlstm_chunkwise(*inputs)
    got, state = ssm._mlstm_chunkwise(*map(_t, inputs))
    _leaf_close(got, want, "output")
    for name in ("c", "n", "m"):
        _leaf_close(getattr(state, name), getattr(wstate, name), name)


def test_mlstm_chunkwise_vjp_matches_reference():
    inputs = _forms_inputs(1, 2, 320, 16, seed=4)
    ct = np.random.default_rng(5).standard_normal(
        (1, 2, 320, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jax_ssm._mlstm_chunkwise(*a)[0], *inputs)
    wgrads = vjp(ct)
    args = [_t(x).requires_grad_() for x in inputs]
    grads = torch.autograd.grad(ssm._mlstm_chunkwise(*args)[0], args, _t(ct))
    for name, g, w in zip("qkvif", grads, wgrads):
        _leaf_close(g, w, name)


def test_mlstm_chunkwise_matches_parallel():
    """The reference's claim (chunk 32 against the parallel form), torch
    against torch."""
    q, k, v, ig, fg = map(_t, _forms_inputs(2, 2, 128, 16, seed=3))
    h_par = ssm._mlstm_parallel(q, k, v, ig, fg)
    h_chk, _ = ssm._mlstm_chunkwise(q, k, v, ig, fg, chunk=32)
    np.testing.assert_allclose(h_par.numpy(), h_chk.numpy(), atol=5e-4)


def test_mlstm_steps_reach_the_chunkwise_state():
    """T decode steps from the zero state: each step's output against the
    reference's step and the parallel form's row, and the final state
    against the chunkwise form's."""
    b, h, t, hd = 2, 2, 48, 16
    q, k, v, ig, fg = _forms_inputs(b, h, t, hd, seed=7)
    state = ssm.MLSTMState(c=torch.zeros(b, h, hd, hd),
                           n=torch.zeros(b, h, hd), m=torch.zeros(b, h))
    wstate = jax_ssm.MLSTMState(c=jnp.zeros((b, h, hd, hd)),
                                n=jnp.zeros((b, h, hd)),
                                m=jnp.zeros((b, h)))
    par = ssm._mlstm_parallel(*map(_t, (q, k, v, ig, fg)))
    for i in range(t):
        step = [x[:, :, i] for x in (q, k, v, ig, fg)]
        out, state = ssm._mlstm_step(*map(_t, step), state)
        wout, wstate = jax_ssm._mlstm_step(*step, wstate)
        _leaf_close(out, wout, f"step {i}")
        np.testing.assert_allclose(out.numpy(), par[:, :, i].numpy(),
                                   atol=5e-4)
    _, final = ssm._mlstm_chunkwise(*map(_t, (q, k, v, ig, fg)), chunk=16)
    for name in ("c", "n", "m"):
        _leaf_close(getattr(state, name), getattr(final, name), name)
        _leaf_close(getattr(state, name), getattr(wstate, name), name)


def test_mlstm_state_shapes_use_the_projected_head_dim():
    """The mLSTM's head dim is ``di // num_heads`` (512 at full width), not
    ``cfg.head_dim`` (256)."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    st = ssm.init_mlstm_state(cfg, 2, device="meta")
    wst = jax_ssm.init_mlstm_state(jcfg, 2)
    assert tuple(st.c.shape) == wst.c.shape == (2, 4, 512, 512)
    assert cfg.head_dim == 256
    assert tuple(st.n.shape) == wst.n.shape
    assert tuple(st.m.shape) == wst.m.shape


# ---------------------------------------------------------------------------
# the sLSTM step and its t = 0 tie
# ---------------------------------------------------------------------------


def _slstm_setup(seed=0, t=24):
    cfg, jcfg = _configs()
    params = jax.tree_util.tree_map(np.asarray, jax_ssm.init_slstm_params(
        jax.random.PRNGKey(seed), jcfg))
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, t, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, params, x


def test_slstm_step_matches_reference_from_a_random_state():
    cfg, jcfg, params, x = _slstm_setup()
    rng = np.random.default_rng(3)
    st = [rng.standard_normal((2, cfg.d_model)).astype(np.float32)
          for _ in range(4)]
    st[1] = np.abs(st[1]) + 0.5                       # n > 0
    want = jax_ssm._slstm_step(params, x[:, 0], jax_ssm.SLSTMState(*st))
    got = ssm._slstm_step(params_from_numpy(params), _t(x[:, 0]),
                          ssm.SLSTMState(*map(_t, st)))
    for name in ("c", "n", "h", "m"):
        _leaf_close(getattr(got, name), getattr(want, name), name)


def test_slstm_t0_tie_gradient_is_split_as_jax_grad():
    """At t = 0 from the zero state with ĩ >= log f, n = 1.0 exactly and
    ``maximum(n, 1)`` ties: JAX gives n half the cotangent.  There n is
    constant in the weights and the input (m_new = ĩ makes i_p = 1), so
    the split shows in the gradient of the incoming state's n (n = f_p·n₀
    + i_p).  The port's gradients equal ``jax.grad``'s; with
    ``clamp(min=1)`` (all of the cotangent to n) n₀'s gradient is off by
    the tied entries' whole share."""
    cfg, jcfg, params, x = _slstm_setup(seed=2)
    x0 = x[:, 0]
    zero = [np.zeros((2, cfg.d_model), np.float32) for _ in range(4)]
    w = np.arange(1.0, cfg.d_model + 1.0, dtype=np.float32) / cfg.d_model

    def jax_h(p, xt, st):
        return jnp.sum(jax_ssm._slstm_step(p, xt, jax_ssm.SLSTMState(*st)).h
                       * w)
    wgp, wgx, wgs = jax.grad(jax_h, argnums=(0, 1, 2))(params, x0, zero)

    def port_grads(step):
        p = params_from_numpy(params, requires_grad=True)
        xt = _t(x0).requires_grad_()
        st = [_t(z).requires_grad_() for z in zero]
        s = step(p, xt, ssm.SLSTMState(*st))
        ties = int((s.n == 1.0).sum())
        grads = torch.autograd.grad((s.h * _t(w)).sum(),
                                    tree.leaves(p) + [xt] + st,
                                    allow_unused=True,
                                    materialize_grads=True)
        return ties, grads

    ties, grads = port_grads(ssm._slstm_step)
    assert ties > 0                  # the tie is reached at t = 0
    wants = jax.tree_util.tree_leaves(wgp) + [wgx] + list(wgs)
    names = [str(path) for path, _ in tree.leaves_with_paths(params)] + [
        "x_t", "c0", "n0", "h0", "m0"]
    for name, g, want in zip(names, grads, wants):
        _leaf_close(g, want, name)

    def clamped(p, xt, s):
        real = torch.maximum
        try:
            torch.maximum = lambda a, b: (a.clamp(min=1.0) if b.ndim == 0
                                          else real(a, b))
            return ssm._slstm_step(p, xt, s)
        finally:
            torch.maximum = real
    _, bad = port_grads(clamped)
    n0 = names.index("n0")
    assert SMOKE.leaf_gap(bad[n0], _t(np.asarray(wants[n0]))) > 0.1


def test_log_sigmoid_is_minus_softplus_of_minus_x():
    x = np.array([-40.0, -20.5, -3.0, 0.0, 3.0, 20.5, 40.0], np.float32)
    np.testing.assert_array_equal(ssm._log_sigmoid(_t(x)).numpy(),
                                  np.asarray(jax.nn.log_sigmoid(x)))


# ---------------------------------------------------------------------------
# the blocks: apply_mlstm / apply_slstm in train and prefill
# ---------------------------------------------------------------------------


def _mlstm_setup(t, seed=0):
    cfg, jcfg = _configs()
    params = jax.tree_util.tree_map(np.asarray, jax_ssm.init_mlstm_params(
        jax.random.PRNGKey(seed), jcfg))
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, t, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, params, x


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("t", [64, 320])
def test_apply_mlstm_matches_reference(mode, t):
    """T = 64 runs the parallel form (prefill: the chunkwise state at
    chunk 64); T = 320 runs the chunkwise form at chunk 64."""
    cfg, jcfg, params, x = _mlstm_setup(t)
    want, wstate = jax_ssm.apply_mlstm(params, x, jcfg, mode=mode)
    got, state = ssm.apply_mlstm(params_from_numpy(params), _t(x), cfg,
                                 mode=mode)
    _leaf_close(got, want, "output")
    if mode == "train":
        assert state is None and wstate is None
    else:
        for name in ("c", "n", "m"):
            _leaf_close(getattr(state, name), getattr(wstate, name), name)


def test_mlstm_chunk_is_a_patchable_module_attribute(monkeypatch):
    """``MLSTM_CHUNK = 32``: T = 64 takes the chunkwise form (two chunks),
    as the reference does under the same patch."""
    cfg, jcfg, params, x = _mlstm_setup(64, seed=4)
    monkeypatch.setattr(jax_ssm, "MLSTM_CHUNK", 32)
    monkeypatch.setattr(ssm, "MLSTM_CHUNK", 32)
    calls = []
    real = ssm._mlstm_chunkwise
    monkeypatch.setattr(ssm, "_mlstm_chunkwise",
                        lambda *a, **k: calls.append(a[0].shape) or
                        real(*a, **k))
    want, _ = jax_ssm.apply_mlstm(params, x, jcfg, mode="train")
    got, _ = ssm.apply_mlstm(params_from_numpy(params), _t(x), cfg,
                             mode="train")
    assert len(calls) == 1
    _leaf_close(got, want, "output")


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_apply_slstm_matches_reference(mode):
    cfg, jcfg, params, x = _slstm_setup(seed=5, t=40)
    want, wstate = jax_ssm.apply_slstm(params, x, jcfg, mode=mode)
    got, state = ssm.apply_slstm(params_from_numpy(params), _t(x), cfg,
                                 mode=mode)
    _leaf_close(got, want, "output")
    if mode == "train":
        assert state is None and wstate is None
    else:
        for name in ("c", "n", "h", "m"):
            _leaf_close(getattr(state, name), getattr(wstate, name), name)


def test_slstm_hoisted_input_products_equal_the_stepwise_loop():
    """``apply_slstm`` takes the four ``x @ W_g`` for all T at once; a loop
    of ``_slstm_step`` (the reference's order) gives the same states to
    roundoff."""
    cfg, _, params, x = _slstm_setup(seed=6, t=32)
    p = params_from_numpy(params)
    _, state = ssm.apply_slstm(p, _t(x), cfg, mode="prefill")
    s = ssm.init_slstm_state(cfg, 2)
    for i in range(x.shape[1]):
        s = ssm._slstm_step(p, _t(x[:, i]), s)
    for name in ("c", "n", "h", "m"):
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   getattr(s, name).numpy(), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_and_its_pullback_match_reference(kind):
    """``apply_block`` (norm, the recurrent mixer, the residual; no MLP at
    d_ff 0) and its VJP, as ``ZeroTrainer`` takes it."""
    cfg, jcfg = _configs()
    params = jax.tree_util.tree_map(np.asarray, jax_blocks.init_block(
        jax.random.PRNGKey(3), jcfg, kind))
    assert sorted(params) == sorted(["norm1", kind])
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda p, h: jax_blocks.apply_block(
        p, h, jcfg, kind, mode="train")[0], params, x)
    wgp, wgx = vjp(ct)
    p = params_from_numpy(params, requires_grad=True)
    h = _t(x).requires_grad_()
    got, cache, aux = blocks.apply_block(p, h, cfg, kind, mode="train")
    assert cache is None and float(aux) == 0.0
    grads = torch.autograd.grad(got, tree.leaves(p) + [h], _t(ct))
    _leaf_close(got, want, "output")
    for (path, _), g, w in zip(tree.leaves_with_paths(p), grads,
                               jax.tree_util.tree_leaves(wgp)):
        _leaf_close(g, w, str(path))
    _leaf_close(grads[-1], wgx, "x")


def test_param_keys_and_shapes_match_reference():
    cfg, jcfg = _configs()
    for kind, init, jinit in (
            ("mlstm", ssm.init_mlstm_params, jax_ssm.init_mlstm_params),
            ("slstm", ssm.init_slstm_params, jax_ssm.init_slstm_params)):
        mine = init(torch.Generator().manual_seed(0), cfg)
        theirs = jinit(jax.random.PRNGKey(0), jcfg)
        assert sorted(mine) == sorted(theirs), kind
        for k in mine:
            assert tuple(mine[k].shape) == theirs[k].shape, (kind, k)
    r = ssm.init_slstm_params(torch.Generator().manual_seed(0), cfg)
    # the recurrent matrices are drawn at a tenth of the input ones' scale
    assert float(r["ri"].std()) < 0.2 * float(r["wi"].std())


# ---------------------------------------------------------------------------
# the model and the zero trainer
# ---------------------------------------------------------------------------


def _batch(cfg, b=2, t=48, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _torch_batch(toks, labels):
    return {"tokens": torch.from_numpy(toks).long(),
            "labels": torch.from_numpy(labels).long()}


def test_reduced_model_holds_an_slstm_block():
    cfg, _ = _configs()
    assert cfg.layer_kinds() == ("mlstm",) * 7 + ("slstm",)
    assert get_config(ARCH).reduced().layer_kinds() == ("mlstm",) * 2
    full = get_config(ARCH).layer_kinds()
    assert [i + 1 for i, k in enumerate(full) if k == "slstm"] == [8, 16, 24]


@pytest.fixture(scope="module")
def model_grads():
    """``train_loss`` and its gradients at 8 layers, T = 48: the
    reference's (float32), the port's in float32 and the port's in float64
    (``parity.in_float64``)."""
    cfg, jcfg = _configs()
    params = jax.tree_util.tree_map(np.asarray, jax_model.init_params(
        jcfg, jax.random.PRNGKey(1)))
    toks, labels = _batch(cfg)
    jbatch = {"tokens": toks, "labels": labels}
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_model.train_loss(jcfg, p, jbatch)))(params)
    out = {"ref": (float(want), [np.asarray(g) for g in
                                 jax.tree_util.tree_leaves(jgrads)]),
           "paths": [str(p) for p, _ in tree.leaves_with_paths(params)]}

    def port(dtype):
        tparams = tree.tree_map(lambda x: x.to(dtype).requires_grad_(),
                                params_from_numpy(params))
        loss = model.train_loss(cfg, tparams, _torch_batch(toks, labels))
        grads = torch.autograd.grad(loss, tree.leaves(tparams))
        return loss.item(), [g.float() for g in grads]
    out["f32"] = port(torch.float32)
    out["f64"] = parity.in_float64(lambda: port(torch.float64))
    return out


def test_train_loss_and_grads_match_reference(model_grads):
    loss, grads = model_grads["f32"]
    want, wgrads = model_grads["ref"]
    np.testing.assert_allclose(loss, want, rtol=LOSS_RTOL)
    for path, g, w in zip(model_grads["paths"], grads, wgrads):
        _leaf_close(g, w, path, MODEL_LEAF_RTOL)


def test_float64_witness_shows_the_model_gap_is_roundoff(model_grads):
    """Against the port's float64 gradients, the port's float32 ones and
    the reference's each lie within half the model bound, leaf by leaf
    (measured 6.5e-4 and 5.0e-4 at worst): the gap between the packages is
    float32 roundoff, not a formula."""
    _, exact = model_grads["f64"]
    mine = [_gap(g, e) for g, e in zip(model_grads["f32"][1], exact)]
    ref = [_gap(_t(w), e) for w, e in zip(model_grads["ref"][1], exact)]
    assert max(mine) <= MODEL_LEAF_RTOL / 2, max(mine)
    assert max(ref) <= MODEL_LEAF_RTOL / 2, max(ref)
    np.testing.assert_allclose(model_grads["f32"][0], model_grads["f64"][0],
                               rtol=LOSS_RTOL)


def test_float64_witness_shows_the_trajectory_parts_at_the_third_loss():
    """Plain SGD (lr 1e-2) on the 8-layer model, the port in float32
    against itself in float64: the first two losses agree to roundoff, the
    third does not (measured: 1.3e-8, 4.3e-6, then 3.5e-4).  The mLSTM's
    normaliser ``max(|Σ s·D|, exp(-m))`` sits near cancellation for some
    rows, so a roundoff difference in the weights grows by orders of
    magnitude a step: comparisons between two float32 runs (port against
    reference, card against CPU, S = 1 against S = 2) stop at the second
    loss."""
    cfg, _ = _configs()
    params0 = model.init_params(cfg, torch.Generator().manual_seed(0))
    toks, labels = _batch(cfg, t=48, seed=0)
    batch = _torch_batch(toks, labels)

    def trajectory(dtype):
        p = tree.tree_map(lambda x: x.to(dtype), params0)
        out = []
        for _ in range(3):
            p = tree.tree_map(lambda x: x.detach().requires_grad_(), p)
            loss = model.train_loss(cfg, p, batch)
            grads = torch.autograd.grad(loss, tree.leaves(p))
            out.append(loss.item())
            p = tree.unflatten(tree.structure(p), [
                x.detach() - 1e-2 * g for x, g in zip(tree.leaves(p), grads)])
        return out
    f32 = trajectory(torch.float32)
    f64 = parity.in_float64(lambda: trajectory(torch.float64))
    gaps = [abs(a - b) / abs(b) for a, b in zip(f32, f64)]
    assert max(gaps[:2]) <= LOSS_RTOL, gaps
    assert gaps[2] > 10 * LOSS_RTOL, gaps


def check_zero_run(out, rtol=LEAF_RTOL):
    """The step's gradient flats within ``rtol`` of each flat's largest
    magnitude; the first loss (the same parameters) within LOSS_RTOL; the
    second SGD loss within LOSS_RTOL plus what the gradient gap explains to
    first order: the two updates differ by lr·Δg, so the losses after
    them by at most lr·‖g‖·‖Δg‖."""
    _, grads = parity.gaps(out)
    assert max(grads) <= rtol, grads
    (l1, l2), (r1, r2) = out["sgd"][0], out["ref", "sgd"][0]
    assert out["grads"][0] == [l1]
    np.testing.assert_allclose([l1, out["ref", "grads"][0][0]], r1,
                               rtol=LOSS_RTOL)
    g = np.concatenate(out["ref", "grads"][1])
    dg = np.concatenate(out["grads"][1]) - g
    explained = parity.LR * np.linalg.norm(g) * np.linalg.norm(dg)
    assert abs(l2 - r2) <= LOSS_RTOL * abs(r2) + explained, \
        (l2, r2, explained)
    for spec, jspec in zip(out["tr"].specs, out["jtr"].specs):
        assert (spec.offsets, spec.sizes, spec.padded) == \
            (jspec.offsets, jspec.sizes, jspec.padded)


def test_zero_matches_reference():
    """8 layers (7 mLSTM, 1 sLSTM) at T = 48 under a 3-bucket plan."""
    cfg, jcfg = _configs()
    toks, labels = _batch(cfg)
    plan = (((0, 1, 2, 3, 4), (5, 6, 7, 8, 9)),
            ((9, 8), (7, 6, 5, 4, 3, 2, 1, 0)))
    out = parity.zero_runs(
        cfg, jcfg, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
        _torch_batch(toks, labels), plan)
    check_zero_run(out, MODEL_LEAF_RTOL)


def test_zero_through_the_chunkwise_form_matches_reference():
    """2 layers (mLSTM, sLSTM) at T = 320 > MLSTM_CHUNK: the chunkwise form
    (chunk 64) in the forward and in the recompute."""
    cfg, jcfg = _configs(num_layers=2, layer_pattern=("mlstm", "slstm"))
    toks, labels = _batch(cfg, b=2, t=320, seed=4)
    plan = (((0, 1, 2, 3),), ((3, 2, 1, 0),))
    out = parity.zero_runs(
        cfg, jcfg, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
        _torch_batch(toks, labels), plan)
    check_zero_run(out)


def test_eight_layer_bytes_and_the_full_width_count():
    """The 8-layer reduced model's per-sched-layer bytes equal the
    reference's (``tests/test_torch_models.py`` holds the published and
    2-layer configs), and the published one has 0.48 B parameters."""
    cfg, jcfg = _configs()
    assert model.sched_layer_bytes(cfg) == jax_model.sched_layer_bytes(jcfg)
    assert round(model.param_count(get_config(ARCH)) / 1e9, 2) == 0.48
