"""The stacked-layer model (``repro_torch.models.scanned``) against the
reference's scan-over-layers model and against the port's own unrolled
model, on the CPU.

Both packages start from the reference's weights (``params_from_numpy``)
and the same numpy batch, at ``reduced(num_layers=4)`` (the reference's
``test_scanned_matches_unrolled`` archs, with hubert-xlarge and
llava-next-34b for the two frontends); xlstm-350m at 8 layers, one full
period of its pattern (7 mLSTM + 1 sLSTM), so that it has a group.

Tolerances, each with its reason:

* the port's stacked model against its own unrolled model: bitwise
  (logits, aux, loss and every unstacked gradient).  A group runs the
  same blocks on the same values, and ``torch.unbind`` stacks the groups'
  gradients without adding zeros to them;
* against the reference: each array within ``RTOL`` of its own largest
  magnitude (float32 sums in another order in XLA and in PyTorch; a
  gradient leaf is a sum over tokens, so its roundoff scales with the
  leaf).  xLSTM within ``XLSTM_RTOL``: its mLSTM normaliser sits near
  cancellation (``tests/test_torch_xlstm.py``);
* paths, shapes and dtypes exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as jax_model
from repro.models import scanned as jax_scanned
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import model, scanned

RTOL = 1e-5
XLSTM_RTOL = 1e-3
ARCHS = ("granite-3-2b", "gemma2-2b", "xlstm-350m", "recurrentgemma-2b",
         "grok-1-314b", "hubert-xlarge", "llava-next-34b")
B, T = 2, 32
LAYERS = {"xlstm-350m": 8}


def _configs(name):
    n = LAYERS.get(name, 4)
    return (get_config(name).reduced(num_layers=n),
            jax_get_config(name).reduced(num_layers=n))


def _numpy_params(jcfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, jax_model.init_params(
        jcfg, jax.random.PRNGKey(seed)))


def _numpy_batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal((B, T, cfg.d_model))
                .astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, T),
                                       dtype=np.int32)}
    nv = min(cfg.num_vision_tokens, T - 1) if cfg.frontend == "vision" \
        else 0
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T - nv),
                                    dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, T - nv),
                                    dtype=np.int32)}
    if nv:
        batch["vision_embeds"] = rng.standard_normal(
            (B, nv, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


def _rtol(cfg):
    return XLSTM_RTOL if cfg.family == "ssm" else RTOL


def _close(cfg, got, want, what):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()) if want.size else 0.0,
                np.finfo(np.float32).tiny)
    gap = float(np.abs(got.astype(np.float64) - want).max()) / scale \
        if want.size else 0.0
    assert gap <= _rtol(cfg), f"{what}: gap {gap:.3e} of the scale"


def _bitwise(a, b, what):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert torch.equal(a.view(torch.int32), b.view(torch.int32)), what


def _setup(name):
    cfg, jcfg = _configs(name)
    params_np = _numpy_params(jcfg)
    batch_np = _numpy_batch(cfg)
    params = params_from_numpy(params_np)
    return cfg, jcfg, params_np, batch_np, params


def _grads(loss, t):
    leaves = tree.leaves(t)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True,
                             materialize_grads=True)
    return tree.unflatten(tree.structure(t), list(gs))


@pytest.mark.parametrize("name", ARCHS)
def test_stacked_paths_equal_the_reference_and_round_trip(name):
    cfg, jcfg, params_np, _, params = _setup(name)
    sp = scanned.stack_layer_params(cfg, params)
    jsp = jax_scanned.stack_layer_params(jcfg, params_np)
    want = [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), np.asarray(leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(jsp)[0]]
    got = [("/".join(str(k) for k in path), leaf)
           for path, leaf in tree.leaves_with_paths(sp)]
    assert [p for p, _ in got] == [p for p, _ in want]
    assert scanned.group_count(cfg)[0] > 0
    assert any(p.startswith("stack/0/") for p, _ in got)
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=path)
    back = scanned.unstack_layer_params(cfg, sp)
    for a, b in zip(tree.leaves(back), tree.leaves(params)):
        _bitwise(a, b, name)
    assert scanned.group_count(cfg) == jax_scanned.group_count(jcfg)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_the_reference_and_the_unrolled_model(name):
    cfg, jcfg, params_np, batch_np, params = _setup(name)
    batch = _torch_batch(batch_np)
    sp = scanned.stack_layer_params(cfg, params)
    logits, caches, aux = scanned.forward_scanned(cfg, sp, batch,
                                                  remat=False)
    assert caches is None
    u_logits, _, u_aux = model.forward(cfg, params, batch)
    _bitwise(logits, u_logits, "logits against the unrolled model")
    _bitwise(aux, u_aux, "aux against the unrolled model")
    jsp = jax_scanned.stack_layer_params(jcfg, params_np)
    j_logits, _, j_aux = jax.jit(lambda p, b: jax_scanned.forward_scanned(
        jcfg, p, b, remat=False))(
        jsp, {k: jnp.asarray(v) for k, v in batch_np.items()})
    _close(cfg, logits.numpy(), j_logits, "logits")
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=RTOL,
                               atol=1e-7)


GRAD_CASES = [(name, {"remat": True}) for name in ARCHS] + [
    ("granite-3-2b", kw) for kw in ({"remat": True, "remat_sqrt": 2},
                                    {"remat": False, "remat_sqrt": 2},
                                    {"remat": True, "barrier": True})]


@pytest.mark.parametrize("name,kw", GRAD_CASES,
                         ids=[f"{n}-{'-'.join(f'{k}{v}' for k, v in kw.items())}"
                              for n, kw in GRAD_CASES])
def test_gradients_match_the_reference_and_the_unrolled_model(name, kw):
    cfg, jcfg, params_np, batch_np, params = _setup(name)
    batch = _torch_batch(batch_np)
    sp = scanned.stack_layer_params(cfg, params)
    for x in tree.leaves(sp):
        x.requires_grad_()
    loss = scanned.train_loss_scanned(cfg, sp, batch, **kw)
    grads = scanned.unstack_layer_params(cfg, _grads(loss, sp))

    for x in tree.leaves(params):
        x.requires_grad_()
    u_loss = model.train_loss(cfg, params, batch, remat=True)
    _bitwise(loss.detach(), u_loss.detach(), "loss against unrolled")
    for a, b in zip(tree.leaves(grads), tree.leaves(_grads(u_loss, params))):
        _bitwise(a, b, "a gradient against the unrolled model's")

    jsp = jax_scanned.stack_layer_params(jcfg, params_np)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_scanned.train_loss_scanned(jcfg, p, jbatch, **kw)))(jsp)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=RTOL)
    j_flat = jax.tree_util.tree_flatten_with_path(
        jax_scanned.unstack_layer_params(jcfg, j_grads))[0]
    assert len(j_flat) == len(tree.leaves(grads))
    for (path, want), got in zip(j_flat, tree.leaves(grads)):
        _close(cfg, got.numpy(), want, jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", [n for n in ARCHS if n != "hubert-xlarge"])
def test_prefill_caches_match_the_reference(name):
    cfg, jcfg, params_np, batch_np, params = _setup(name)
    batch_np = {k: v for k, v in batch_np.items() if k != "labels"}
    batch = _torch_batch(batch_np)
    sp = scanned.stack_layer_params(cfg, params)
    with torch.no_grad():
        logits, caches, _ = scanned.forward_scanned(
            cfg, sp, batch, mode="prefill", last_only=True)
    jsp = jax_scanned.stack_layer_params(jcfg, params_np)
    j_logits, j_caches, _ = jax.jit(lambda p, b: jax_scanned.forward_scanned(
        jcfg, p, b, mode="prefill", remat=False, last_only=True))(
        jsp, {k: jnp.asarray(v) for k, v in batch_np.items()})
    _close(cfg, logits.numpy(), j_logits, "last logits")
    n_groups, rem = scanned.group_count(cfg)
    assert len(caches["remainder"]) == rem
    if n_groups:
        assert len(caches["scanned"]) == len(cfg.layer_pattern)
    else:
        assert caches["scanned"] is None
    j_leaves = jax.tree_util.tree_flatten_with_path(j_caches)[0]
    leaves = tree.leaves(caches)
    assert len(leaves) == len(j_leaves)
    for got, (path, want) in zip(leaves, j_leaves):
        what = jax.tree_util.keystr(path)
        assert got.dtype == {np.dtype(np.float32): torch.float32,
                             np.dtype(np.int32): torch.int32}[want.dtype], \
            what
        _close(cfg, got.numpy(), want, what)
    # the stacked caches are the unrolled prefill's, group by group
    _, u_caches, _ = model.forward(cfg, params, batch, mode="prefill",
                                   last_only=True)
    p = len(cfg.layer_pattern)
    for i in range(n_groups):
        for j in range(p):
            for got, want in zip(tree.leaves(caches["scanned"][j]),
                                 tree.leaves(u_caches[i * p + j])):
                _bitwise(got[i], want, f"group {i} slot {j}")
