"""The audio and vision frontends (hubert-xlarge, llava-next-34b) in the
port against the reference on the CPU: the stub batches, the model's
loss and gradients, and the ZeRO and pipeline trainers.

The reference draws its stub frames and vision embeddings from
``jax.random``, which torch cannot replay (the port draws from a seeded
``torch.Generator``: ``models/frontend.py``); so every parity check here
takes the reference's batch and carries its arrays across as numpy, with
the reference's initial weights (``interop``).

Tolerances, each with its reason:

* losses rtol 1e-5 and each gradient leaf (or each sched layer's gradient
  flat) within 1e-4 of its own largest magnitude (``chip_smoke.leaf_gap``):
  float32 sums in another order in XLA and PyTorch, a gradient entry being
  a sum over tokens;
* batch shapes, dtypes and text values, byte counts and the padded labels
  exactly.
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
from repro.configs.base import InputShape as JaxInputShape
from repro.data.pipeline import batch_for as jax_batch_for
from repro.models import model as jax_model
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.data import batch_for
from repro_torch.interop import params_from_numpy
from repro_torch.models import frontend, model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "helpers"))
import torch_trainer_parity as parity  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)

LOSS_RTOL = 1e-5
LEAF_RTOL = 1e-4
ARCHS = ("hubert-xlarge", "llava-next-34b")
SEQ = 40          # llava: 16 vision tokens (reduced), 24 text tokens


def _configs(name, **changes):
    return (dataclasses.replace(get_config(name).reduced(), **changes),
            dataclasses.replace(jax_get_config(name).reduced(), **changes))


def _shapes(t=SEQ, b=2):
    return InputShape("t", t, b, "train"), JaxInputShape("t", t, b, "train")


def _reference_batch(jcfg, step=0, seed=3, t=SEQ, b=2):
    """The reference's batch as numpy, and the same arrays as torch
    tensors (integers as int64, as the port's batches)."""
    _, jshape = _shapes(t, b)
    ref = {k: np.asarray(v) for k, v in
           jax_batch_for(jcfg, jshape, step=step, seed=seed).items()}
    mine = {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i"
                                else v.copy())
            for k, v in ref.items()}
    return ref, mine


def _leaf_close(got, want, what=""):
    gap = SMOKE.leaf_gap(torch.as_tensor(np.array(got)),
                         torch.as_tensor(np.array(want)))
    assert gap <= LEAF_RTOL, f"{what}: {gap:.3g} of the leaf's scale"


# ---------------------------------------------------------------------------
# the stub batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("t", [SEQ, 8])
def test_batch_for_matches_reference_shapes_and_text(name, t):
    """Keys, shapes and dtypes as the reference's; the text tokens and
    labels equal value for value; the stubs N(0, 1) · 0.02 (a vision
    batch keeps at most t - 1 stub tokens: 16 at t = 40, 7 at t = 8)."""
    cfg, jcfg = _configs(name)
    shape, jshape = _shapes(t)
    mine = batch_for(cfg, shape, step=1, seed=2)
    theirs = jax_batch_for(jcfg, jshape, step=1, seed=2)
    assert sorted(mine) == sorted(theirs)
    for k, v in theirs.items():
        assert tuple(mine[k].shape) == v.shape, k
        kind = np.asarray(v).dtype.kind
        assert (mine[k].dtype == torch.int64) == (kind == "i"), k
        if kind == "i":
            np.testing.assert_array_equal(mine[k].numpy(), np.asarray(v))
    stub = mine.get("frames", mine.get("vision_embeds"))
    assert stub.dtype == torch.float32
    assert 0.015 < float(stub.std()) < 0.025
    if cfg.frontend == "vision":
        assert stub.shape[1] == min(cfg.num_vision_tokens, t - 1)


def test_stub_embeddings_are_a_function_of_the_seed():
    cfg, _ = _configs("llava-next-34b")
    a = frontend.vision_embeddings(cfg, 2, seed=5)
    assert torch.equal(a, frontend.vision_embeddings(cfg, 2, seed=5))
    assert not torch.equal(a, frontend.vision_embeddings(cfg, 2, seed=6))
    assert tuple(a.shape) == (2, cfg.num_vision_tokens, cfg.d_model)
    f = frontend.audio_frames(cfg, 3, 11, seed=5)
    assert tuple(f.shape) == (3, 11, cfg.d_model)
    assert frontend.audio_frames(cfg, 2, 4, dtype=torch.bfloat16).dtype == \
        torch.bfloat16


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_train_loss_and_grads_match_reference(name):
    """hubert: ``in_proj`` at sched layer 0 and the untied head at the
    last; llava: the vision embeddings prepended, the labels padded."""
    cfg, jcfg = _configs(name)
    params = jax.tree_util.tree_map(np.asarray, jax_model.init_params(
        jcfg, jax.random.PRNGKey(1)))
    ref, mine = _reference_batch(jcfg)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_model.train_loss(jcfg, p, ref)))(params)
    tparams = params_from_numpy(params, requires_grad=True)
    loss = model.train_loss(cfg, tparams, mine)
    grads = torch.autograd.grad(loss, tree.leaves(tparams))
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    for (path, _), g, w in zip(tree.leaves_with_paths(tparams), grads,
                               jax.tree_util.tree_leaves(jgrads)):
        _leaf_close(g.numpy(), w, str(path))
    embed = sorted(params["embed"])
    assert embed == (["in_proj"] if name == "hubert-xlarge" else ["table"])
    assert ("head" in params["final"]) == (name == "hubert-xlarge")


def test_vision_labels_are_padded_over_the_prepended_tokens():
    cfg, _ = _configs("llava-next-34b")
    _, batch = _reference_batch(jax_get_config("llava-next-34b").reduced())
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    logits, _, _ = model.forward(cfg, params, batch)
    nv = batch["vision_embeds"].shape[1]
    assert logits.shape[1] == nv + batch["tokens"].shape[1]
    padded = model.padded_labels(cfg, logits, batch["labels"])
    assert torch.equal(padded[:, :nv], torch.full((2, nv), -1))
    assert torch.equal(padded[:, nv:], batch["labels"])
    want = model.cross_entropy(logits[:, nv:], batch["labels"])
    got = model.train_loss(cfg, params, batch)
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)


def test_vision_decode_matches_reference():
    """llava's decoder decodes text tokens: a prefill of 24 text tokens,
    then 4 decode steps, logits and caches against the reference within
    the logit bound of ``tests/test_torch_serve.py`` (2e-5)."""
    from repro.serve import decode as jax_serve
    from repro_torch.serve import decode as serve
    cfg, jcfg = _configs("llava-next-34b")
    params = jax.tree_util.tree_map(np.asarray, jax_model.init_params(
        jcfg, jax.random.PRNGKey(1)))
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 24),
                                             dtype=np.int32)
    want, jcaches = jax_serve.prefill(jcfg, params, {"tokens": toks},
                                      max_len=28)
    tparams = params_from_numpy(params)
    with torch.inference_mode():
        got, caches = serve.prefill(cfg, tparams,
                                    {"tokens": torch.from_numpy(toks)},
                                    max_len=28)
        for i in range(5):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=2e-5, err_msg=f"step {i}")
            for mine, theirs in zip(caches, jcaches):
                for a, b in zip(mine, theirs):
                    np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                               atol=2e-5)
            tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None] \
                .astype(np.int32)
            want, jcaches = jax_model.decode_step(jcfg, params, tok, jcaches)
            got, caches = model.decode_step(cfg, tparams,
                                            torch.from_numpy(tok), caches)


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------

# 4 sched layers (embed, 2 blocks, final): two pull and two push buckets
PLAN = ((0, 1), (2, 3)), ((3,), (2, 1, 0))


def _check(out):
    loss, grads = parity.gaps(out)
    assert loss <= LOSS_RTOL, loss
    assert max(grads) <= LEAF_RTOL, grads


@pytest.mark.parametrize("name", ARCHS)
def test_zero_matches_reference(name):
    """hubert: the first untied head through the ZeRO step (``in_proj``'s
    gradient at sched layer 0, the head's at the last, no embedding
    contribution from the head); llava: the labels padded over the vision
    tokens in ``model.apply_final``."""
    cfg, jcfg = _configs(name)
    ref, mine = _reference_batch(jcfg)
    out = parity.zero_runs(cfg, jcfg, ref, mine, PLAN)
    _check(out)
    Ls = len(out["grads"][1])
    spec_embed, spec_final = out["tr"].specs[0], out["tr"].specs[Ls - 1]
    if name == "hubert-xlarge":
        assert spec_embed.shapes == ((cfg.d_model, cfg.d_model),)
        assert (cfg.d_model, cfg.vocab_size) in spec_final.shapes
    for l in (0, Ls - 1):          # the layers the head and frontend touch
        assert np.abs(out["grads"][1][l]).max() > 0


@pytest.mark.parametrize("stages", [1, 2])
def test_llava_pipeline_matches_reference(stages):
    """The pipeline's micro-batch split carries ``vision_embeds`` with the
    tokens, ``_ce_num`` pads the labels, ``_mask_den`` counts the text
    labels of the whole batch."""
    cfg, jcfg = _configs("llava-next-34b")
    ref, mine = _reference_batch(jcfg, b=4)
    out = parity.pipeline_runs(cfg, jcfg, ref, mine, stages=stages,
                               microbatches=2)
    _check(out)


def test_hubert_pipeline_matches_reference():
    cfg, jcfg = _configs("hubert-xlarge")
    ref, mine = _reference_batch(jcfg, b=4)
    out = parity.pipeline_runs(cfg, jcfg, ref, mine, stages=2,
                               microbatches=2)
    _check(out)


@pytest.mark.parametrize("name,buckets", [
    ("xlstm-350m", "3 pull / 2 push"), ("hubert-xlarge", "2 pull / 2 push"),
    ("llava-next-34b", "2 pull / 2 push")])
def test_launcher_recipe_on_the_cpu(capsys, name, buckets):
    """The launcher trains every family with no batch function given:
    ``build_runtime`` takes ``batch_for`` (frames for hubert, vision
    embeddings before the tokens for llava)."""
    from repro_torch.launch.train import main
    losses = main(["--arch", name, "--reduced", "--runtime", "zero",
                   "--steps", "2", "--seq", "32", "--batch", "2",
                   "--device", "cpu", "--log-every", "0"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert f"[zero] 1 ranks; {buckets} buckets" in capsys.readouterr().out
