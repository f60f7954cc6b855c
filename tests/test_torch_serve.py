"""Serving in the port (prefill, then decode against the KV caches and
recurrent states of every block kind; ``repro_torch.serve`` and the serve
launcher) against the reference on the CPU.

Both packages start from the reference's weights (``params_from_numpy``)
and, where a test starts mid-sequence, from the same caches
(``caches_from_numpy``); the port is fed the reference's greedy tokens, so
each step compares like with like.

Tolerances, each with its reason:

* logits and every cache leaf atol 2e-5 on reduced models (a few layers,
  d_model 256): float32 sums in another order in XLA and in PyTorch,
  carried through up to 60 decode steps (measured at most 7.6e-6);
* xLSTM (8 layers: 7 mLSTM, 1 sLSTM): each array within 1e-3 of its own
  largest magnitude.  The mLSTM's normaliser sits near cancellation
  (``tests/test_torch_xlstm.py``), and its matrix memory carries the
  prefill's roundoff into every step (measured 5.6e-5 after 6 steps,
  2.3e-4 after 60).  ``test_xlstm_float64_witness`` holds the reason: the
  port's and the reference's float32 runs each lie within half that bound
  of the port's float64 run (measured at most 8.3e-5 and 6.0e-5; the two
  1.4e-4 apart);
* the greedy token where the reference's top-2 margin exceeds twice the
  logit tolerance (inside it a tie may break either way);
* the port's decode against its own full forward 5e-4, the reference's
  bound for the same claim (``tests/test_models.py::
  test_prefill_decode_matches_full_forward``; measured at most 1.9e-6,
  xLSTM 1.8e-4);
* cache shapes, dtypes and positions exactly.

``tests/helpers/torch_serve_report.py`` prints the measured gaps.  The KV
caches are written in place by the port's decode step, so every
snapshot taken across steps is a copy.
"""

import dataclasses
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
from repro.serve import decode as jax_serve
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.interop import caches_from_numpy, params_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.models import blocks, model
from repro_torch.models.attention import KVCache
from repro_torch.serve import decode as serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "helpers"))
import torch_trainer_parity as parity  # noqa: E402

ATOL = 2e-5
XLSTM_LEAF_RTOL = 1e-3
FULL_FORWARD_ATOL = 5e-4
DECODE_ARCHS = ("granite-3-2b", "gemma2-2b", "gemma3-4b", "gemma-7b",
                "recurrentgemma-2b", "xlstm-350m", "granite-moe-1b-a400m",
                "llava-next-34b")
# layers past the two of ``reduced()`` where the pattern needs them: every
# kind of the family at least once
LAYERS = {"xlstm-350m": 8,              # 7 mLSTM + 1 sLSTM
          "recurrentgemma-2b": 3,       # rglru, rglru, local_attn
          "gemma3-4b": 6}               # 5 local + 1 global


def _configs(name, **changes):
    n = LAYERS.get(name, 2)
    return (dataclasses.replace(get_config(name).reduced(num_layers=n),
                                **changes),
            dataclasses.replace(jax_get_config(name).reduced(num_layers=n),
                                **changes))


def _params(jcfg, seed=1):
    return jax.tree_util.tree_map(np.asarray, jax_model.init_params(
        jcfg, jax.random.PRNGKey(seed)))


def _prompts(cfg, b, t, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t),
                                                dtype=np.int32)


def _numpy_caches(caches):
    """A copy of every cache leaf, in field order, as numpy."""
    return [tuple(np.array(x) for x in c) for c in caches]


def _atol(cfg, want) -> float:
    """``ATOL``, or for xLSTM ``XLSTM_LEAF_RTOL`` of the array's largest
    magnitude."""
    if cfg.family != "ssm":
        return ATOL
    return XLSTM_LEAF_RTOL * max(float(np.abs(want).max()) if want.size
                                 else 0.0, np.finfo(np.float32).tiny)


def _leaf_gap(got, want) -> float:
    """``|got - want|`` against ``want``'s largest magnitude."""
    return float(np.abs(got.astype(np.float64) - want).max()
                 / max(np.abs(want).max(), np.finfo(np.float32).tiny))


def _close(cfg, got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_allclose(got, want, atol=_atol(cfg, want), rtol=0,
                               err_msg=what)


def _assert_caches(cfg, got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(_numpy_caches(got), _numpy_caches(want))):
        assert len(g) == len(w), (what, i)
        for a, b in zip(g, w):
            _close(cfg, a, b, f"{what}: layer {i}")


def _assert_tokens(got_logits, want_logits, atol=ATOL):
    """The argmax where the wanted logits' top-2 margin exceeds 2·atol."""
    top2 = np.sort(want_logits, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * atol
    np.testing.assert_array_equal(np.argmax(got_logits, -1)[clear],
                                  np.argmax(want_logits, -1)[clear])
    return int(clear.sum())


def _reference_run(jcfg, params, prompts, steps, max_len=None,
                   caches=None):
    """The reference's prefill (or ``caches`` as given) and ``steps``
    greedy decode steps: logits per step, caches per step, tokens fed."""
    if caches is None:
        logits, caches = jax_serve.prefill(jcfg, params,
                                           {"tokens": jnp.asarray(prompts)},
                                           max_len=max_len)
        logits = [np.asarray(logits[:, -1])]
        cur = jnp.argmax(logits[0], -1)[:, None].astype(jnp.int32)
    else:
        logits, cur = [], jnp.asarray(prompts)
    step = jax.jit(jax_serve.build_decode_step(jcfg))
    snaps, fed = [_numpy_caches(caches)], []
    for _ in range(steps):
        fed.append(np.array(cur))
        out, caches = step(params, cur, caches)
        logits.append(np.asarray(out[:, -1]))
        snaps.append(_numpy_caches(caches))
        cur = jnp.argmax(out[:, -1], -1)[:, None].astype(jnp.int32)
    return logits, snaps, fed


def _port_run(cfg, params, prompts, fed, max_len=None, caches=None):
    """The port's prefill (or ``caches``) and one decode step a fed token:
    logits and cache copies per step."""
    step = serve.build_decode_step(cfg)
    with torch.inference_mode():
        if caches is None:
            logits, caches = serve.prefill(
                cfg, params, {"tokens": torch.from_numpy(prompts)},
                max_len=max_len)
            logits = [logits[:, -1].numpy()]
        else:
            logits = []
        snaps = [_numpy_caches(caches)]
        for tok in fed:
            out, caches = step(params, torch.from_numpy(tok), caches)
            logits.append(out[:, -1].numpy())
            snaps.append(_numpy_caches(caches))
    return logits, snaps


def _assert_runs(cfg, mine, theirs, what):
    (logits, snaps), (want_logits, want_snaps) = mine, theirs
    assert len(logits) == len(want_logits)
    for i, (g, w) in enumerate(zip(logits, want_logits)):
        _close(cfg, g, w, f"{what}: logits at step {i}")
        _assert_tokens(g, w, _atol(cfg, w))
    assert len(snaps) == len(want_snaps)
    for i, (g, w) in enumerate(zip(snaps, want_snaps)):
        for layer, (a, b) in enumerate(zip(g, w)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                _close(cfg, x, y, f"{what}: cache of layer {layer} at step "
                                  f"{i}")


# ---------------------------------------------------------------------------
# prefill + decode against the reference, every decodable family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """P = 70 (past the reduced window of 64: the local caches roll), then
    6 decode steps (the local caches rotate); logits, every cache leaf and
    the greedy tokens."""
    cfg, jcfg = _configs(arch)
    params = _params(jcfg)
    prompts = _prompts(cfg, 2, 70)
    want_logits, want_snaps, fed = _reference_run(jcfg, params, prompts, 6,
                                                  max_len=76)
    mine = _port_run(cfg, params_from_numpy(params), prompts, fed,
                     max_len=76)
    _assert_runs(cfg, mine, (want_logits, want_snaps), arch)


@pytest.mark.parametrize("prompt", [70, 300])
def test_xlstm_float64_witness(prompt):
    """The port in float64 (``Tensor.float`` kept in float64) against its
    float32 run and the reference's, over the prefill (P = 300 takes the
    chunkwise form) and 6 steps: both float32 runs lie within half the
    xLSTM bound of it, array by array, so the gap between the packages is
    float32 roundoff."""
    cfg, jcfg = _configs("xlstm-350m")
    params = _params(jcfg)
    prompts = _prompts(cfg, 2, prompt)
    want_logits, want_snaps, fed = _reference_run(jcfg, params, prompts, 6)
    mine = _port_run(cfg, params_from_numpy(params), prompts, fed)
    exact = parity.in_float64(lambda: _port_run(
        cfg, tree.tree_map(torch.Tensor.double, params_from_numpy(params)),
        prompts, fed))

    def worst(run):
        logits, snaps = run
        gaps = [_leaf_gap(g, e) for g, e in zip(logits, exact[0])]
        for s, e in zip(snaps, exact[1]):
            gaps += [_leaf_gap(x, y) for a, b in zip(s, e)
                     for x, y in zip(a, b) if y.size and y.dtype.kind == "f"]
        return max(gaps)
    assert worst(mine) <= XLSTM_LEAF_RTOL / 2
    assert worst((want_logits, want_snaps)) <= XLSTM_LEAF_RTOL / 2


@pytest.mark.parametrize("arch", DECODE_ARCHS + ("hubert-xlarge",))
@pytest.mark.parametrize("max_len", [48, 100])
def test_init_caches_match_reference_shapes(arch, max_len):
    """Shapes, dtypes and zeros of every block's empty cache (a local
    layer's ``min(max_len, window)`` slots)."""
    cfg, jcfg = _configs(arch)
    mine = model.init_caches(cfg, 3, max_len)
    theirs = jax_model.init_caches(jcfg, 3, max_len)
    assert [type(c).__name__ for c in mine] == \
        [type(c).__name__ for c in theirs]
    for a, b in zip(mine, theirs):
        assert type(a)._fields == type(b)._fields
        for x, y in zip(a, b):
            assert tuple(x.shape) == y.shape
            assert str(x.dtype).split(".")[-1] == str(y.dtype)
            assert not x.any()


@pytest.mark.parametrize("kind", ["global_attn", "local_attn", "mlstm",
                                  "slstm", "rglru"])
def test_block_decode_from_a_carried_state_matches_reference(kind):
    """One block of each kind, 4 decode steps from the same non-trivial
    state (a 70-token prefill's in the reference, carried across by
    ``caches_from_numpy``), outputs and states against the reference."""
    arch = {"global_attn": "granite-3-2b", "local_attn": "gemma2-2b",
            "mlstm": "xlstm-350m", "slstm": "xlstm-350m",
            "rglru": "recurrentgemma-2b"}[kind]
    cfg, jcfg = _configs(arch, num_layers=1, layer_pattern=(kind,))
    rng = np.random.default_rng(7)
    p = jax.tree_util.tree_map(np.asarray, jax_blocks.init_block(
        jax.random.PRNGKey(2), jcfg, kind))
    x = rng.standard_normal((2, 70, cfg.d_model)).astype(np.float32)
    _, state, _ = jax_blocks.apply_block(p, jnp.asarray(x), jcfg, kind,
                                         mode="prefill")
    if kind == "global_attn":
        state = jax_serve.pad_caches(jcfg, [state], 74)[0]
    mine = caches_from_numpy(cfg, [jax.tree_util.tree_map(np.asarray,
                                                          state)])[0]
    tp = params_from_numpy(p)
    for i in range(4):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, state, _ = jax_blocks.apply_block(p, jnp.asarray(xt), jcfg,
                                                kind, mode="decode",
                                                cache=state)
        with torch.inference_mode():
            got, mine, _ = blocks.apply_block(tp, torch.from_numpy(xt), cfg,
                                              kind, mode="decode",
                                              cache=mine)
        _close(cfg, got.numpy(), np.asarray(want), f"{kind} step {i}")
        _assert_caches(cfg, [mine], [state], f"{kind} step {i}")


def test_caches_from_numpy_copies_and_checks():
    cfg, jcfg = _configs("recurrentgemma-2b")
    caches = jax.tree_util.tree_map(np.asarray,
                                    jax_model.init_caches(jcfg, 2, 80))
    mine = caches_from_numpy(cfg, caches)
    assert [type(c) for c in mine] == [type(c) for c in
                                       model.init_caches(cfg, 2, 80)]
    mine[2].k.fill_(1.0)                         # the port writes in place
    assert not np.asarray(caches[2].k).any()
    assert mine[2].pos.dtype == torch.int32 and mine[2].pos.ndim == 0
    with pytest.raises(ValueError, match="caches for"):
        caches_from_numpy(cfg, caches[:2])
    with pytest.raises(ValueError, match="fields"):
        caches_from_numpy(cfg, [caches[0][:1]] + list(caches[1:]))


# ---------------------------------------------------------------------------
# the rotating window, the three local-cache prefills, the global clamp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "gemma2-2b"])
@pytest.mark.parametrize("prompt", [70, 64, 40])
def test_local_cache_prefill_and_rotation_match_reference(arch, prompt):
    """A local cache from a prefill of P past (rolled), at (as is) and
    under (padded) the reduced window of 64, then decode to T = 100: the
    window rotates (P = 40 crosses it at step 24)."""
    cfg, jcfg = _configs(arch)
    assert cfg.sliding_window == 64
    params = _params(jcfg)
    prompts = _prompts(cfg, 2, prompt)
    steps = 100 - prompt
    want_logits, want_snaps, fed = _reference_run(jcfg, params, prompts,
                                                  steps, max_len=100)
    mine = _port_run(cfg, params_from_numpy(params), prompts, fed,
                     max_len=100)
    for kind, c in zip(cfg.layer_kinds(), mine[1][0]):
        if kind == "local_attn":
            assert c[0].shape[1] == 64         # window-sized after prefill
    _assert_runs(cfg, mine, (want_logits, want_snaps), f"{arch} P={prompt}")


def test_global_cache_clamps_past_its_end_as_the_reference():
    """A global cache of S = 8 slots decoded at pos = S .. S + 3: the
    reference's ``dynamic_update_slice`` clamps its start, so each step
    overwrites slot S - 1; the port does the same on the device."""
    cfg, jcfg = _configs("granite-3-2b")
    params = _params(jcfg)
    prompts = _prompts(cfg, 2, 8)
    want_logits, want_snaps, fed = _reference_run(jcfg, params, prompts, 4,
                                                  max_len=8)
    assert [s[0][2] for s in want_snaps] == [8, 9, 10, 11, 12]
    mine = _port_run(cfg, params_from_numpy(params), prompts, fed,
                     max_len=8)
    assert [int(s[0][2]) for s in mine[1]] == [8, 9, 10, 11, 12]
    assert mine[1][-1][0][0].shape[1] == 8
    _assert_runs(cfg, mine, (want_logits, want_snaps), "clamp")


def test_pad_caches_grows_global_caches_only():
    cfg, _ = _configs("gemma2-2b")              # local, global
    caches = model.init_caches(cfg, 2, 40)
    assert [c.k.shape[1] for c in caches] == [40, 40]
    grown = serve.pad_caches(cfg, caches, 90)
    assert [c.k.shape[1] for c in grown] == [40, 90]
    assert grown[0] is caches[0]
    assert serve.pad_caches(cfg, grown, 50)[1] is grown[1]


# ---------------------------------------------------------------------------
# the port's own decode against its full forward; batched_generate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma2-2b", "gemma3-4b",
                                  "xlstm-350m", "recurrentgemma-2b",
                                  "granite-moe-1b-a400m"])
def test_prefill_decode_matches_full_forward(arch):
    """The reference's claim for the port: decode logits at every position
    equal one full forward's (P = 40, T = 100: the local windows rotate);
    MoE at a capacity factor no token can exceed (decode sees B tokens a
    step, the forward B·T)."""
    changes = {"capacity_factor": 100.0} if "moe" in arch else {}
    cfg, _ = _configs(arch, **changes)
    params = model.init_params(cfg, torch.Generator().manual_seed(1))
    toks = torch.from_numpy(_prompts(cfg, 2, 100))
    p = 40
    with torch.inference_mode():
        full, _, _ = model.forward(cfg, params, {"tokens": toks})
        logits, caches = serve.prefill(cfg, params, {"tokens": toks[:, :p]},
                                       max_len=100)
        errs = [(logits[:, -1] - full[:, p - 1]).abs().max().item()]
        step = serve.build_decode_step(cfg)
        for i in range(p, 100):
            logits, caches = step(params, toks[:, i:i + 1], caches)
            errs.append((logits[:, 0] - full[:, i]).abs().max().item())
    assert max(errs) < FULL_FORWARD_ATOL, (arch, max(errs))


def test_batched_generate_greedy_matches_reference():
    cfg, jcfg = _configs("recurrentgemma-2b")
    params = _params(jcfg)
    prompts = _prompts(cfg, 2, 70)
    want = jax_serve.batched_generate(jcfg, params, jnp.asarray(prompts),
                                      max_new_tokens=8)
    got = serve.batched_generate(cfg, params_from_numpy(params),
                                 torch.from_numpy(prompts),
                                 max_new_tokens=8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_hook_sees_every_step_and_sampling_is_seeded():
    cfg, _ = _configs("granite-3-2b")
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = torch.from_numpy(_prompts(cfg, 2, 12))
    seen = []
    out = serve.batched_generate(
        cfg, params, prompts, max_new_tokens=5,
        on_step=lambda i, logits, caches: seen.append(
            (i, tuple(logits.shape), int(caches[0].pos))))
    assert seen == [(i, (2, 1, cfg.vocab_size), 12 + i) for i in range(6)]
    runs = [serve.batched_generate(
        cfg, params, prompts, max_new_tokens=5, greedy=False,
        generator=torch.Generator().manual_seed(2)) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0][:, 0], out[:, 0])     # the prefill's argmax


def test_sample_is_gumbel_max():
    """``sample`` takes the argmax of logits + G, G = -log(-log U), U from
    the generator: the method of ``jax.random.categorical``; over many
    draws its frequencies follow the softmax."""
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0]]).repeat(20000, 1)
    gen = torch.Generator().manual_seed(0)
    got = serve.sample(logits, gen)
    u = torch.rand(logits.shape, generator=torch.Generator().manual_seed(0))
    want = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
    assert torch.equal(got, want)
    freq = torch.bincount(got, minlength=4).float() / got.numel()
    np.testing.assert_allclose(freq.numpy(),
                               torch.softmax(logits[0], -1).numpy(),
                               atol=0.015)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-3-2b", "recurrentgemma-2b",
                                  "xlstm-350m"])
def test_launcher_serves_on_the_cpu(arch, capsys):
    run = launcher.main(["--arch", arch, "--reduced", "--requests", "2",
                         "--prompt-len", "12", "--tokens", "4", "--greedy",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert "tok/s" in out and "first request continuation" in out
    assert tuple(run["tokens"].shape) == (2, 4)
    assert run["tokens_per_s"] > 0 and run["prefill_ms"] > 0
    want = model.init_caches(run["cfg"], 2, 16)
    assert run["cache_bytes"] == sum(x.numel() * x.element_size()
                                     for x in tree.leaves(want))
    # the launcher's greedy tokens are batched_generate's
    again = serve.batched_generate(run["cfg"], run["params"],
                                   run["prompts"], max_new_tokens=4)
    assert torch.equal(again, run["tokens"])


def test_launcher_sampling_is_seeded():
    argv = ["--arch", "gemma2-2b", "--reduced", "--requests", "2",
            "--prompt-len", "8", "--tokens", "6", "--device", "cpu"]
    a, b = launcher.main(argv), launcher.main(argv)
    assert torch.equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("arch,match", [("hubert-xlarge", "encoder-only"),
                                        ("llava-next-34b", "text archs")])
def test_launcher_exits_for_non_text_archs(arch, match):
    with pytest.raises(SystemExit, match=match):
        launcher.main(["--arch", arch, "--reduced", "--device", "cpu"])


def test_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--arch", "granite-3-2b", "--reduced"])


def test_decode_keeps_pos_on_the_device_and_writes_in_place():
    cfg, _ = _configs("granite-3-2b")
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    caches = model.init_caches(cfg, 2, 10)
    k0 = caches[0].k
    with torch.inference_mode():
        _, new = model.decode_step(cfg, params,
                                   torch.zeros(2, 1, dtype=torch.int32),
                                   caches)
    assert isinstance(new[0], KVCache) and new[0].k is k0
    assert k0[:, 0].abs().sum() > 0 and not k0[:, 1:].any()
    assert torch.is_tensor(new[0].pos) and int(new[0].pos) == 1
