"""The port's model, data, optimizers and planning against the reference.

The same numpy-made weights and batches go through ``repro`` (JAX, CPU)
and ``repro_torch`` (CPU, plain versions).  Tolerances, each with its
reason: losses rtol 2e-6 and gradients atol 2e-6 — float32 sums taken in
another order by XLA and by PyTorch; everything that is arithmetic on
integers or copies (byte counts, profiles, plans, batches) is exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jax_core
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticText as JaxSyntheticText
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models.profiles import layer_profiles as jax_layer_profiles
from repro.optim import adamw as jax_adamw
from repro.optim import sgd as jax_sgd
from repro_torch import core
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.data import SyntheticText
from repro_torch.interop import params_from_numpy
from repro_torch.models import attention, layers, model
from repro_torch.models.profiles import layer_profiles
from repro_torch.optim import adamw, sgd

LOSS_RTOL = 2e-6
GRAD_ATOL = 2e-6


def _configs(name, **changes):
    """The same ArchConfig in both packages (reduced, then ``changes``)."""
    mine = dataclasses.replace(get_config(name).reduced(), **changes)
    theirs = dataclasses.replace(jax_get_config(name).reduced(), **changes)
    return mine, theirs


MODEL_CASES = {
    "granite": ("granite-3-2b", {}, 16),
    "gemma2-window-softcap-geglu": ("gemma2-2b", {}, 80),
    "gqa-nrep2": ("granite-3-2b", {"num_kv_heads": 2}, 24),
    # (rglru, rglru, local_attn): the reduced window of 64 bites at seq 80
    "recurrentgemma-window": ("recurrentgemma-2b", {"num_layers": 3}, 80),
    # MoE: 8 experts, top-2 at capacity factor 0.5 drop tokens; grok-1's
    # gated GELU with attention and final softcaps
    "granite-moe-dropping": ("granite-moe-1b-a400m",
                             {"num_experts": 8, "top_k": 2,
                              "capacity_factor": 0.5}, 16),
    "grok-1-moe": ("grok-1-314b", {}, 16),
}


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


class TestLayers:
    def test_pointwise_layers_match(self):
        rng = np.random.default_rng(0)
        x, s = _rand(rng, (2, 5, 32)), _rand(rng, (32,), 0.1)
        w = _rand(rng, (32, 48))
        np.testing.assert_allclose(
            layers.rms_norm(_t(x), _t(s)).numpy(),
            np.asarray(jax_layers.rms_norm(x, s)), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(layers.dense(_t(x), _t(w)).numpy(),
                                   np.asarray(jax_layers.dense(x, w)),
                                   rtol=1e-5, atol=1e-5)
        for cap in (0.0, 5.0):
            np.testing.assert_allclose(
                layers.softcap(_t(x) * 10, cap).numpy(),
                np.asarray(jax_layers.softcap(x * 10, cap)), rtol=1e-6,
                atol=1e-6)
        for act in ("silu", "gelu", "geglu", "relu"):
            np.testing.assert_allclose(
                layers.activation_fn(act)(_t(x)).numpy(),
                np.asarray(jax_layers.activation_fn(act)(x)), rtol=1e-6,
                atol=1e-6)

    def test_mlp_rope_embed_head_match(self):
        rng = np.random.default_rng(1)
        x = _rand(rng, (2, 6, 32))
        mlp = {"up": _rand(rng, (32, 64)), "down": _rand(rng, (64, 32)),
               "gate": _rand(rng, (32, 64))}
        np.testing.assert_allclose(
            layers.apply_mlp(params_from_numpy(mlp), _t(x), "silu").numpy(),
            np.asarray(jax_layers.apply_mlp(mlp, x, "silu")), rtol=1e-5,
            atol=1e-5)
        qh = _rand(rng, (2, 6, 4, 16))
        pos = np.arange(6)
        np.testing.assert_allclose(
            layers.apply_rope(_t(qh), _t(pos), 10000.0).numpy(),
            np.asarray(jax_layers.apply_rope(qh, pos, 10000.0)), rtol=1e-6,
            atol=1e-6)
        table = _rand(rng, (50, 32), 0.02)
        toks = rng.integers(0, 50, (2, 6))
        np.testing.assert_allclose(
            layers.embed(_t(toks), _t(table)).numpy(),
            np.asarray(jax_layers.embed(toks, table)), rtol=1e-6)
        np.testing.assert_allclose(
            layers.logits_from_embedding(_t(x), _t(table), 30.0).numpy(),
            np.asarray(jax_layers.logits_from_embedding(x, table, 30.0)),
            rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("causal,window,cap",
                             [(True, 0, 0.0), (True, 300, 20.0),
                              (False, 0, 0.0)])
    def test_sdpa_chunked_above_full_attn_max(self, causal, window, cap):
        """The CPU's blockwise path (T > FULL_ATTN_MAX) at tiny width."""
        rng = np.random.default_rng(2)
        t = 2048
        assert t > attention.FULL_ATTN_MAX
        q = _rand(rng, (1, t, 2, 8))
        k, v = _rand(rng, (1, t, 1, 8)), _rand(rng, (1, t, 1, 8))
        got = attention._sdpa_chunked(_t(q), _t(k), _t(v), n_rep=2, cap=cap,
                                      causal=causal, window=window)
        want = jax_attention._sdpa_chunked(q, k, v, n_rep=2, cap=cap,
                                           causal=causal, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)

    @pytest.mark.parametrize("local", [False, True])
    def test_attention_decode_matches_reference(self, local):
        """Decode attention, 6 steps from a 70-token prefill's cache: the
        reduced window of 64 rotates (local), the global cache grows into
        its padding; outputs atol 2e-6 and the cached keys and values (up
        to ~5 in magnitude) 5e-6: float32 sums in another order."""
        cfg, jcfg = _configs("gemma2-2b")
        rng = np.random.default_rng(4)
        p = jax.tree_util.tree_map(np.asarray, jax_attention.init_attn_params(
            jax.random.PRNGKey(3), jcfg))
        x = _rand(rng, (2, 70, cfg.d_model))
        _, cache = jax_attention.attention(p, x, jcfg, local=local,
                                           mode="prefill")
        if not local:
            cache = jax_attention.KVCache(
                k=jnp.pad(cache.k, ((0, 0), (0, 6), (0, 0), (0, 0))),
                v=jnp.pad(cache.v, ((0, 0), (0, 6), (0, 0), (0, 0))),
                pos=cache.pos)
        mine = attention.KVCache(*(_t(np.array(c)) for c in cache))
        for _ in range(6):
            xt = _rand(rng, (2, 1, cfg.d_model))
            want, cache = jax_attention.attention(p, xt, jcfg, local=local,
                                                  mode="decode", cache=cache)
            got, mine = attention.attention(params_from_numpy(p), _t(xt),
                                            cfg, local=local, mode="decode",
                                            cache=mine)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=2e-6)
            for a, b in zip(mine, cache):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=5e-6)
        assert int(mine.pos) == 76 and mine.k.shape[1] == (64 if local
                                                          else 76)

    def test_unported_families_raise(self):
        """Every family builds and decodes, except hubert (encoder-only),
        which has no decode mode, as in the reference."""
        gen = torch.Generator().manual_seed(0)
        hubert = get_config("hubert-xlarge").reduced()
        p = model.init_params(hubert, gen)
        with pytest.raises(ValueError, match="encoder-only"):
            model.forward(hubert, p, {"token": torch.zeros(1, 1).long()},
                          mode="decode")


class TestModel:
    @pytest.mark.parametrize("case", sorted(MODEL_CASES))
    def test_train_loss_and_grads_match_reference(self, case):
        name, changes, seq = MODEL_CASES[case]
        cfg, jcfg = _configs(name, **changes)
        params = jax.tree_util.tree_map(np.asarray, jax_model.init_params(
            jcfg, jax.random.PRNGKey(1)))
        data = JaxSyntheticText(jcfg.vocab_size, seq, 2, seed=5).batch(0)
        jbatch = {k: np.asarray(v) for k, v in data.items()}
        want, jgrads = jax.jit(jax.value_and_grad(
            lambda p: jax_model.train_loss(jcfg, p, jbatch)))(params)
        tparams = params_from_numpy(params, requires_grad=True)
        batch = SyntheticText(cfg.vocab_size, seq, 2, seed=5).batch(0)
        loss = model.train_loss(cfg, tparams, batch)
        grads = torch.autograd.grad(loss, tree.leaves(tparams))
        np.testing.assert_allclose(loss.item(), float(want),
                                   rtol=LOSS_RTOL)
        for (path, g), w in zip(
                tree.leaves_with_paths(tree.unflatten(
                    tree.structure(tparams), list(grads))),
                jax.tree_util.tree_leaves(jgrads)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=GRAD_ATOL, err_msg=str(path))

    def test_remat_changes_nothing(self):
        cfg, _ = _configs("granite-3-2b")
        p = model.init_params(cfg, torch.Generator().manual_seed(0))
        p = tree.tree_map(lambda x: x.requires_grad_(), p)
        batch = SyntheticText(cfg.vocab_size, 16, 2).batch(0)
        a = model.train_loss(cfg, p, batch)
        b = model.train_loss(cfg, p, batch, remat=True)
        ga = torch.autograd.grad(a, tree.leaves(p))
        gb = torch.autograd.grad(b, tree.leaves(p))
        assert torch.equal(a, b)
        assert all(torch.equal(x, y) for x, y in zip(ga, gb))

    @pytest.mark.parametrize("name", ["granite-3-2b", "gemma2-2b",
                                      "gemma-7b", "recurrentgemma-2b",
                                      "granite-moe-1b-a400m", "grok-1-314b",
                                      "xlstm-350m", "hubert-xlarge",
                                      "llava-next-34b"])
    @pytest.mark.parametrize("reduced", [True, False])
    def test_param_layout_bytes_and_profiles_exact(self, name, reduced):
        cfg, jcfg = get_config(name), jax_get_config(name)
        if reduced:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        assert model.sched_layer_bytes(cfg) == \
            jax_model.sched_layer_bytes(jcfg)
        assert model.param_count(cfg) == jax_model.param_count(jcfg)
        shape = InputShape("runtime", 1024, 2, "train")
        mine = [dataclasses.asdict(p) for p in layer_profiles(cfg, shape)]
        theirs = [dataclasses.asdict(p) for p in jax_layer_profiles(
            jcfg, jax_core_shape(shape))]
        assert mine == theirs
        if reduced:
            shapes = jax.eval_shape(lambda k: jax_model.init_params(jcfg, k),
                                    jax.random.PRNGKey(0))
            want = [(tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in p), tuple(x.shape))
                    for p, x in jax.tree_util.tree_flatten_with_path(
                        shapes)[0]]
            got = [(tuple(str(k) for k in p), tuple(x.shape))
                   for p, x in tree.leaves_with_paths(
                       model.param_shapes(cfg))]
            assert got == want


def jax_core_shape(shape):
    from repro.configs.base import InputShape as JaxInputShape
    return JaxInputShape(shape.name, shape.seq_len, shape.global_batch,
                         shape.mode)


class TestDataAndOptim:
    @pytest.mark.parametrize("step", [0, 7])
    def test_synthetic_text_values_equal(self, step):
        mine = SyntheticText(512, 16, 3, seed=2).batch(step)
        theirs = JaxSyntheticText(512, 16, 3, seed=2).batch(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(mine[k].numpy(),
                                          np.asarray(theirs[k]))

    @pytest.mark.parametrize("which", ["sgd", "sgd-momentum-wd", "adamw",
                                       "adamw-wd"])
    def test_optimizers_match_reference_over_flat_buffers(self, which):
        rng = np.random.default_rng(3)
        sizes = (7, 130, 1)
        params = [_rand(rng, (n,)) for n in sizes]
        grads = [[_rand(rng, (n,)) for n in sizes] for _ in range(3)]
        kw = {"sgd": ("sgd", {}), "sgd-momentum-wd":
              ("sgd", {"momentum": 0.9, "weight_decay": 0.01}),
              "adamw": ("adamw", {}), "adamw-wd":
              ("adamw", {"weight_decay": 0.1})}[which]
        fn, args = kw
        mine = {"sgd": sgd, "adamw": adamw}[fn](0.01, **args)
        theirs = {"sgd": jax_sgd, "adamw": jax_adamw}[fn](0.01, **args)
        tp = [torch.from_numpy(p.copy()) for p in params]
        ts = mine.init(tp)
        jp = [jnp.asarray(p) for p in params]
        js = theirs.init(jp)
        for g in grads:
            out, ts = mine.update([torch.from_numpy(x) for x in g], ts, tp)
            assert out is tp                        # updated in place
            jp, js = theirs.update([jnp.asarray(x) for x in g], js, jp)
        assert int(ts.step) == int(js.step) == 3
        for mine_m, their_m in ((ts.mu, js.mu), (ts.nu, js.nu)):
            for a, b in zip(mine_m or (), their_m or ()):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # XLA's CPU sqrt and division are not correctly rounded, torch's
        # are: AdamW's parameters may differ by an ulp (ROADMAP queue 3)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


class TestPlanning:
    @pytest.mark.parametrize("strategy", ["sequential", "lbl", "ibatch",
                                          "dynacomm"])
    @pytest.mark.parametrize("name,reduced,seq", [
        ("granite-3-2b", True, 16), ("granite-3-2b", False, 1024),
        ("gemma2-2b", True, 80), ("recurrentgemma-2b", True, 80),
        ("recurrentgemma-2b", False, 1024)])
    def test_plans_equal_reference(self, strategy, name, reduced, seq):
        cfg, jcfg = get_config(name), jax_get_config(name)
        if reduced:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        shape = InputShape("runtime", seq, 2, "train")
        costs = core.costs_from_profiles(layer_profiles(cfg, shape),
                                         net=core.EdgeNetworkModel(),
                                         compute_flops_per_s=1e10)
        jcosts = jax_core.costs_from_profiles(
            jax_layer_profiles(jcfg, jax_core_shape(shape)),
            net=jax_core.EdgeNetworkModel(), compute_flops_per_s=1e10)
        mine = core.DynaCommScheduler(strategy=strategy) \
            .decision_for_iteration(costs)
        theirs = jax_core.DynaCommScheduler(strategy=strategy) \
            .decision_for_iteration(jcosts)
        assert mine == theirs
        n = model.num_sched_layers(cfg)
        plan = core.plan_from_decision(*mine, n)
        jplan = jax_core.plan_from_decision(*theirs, n)
        assert (plan.forward, plan.backward) == (jplan.forward,
                                                 jplan.backward)
        assert core.simulate_iteration(costs, *mine).total == \
            jax_core.simulate_iteration(jcosts, *theirs).total
