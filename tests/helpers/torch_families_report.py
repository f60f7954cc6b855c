"""Print how far the port's xLSTM and frontend paths sit from the reference
on the CPU: the numbers behind the tolerances of
``tests/test_torch_xlstm.py`` and ``tests/test_torch_frontend.py``.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/helpers/torch_families_report.py

1. The sLSTM block (reduced width, T = 40 and 320): the output and the
   prefill state against the reference's, through ``apply_slstm`` (the
   four input products taken for all T before the loop) and through a
   loop of ``_slstm_step`` (the reference's order, the products a step).
2. The mLSTM's parallel form (T = 128): the output's gap to the reference
   and each package's gap to a float64 evaluation.
3. Reduced xlstm-350m at 8 layers, T = 48: ``train_loss`` and the worst
   gradient leaf against the reference, and each package's worst leaf
   against the port in float64.
4. The ZeRO step at 8 layers: 2 SGD steps and 2 AdamW steps from the
   reference's initial state, the largest relative loss gap of each, and
   the worst gradient flat.
5. hubert-xlarge and llava-next-34b (reduced): ``train_loss`` and the worst
   gradient leaf, the ZeRO step and the pipeline (S = 2, M = 2).

Every gap of a tensor is over its own largest magnitude
(``chip_smoke.leaf_gap``).
"""

import dataclasses
import importlib.util
import os
import sys

import jax
import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..", "..")
sys.path.insert(0, HERE)
import torch_trainer_parity as parity  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)


def _gap(a, b) -> float:
    return SMOKE.leaf_gap(torch.as_tensor(np.array(a, np.float64)),
                          torch.as_tensor(np.array(b, np.float64)))


def _configs(name, **changes):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    return (dataclasses.replace(get_config(name).reduced(), **changes),
            dataclasses.replace(jget(name).reduced(), **changes))


def slstm_hoist() -> None:
    from repro.models import ssm as jssm
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import ssm
    cfg, jcfg = _configs("xlstm-350m", num_layers=8)
    params = jax.tree_util.tree_map(np.asarray, jssm.init_slstm_params(
        jax.random.PRNGKey(5), jcfg))
    p = params_from_numpy(params)
    for t in (40, 320):
        x = np.random.default_rng(6).standard_normal(
            (2, t, cfg.d_model)).astype(np.float32)
        want, wstate = jssm.apply_slstm(params, x, jcfg, mode="prefill")
        got, state = ssm.apply_slstm(p, torch.from_numpy(x), cfg,
                                     mode="prefill")
        s = ssm.init_slstm_state(cfg, 2)
        hs = []
        for i in range(t):
            s = ssm._slstm_step(p, torch.from_numpy(x[:, i]), s)
            hs.append(s.h)
        stepwise = torch.matmul(torch.stack(hs, 1), p["down"])
        print(f"sLSTM T = {t}: output gap hoisted {_gap(got, want):.3g}, "
              f"stepwise {_gap(stepwise, want):.3g}; state c gap hoisted "
              f"{_gap(state.c, wstate.c):.3g}, stepwise "
              f"{_gap(s.c, wstate.c):.3g}; hoisted vs stepwise "
              f"{_gap(got, stepwise):.3g}")


def mlstm_parallel() -> None:
    from repro.models import ssm as jssm
    from repro_torch.models import ssm
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 2, 128, 16)).astype(np.float32)
               for _ in range(3))
    ig = rng.standard_normal((2, 2, 128)).astype(np.float32)
    fg = (rng.standard_normal((2, 2, 128)) + 2.0).astype(np.float32)
    want = np.asarray(jssm._mlstm_parallel(q, k, v, ig, fg))
    got = ssm._mlstm_parallel(*map(torch.from_numpy, (q, k, v, ig, fg)))
    exact = parity.in_float64(lambda: ssm._mlstm_parallel(*[
        torch.from_numpy(x).double() for x in (q, k, v, ig, fg)]))
    print(f"mLSTM parallel T = 128: port vs reference {_gap(got, want):.3g} "
          f"(abs {np.abs(got.numpy() - want).max():.3g} on values up to "
          f"{np.abs(want).max():.3g}); port vs float64 "
          f"{_gap(got, exact):.3g}, reference vs float64 "
          f"{_gap(want, exact):.3g}")


def _model_grads(name, batch_of, **changes):
    from repro.models import model as jmodel
    from repro_torch import tree
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import model
    cfg, jcfg = _configs(name, **changes)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init_params(
        jcfg, jax.random.PRNGKey(1)))
    ref, mine = batch_of(cfg, jcfg)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.train_loss(jcfg, p, ref)))(params)

    def port(dtype):
        tp = tree.tree_map(lambda x: x.to(dtype).requires_grad_(),
                           params_from_numpy(params))
        loss = model.train_loss(cfg, tp, mine)
        return loss.item(), torch.autograd.grad(loss, tree.leaves(tp))
    loss, grads = port(torch.float32)
    loss64, grads64 = parity.in_float64(lambda: port(torch.float64))
    ref_grads = jax.tree_util.tree_leaves(jgrads)
    mine_ref = max(_gap(g, w) for g, w in zip(grads, ref_grads))
    mine_64 = max(_gap(g, e) for g, e in zip(grads, grads64))
    ref_64 = max(_gap(w, e) for w, e in zip(ref_grads, grads64))
    print(f"{name} {changes or ''} train_loss: rel gap "
          f"{abs(loss - float(want)) / abs(float(want)):.3g} (float64 "
          f"{abs(loss - loss64) / abs(loss64):.3g}); worst gradient leaf "
          f"port vs reference {mine_ref:.3g}, port vs float64 "
          f"{mine_64:.3g}, reference vs float64 {ref_64:.3g}")


def _token_batch(cfg, jcfg, t=48):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, size=(2, t)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    return ({"tokens": toks, "labels": labels},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()})


def _frontend_batch(cfg, jcfg, b=2):
    from repro.configs.base import InputShape
    from repro.data.pipeline import batch_for
    ref = {k: np.asarray(v) for k, v in batch_for(
        jcfg, InputShape("t", 40, b, "train"), step=0, seed=3).items()}
    return ref, {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind ==
                                     "i" else v.copy())
                 for k, v in ref.items()}


def trainers() -> None:
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw
    cfg, jcfg = _configs("xlstm-350m", num_layers=8)
    ref, mine = _token_batch(cfg, jcfg)
    plan = (((0, 1, 2, 3, 4), (5, 6, 7, 8, 9)),
            ((9, 8), (7, 6, 5, 4, 3, 2, 1, 0)))
    out = parity.zero_runs(cfg, jcfg, ref, mine, plan)
    loss, grads = parity.gaps(out)
    print(f"xlstm 8 layers zero: SGD losses rel gap {loss:.3g}, worst "
          f"gradient flat {max(grads):.3g}")
    real = (parity.jax_sgd, parity.sgd)
    try:
        parity.jax_sgd = lambda lr: jadamw(1e-3)
        parity.sgd = lambda lr: adamw(1e-3)
        out = parity.zero_runs(cfg, jcfg, ref, mine, plan)
    finally:
        parity.jax_sgd, parity.sgd = real
    gap = max(abs(a - b) / abs(b) for a, b in zip(out["sgd"][0],
                                                  out["ref", "sgd"][0]))
    print(f"xlstm 8 layers zero: AdamW (lr 1e-3) losses {out['sgd'][0]} vs "
          f"{out['ref', 'sgd'][0]}: rel gap {gap:.3g}")
    for name in ("hubert-xlarge", "llava-next-34b"):
        cfg, jcfg = _configs(name)
        ref, mine = _frontend_batch(cfg, jcfg)
        loss, grads = parity.gaps(parity.zero_runs(
            cfg, jcfg, ref, mine, (((0, 1), (2, 3)), ((3,), (2, 1, 0)))))
        ref4, mine4 = _frontend_batch(cfg, jcfg, b=4)
        ploss, pgrads = parity.gaps(parity.pipeline_runs(
            cfg, jcfg, ref4, mine4, stages=2, microbatches=2))
        print(f"{name} zero: losses {loss:.3g}, worst gradient flat "
              f"{max(grads):.3g}; pipeline S = 2, M = 2: losses {ploss:.3g},"
              f" worst flat {max(pgrads):.3g}")


if __name__ == "__main__":
    slstm_hoist()
    mlstm_parallel()
    _model_grads("xlstm-350m", _token_batch, num_layers=8)
    _model_grads("hubert-xlarge", _frontend_batch)
    _model_grads("llava-next-34b", _frontend_batch)
    trainers()
