"""The port's ZeRO and pipeline trainers against the reference's on one CPU
device, from the reference's initial state (imported by
``tests/test_torch_xlstm.py``, ``tests/test_torch_frontend.py`` and
``tests/helpers/torch_families_report.py``).

Each run gives a short SGD loss trajectory and one step's gradients: a
recording optimizer whose update writes the gradients into the parameter
buffers, so that after one step the state's flats are the step's
gradients, flat by flat.  ``in_float64`` runs the port in float64 for a
witness of roundoff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import pipeline as jp
from repro.core import BucketPlan as JaxBucketPlan
from repro.dist.zero import ZeroTrainer as JaxZeroTrainer
from repro.optim import sgd as jax_sgd
from repro.optim.optimizers import OptState as JaxOptState
from repro.optim.optimizers import Optimizer as JaxOptimizer
from repro_torch import pipeline as tp
from repro_torch.core import BucketPlan
from repro_torch.dist.zero import ZeroTrainer
from repro_torch.interop import zero_state_from_numpy
from repro_torch.optim import sgd
from repro_torch.optim.optimizers import OptState, Optimizer

LR = 1e-2        # SGD: a step that lowers the reduced models' losses


def in_float64(fn):
    """``fn()`` with the port's float32 casts kept in float64:
    ``Tensor.float`` patched to ``double`` and float32 zeros (the mLSTM's
    chunk carries) made float64."""
    real_float, real_zeros = torch.Tensor.float, torch.zeros

    def zeros(*a, **k):
        if k.get("dtype") == torch.float32:
            k["dtype"] = torch.float64
        return real_zeros(*a, **k)
    torch.Tensor.float = lambda self: self.double()
    torch.zeros = zeros
    try:
        return fn()
    finally:
        torch.Tensor.float, torch.zeros = real_float, real_zeros


def jax_grad_recorder():
    return JaxOptimizer(
        init=lambda p: JaxOptState(step=jnp.zeros((), jnp.int32), mu=None,
                                   nu=None),
        update=lambda g, s, p: (g, s))


def grad_recorder():
    def update(grads, state, params):
        for p, g in zip(params, grads):
            p.copy_(g)
        return params, state
    return Optimizer(init=lambda p: OptState(
        step=torch.zeros((), dtype=torch.int32), mu=None, nu=None),
        update=update)


def _runs(make_ref, make_port, batch, torch_batch, steps):
    """``{"sgd", "grads"}`` runs of both trainers: (losses, flats) each,
    the reference's under ``("ref", name)``; the trainers under "jtr" /
    "tr" (the last made)."""
    out = {}
    init = None
    for name, opt in (("sgd", jax_sgd(LR)), ("grads", jax_grad_recorder())):
        jtr = make_ref(opt)
        state = jtr.init_state(jax.random.PRNGKey(0))
        init = init or jax.tree_util.tree_map(np.asarray,
                                              state["flat_params"])
        losses = []
        for _ in range(steps if name == "sgd" else 1):
            state, loss = jtr.step(state, batch)
            losses.append(float(loss))
        out["ref", name] = losses, [np.asarray(f)
                                    for f in state["flat_params"]]
        out["jtr"] = jtr
    for name, opt in (("sgd", sgd(LR)), ("grads", grad_recorder())):
        tr = make_port(opt)
        state = zero_state_from_numpy(tr, init)
        losses = []
        for _ in range(steps if name == "sgd" else 1):
            state, loss = tr.step(state, torch_batch)
            losses.append(float(loss))
        out[name] = losses, [f.numpy() for f in state["flat_params"]]
        out["tr"] = tr
    return out


class _JittedZero:
    """The reference's ``ZeroTrainer`` with a jitted ``step``."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.specs = trainer.specs
        self._step = jax.jit(trainer.build_train_step())

    def init_state(self, key):
        return self.trainer.init_state(key)

    def step(self, state, batch):
        return self._step(state, batch)


def zero_runs(cfg, jcfg, batch, torch_batch, plan, steps: int = 2):
    """One-device ZeRO runs of both packages under ``plan`` ((forward,
    backward) bucket tuples)."""
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    return _runs(
        lambda opt: _JittedZero(JaxZeroTrainer(
            cfg=jcfg, mesh=mesh, plan=JaxBucketPlan(*plan), optimizer=opt)),
        lambda opt: ZeroTrainer(cfg=cfg, plan=BucketPlan(*plan),
                                optimizer=opt, device="cpu"),
        batch, torch_batch, steps)


def pipeline_runs(cfg, jcfg, batch, torch_batch, stages: int,
                  microbatches: int, steps: int = 2):
    """Pipeline runs of both packages at S stages and M micro-batches."""
    return _runs(
        lambda opt: jp.PipelineTrainer(cfg=jcfg, optimizer=opt,
                                       num_stages=stages,
                                       num_microbatches=microbatches),
        lambda opt: tp.PipelineTrainer(cfg=cfg, optimizer=opt, device="cpu",
                                       num_stages=stages,
                                       num_microbatches=microbatches),
        batch, torch_batch, steps)


def gaps(out):
    """(largest relative loss gap over both runs, each flat's gradient
    gap over its largest magnitude)."""
    loss = max(abs(a - b) / abs(b) for name in ("sgd", "grads")
               for a, b in zip(out[name][0], out["ref", name][0]))
    scale = [max(float(np.abs(w).max()), np.finfo(np.float32).tiny)
             for w in out["ref", "grads"][1]]
    grads = [float(np.abs(g - w).max()) / s for g, w, s in
             zip(out["grads"][1], out["ref", "grads"][1], scale)]
    return loss, grads
