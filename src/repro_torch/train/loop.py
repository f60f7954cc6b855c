"""The ``local`` runtime's training step (whole-model autograd) and a
small host-side loop over it.

``build_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, loss)`` over a parameter tree whose leaves require
grad; the optimizer updates the leaves in place.  Supports activation
rematerialization (per-block checkpointing) and gradient accumulation
over equal micro-batches.  :class:`TrainLoop` drives it: data → step →
log line → checkpoint, as the reference's ``TrainLoop``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as model_lib
from repro_torch.optim import Optimizer


def build_train_step(cfg: ArchConfig, optimizer: Optimizer, *,
                     accum_steps: int = 1, remat: bool = True,
                     aux_weight: float = 0.01) -> Callable:
    def loss_and_grads(params, batch):
        leaves = tree.leaves(params)
        with torch.enable_grad():
            loss = model_lib.train_loss(cfg, params, batch,
                                        aux_weight=aux_weight, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), list(grads)

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            loss, grads = loss_and_grads(params, batch)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % accum_steps:
                raise ValueError(f"batch {n} is not divisible by "
                                 f"accum_steps={accum_steps}")
            w = n // accum_steps
            loss, grads = 0.0, None
            for i in range(accum_steps):
                micro = {k: x[i * w:(i + 1) * w] for k, x in batch.items()}
                l_i, g_i = loss_and_grads(params, micro)
                loss = loss + l_i
                grads = g_i if grads is None else [
                    a + b for a, b in zip(grads, g_i)]
            grads = [g / accum_steps for g in grads]
            loss = loss / accum_steps
        optimizer.update(grads, opt_state, tree.leaves(params))
        return params, opt_state, loss

    return train_step


@dataclasses.dataclass
class TrainLoop:
    """Host loop: data pipeline → step → metrics / checkpoints."""

    cfg: ArchConfig
    optimizer: Optimizer
    accum_steps: int = 1
    remat: bool = False
    log_every: int = 10
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0

    def run(self, gen: torch.Generator,
            batches: Iterable[Dict[str, torch.Tensor]], num_steps: int,
            params: Any = None):
        """Train for ``num_steps`` batches; returns ``(params, opt_state,
        losses)``.

        Without ``params`` the weights are drawn from ``gen`` on its
        device (torch cannot replay the reference's ``jax.random`` key).
        Given ``params`` are trained in place on their device (their
        leaves are set to require grad).  Batches are moved to that
        device.  Every ``checkpoint_every`` steps ``{"params", "opt"}`` is
        saved with the moments shaped like the parameters: the reference's
        checkpoint keys."""
        from repro_torch.checkpoint import save_checkpoint
        if params is None:
            params = model_lib.init_params(self.cfg, gen, torch.float32,
                                           gen.device)
        leaves = tree.leaves(params)
        for x in leaves:
            x.requires_grad_()
        device = leaves[0].device
        opt_state = self.optimizer.init(leaves)
        step_fn = build_train_step(self.cfg, self.optimizer,
                                   accum_steps=self.accum_steps,
                                   remat=self.remat)
        losses = []
        t0 = time.perf_counter()
        for i, batch in enumerate(batches):
            if i >= num_steps:
                break
            batch = {k: v.to(device) for k, v in batch.items()}
            params, opt_state, loss = step_fn(params, opt_state, batch)
            losses.append(float(loss))
            if self.log_every and (i + 1) % self.log_every == 0:
                dt = time.perf_counter() - t0
                print(f"step {i + 1:5d}  loss {losses[-1]:.4f}  "
                      f"({dt / (i + 1):.3f}s/step)")
            if (self.checkpoint_path and self.checkpoint_every
                    and (i + 1) % self.checkpoint_every == 0):
                save_checkpoint(self.checkpoint_path,
                                {"params": params,
                                 "opt": opt_tree(opt_state, params)},
                                step=i + 1)
        return params, opt_state, losses


def opt_tree(opt_state, params):
    """``opt_state`` with its moment lists shaped like ``params`` (the
    reference's ``OptState`` of trees, as checkpoints store it)."""
    struct = tree.structure(params)
    shaped = (lambda bufs: None if bufs is None
              else tree.unflatten(struct, list(bufs)))
    return opt_state._replace(mu=shaped(opt_state.mu),
                              nu=shaped(opt_state.nu))
