"""Training-step builder of the ``local`` runtime: whole-model autograd.

``build_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, loss)`` over a parameter tree whose leaves require
grad; the optimizer updates the leaves in place.  Supports activation
rematerialization (per-block checkpointing) and gradient accumulation
over equal micro-batches.
"""

from __future__ import annotations

from typing import Callable

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
