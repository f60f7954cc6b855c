"""SGD(+momentum) and AdamW over lists of flat fp32 buffers.

``update(grads, state, params)`` walks the buffers one at a time and
updates each **in place** (parameters and moments alike), so the
temporaries of an update are the size of one buffer, never of the model:
at full width that is what lets master weights and both AdamW moments
(3 × 10 GB for granite-3-2b) share the card with the step.  It returns the
same list objects it was given.  A ``None`` gradient leaves its buffer as
it is.

AdamW updates each buffer through ``kernels/adamw``: one CUDA launch where
the buffer is on the card (a buffer the kernel cannot update in place
raises), the plain loop on the CPU and for the dry runs' fake tensors,
bitwise alike on the card.  While a profiler records, the counters
``optim.buffers`` (buffers updated with a gradient) and ``optim.fused``
(those the kernel updated) say how often the kernel engaged.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels.adamw import adamw_update

Buffers = List[torch.Tensor]


class OptState(NamedTuple):
    step: torch.Tensor           # () int32, on the buffers' device
    mu: Optional[Buffers]        # first moment / momentum
    nu: Optional[Buffers]        # second moment


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Buffers], OptState]
    update: Callable[[Buffers, OptState, Buffers], Tuple[Buffers, OptState]]


def _zeros_like_f32(params: Buffers) -> Buffers:
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params]


def _step0(params: Buffers) -> torch.Tensor:
    device = params[0].device if params else "cpu"
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(lr: float, momentum: float = 0.0,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        mu = _zeros_like_f32(params) if momentum else None
        return OptState(step=_step0(params), mu=mu, nu=None)

    @torch.no_grad()
    def update(grads, state, params):
        for i, (g, p) in enumerate(zip(grads, params)):
            if g is None:
                continue
            g = g.float()
            if weight_decay:
                g = g + weight_decay * p.float()
            if momentum:
                m = state.mu[i]
                m.mul_(momentum).add_(g)
                g = m
            p.sub_((lr * g).to(p.dtype))
        state.step.add_(1)
        return params, state

    return Optimizer(init=init, update=update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return OptState(step=_step0(params), mu=_zeros_like_f32(params),
                        nu=_zeros_like_f32(params))

    @torch.no_grad()
    def update(grads, state, params):
        state.step.add_(1)
        step = np.float32(int(state.step))
        # bias corrections in fp32, as the reference computes them
        b1c = float(np.float32(1.0) - np.float32(b1) ** step)
        b2c = float(np.float32(1.0) - np.float32(b2) ** step)
        buffers = fused = 0
        for g, p, m, v in zip(grads, params, state.mu, state.nu):
            if g is None:
                continue
            buffers += 1
            fused += adamw_update(g, p, m, v, lr=lr, b1=b1, b2=b2, eps=eps,
                                  weight_decay=weight_decay, b1c=b1c,
                                  b2c=b2c)
        tracing.count("optim.buffers", buffers)
        tracing.count("optim.fused", fused)
        return params, state

    return Optimizer(init=init, update=update)
