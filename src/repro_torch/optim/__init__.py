"""Optimizers over lists of flat buffers (in-place, one buffer at a time)."""

from repro_torch.optim.optimizers import OptState, Optimizer, adamw, sgd

__all__ = ["Optimizer", "OptState", "sgd", "adamw"]
