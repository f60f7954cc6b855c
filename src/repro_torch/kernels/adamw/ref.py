"""Plain PyTorch version of AdamW's update of one buffer (the kernel's
oracle).

The reference's ``b1 * m + (1 - b1) * g`` and the rest op for op, in place
on ``p``, ``m`` and ``v``: the port's loop, which the CPU, the dry runs'
fake tensors and any buffer the kernel does not take run.  The CUDA kernel
(``csrc/adamw.cu``) is held to this bitwise on the card.
"""

from __future__ import annotations

import torch


def adamw_update_ref(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                     v: torch.Tensor, *, lr: float, b1: float, b2: float,
                     eps: float, weight_decay: float, b1c: float,
                     b2c: float) -> None:
    """One step of ``p`` and its moments ``m``, ``v`` from the gradient
    ``g``; ``b1c``, ``b2c`` are the step's bias corrections."""
    g = g.float()
    m.mul_(b1).add_(g * (1 - b1))
    v.mul_(b2).add_(g.square().mul_(1 - b2))
    step_dir = (m / b1c).div_((v / b2c).sqrt_().add_(eps))
    if weight_decay:
        step_dir.add_(p.float(), alpha=weight_decay)
    p.sub_(step_dir.mul_(lr).to(p.dtype))
