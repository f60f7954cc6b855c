"""Plain PyTorch version of the RG-LRU linear recurrence (the kernel's oracle).

The reference's oracle (``repro/kernels/rglru_scan/ref.py``) is an
associative scan, whose tree order of products cannot be reproduced; this
is the sequential definition instead, the one the CUDA kernel is held to
bitwise: an fp32 carry and two roundings a step (``a·h``, then ``+ x``).
``rglru_scan_backward_ref`` is the plain version of the fused backward.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def rglru_scan_ref(a: torch.Tensor, x: torch.Tensor,
                   reverse: bool = False) -> torch.Tensor:
    """``h_t = a_t·h_{t-1} + x_t`` over axis 1 of ``(B, T, W)`` from
    ``h_{-1} = 0``; with ``reverse`` the recurrence runs from the end,
    ``h_t = a_t·h_{t+1} + x_t`` from ``h_T = 0``.  The carry is fp32, the
    output takes the input dtype."""
    b, t, w = a.shape
    out = torch.empty_like(x)
    h = torch.zeros((b, w), dtype=torch.float32, device=x.device)
    for i in (range(t - 1, -1, -1) if reverse else range(t)):
        h = a[:, i].float() * h + x[:, i].float()
        out[:, i] = h.to(out.dtype)
    return out


def rglru_scan_backward_ref(a: torch.Tensor, h: torch.Tensor,
                            g: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of ``h = rglru_scan_ref(a, x)`` for the cotangent ``g``:
    ``(da, dx)``.  ``dh`` runs the recurrence in reverse over ``a_{t+1}``
    (``a_T = 0``) from ``g``; ``dx = dh`` and ``da = dh·h_{t-1}``
    (``h_{-1} = 0``), the product of the two stored values rounded once."""
    a_next = F.pad(a[:, 1:], (0, 0, 0, 1))
    dh = rglru_scan_ref(a_next, g, reverse=True)
    h_prev = F.pad(h[:, :-1], (0, 0, 1, 0))
    return dh * h_prev, dh
