"""Plain PyTorch version of the MoE position-in-expert (the kernel's oracle).

Each assignment's position inside its expert is the one-hot exclusive
cumulative count over the assignments before it, as the reference's
``repro/models/moe.py`` computes it; the held range and the capacity then
give the dispatch slot and the keep flag.  The CUDA kernel
(``csrc/moe_positions.cu``) is held to this bitwise.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def moe_positions_ref(flat_e: torch.Tensor, num_experts: int,
                      experts_first: int, num_held_experts: int, cap: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(slot, keep)`` of the assignments' experts ``flat_e (N·k,)``
    (int64, assignment-major): keep within ``cap`` and held here, the row
    of the held experts' ``(E' x cap)`` dispatch buffer."""
    onehot = F.one_hot(flat_e, num_experts)                 # (N·k, E)
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot         # exclusive
    pos = (pos_in_e * onehot).sum(dim=1)                    # (N·k,)
    local = flat_e - experts_first
    held = (local >= 0) & (local < num_held_experts)
    keep = (pos < cap) & held
    slot = torch.where(held, local, 0) * cap + torch.where(keep, pos, 0)
    return slot, keep
