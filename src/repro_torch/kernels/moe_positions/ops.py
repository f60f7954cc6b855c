"""Public wrapper of the CUDA MoE position-in-expert kernel.

``moe_positions(flat_e, num_experts, experts_first, num_held_experts, cap)``
gives each assignment's dispatch ``slot`` (int64) and ``keep`` flag (bool)
from its expert, the position inside the expert being the count of earlier
assignments to it.  Dispatch goes by the tensor's device only: on a CUDA
tensor ``csrc/moe_positions.cu`` launches once, with no host sync and no
scratch, so a CUDA graph can capture it once an eager call has built and
loaded it; on any other device (the CPU, the CPU-backed fake tensors of the
dry runs) the one-hot cumulative sum of ``ref.py`` runs.
``LAUNCHES["moe_positions"]`` counts launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_positions.ref import moe_positions_ref

# the kernel keeps an (E, 33) table of lane masks and counts in static
# shared memory, 34.8 KB at this E (csrc/moe_positions.cu: kMaxExperts)
MAX_EXPERTS = 256
MAX_ASSIGNMENTS = 2**31 - 1 - 1024
LAUNCHES: Dict[str, int] = {"moe_positions": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = (_P, _P, _P, _I, _I, _I, _I, _I, _P)   # the last is the stream


def _check(flat_e: torch.Tensor, num_experts: int) -> None:
    if flat_e.dtype != torch.int64:
        raise ValueError(f"moe_positions takes int64 expert ids, got "
                         f"{flat_e.dtype}")
    if flat_e.ndim != 1:
        raise ValueError(f"moe_positions takes the (N·k,) expert ids, got "
                         f"shape {tuple(flat_e.shape)}")
    if not 1 <= num_experts <= MAX_EXPERTS:
        raise ValueError(f"moe_positions takes 1 to {MAX_EXPERTS} experts "
                         f"(the kernel keeps a row of counts an expert in "
                         f"shared memory), got {num_experts}")
    if flat_e.numel() > MAX_ASSIGNMENTS:
        raise ValueError(f"moe_positions takes at most {MAX_ASSIGNMENTS} "
                         f"assignments, got {flat_e.numel()}")


def _launch(flat_e: torch.Tensor, num_experts: int, experts_first: int,
            num_held_experts: int, cap: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    flat_e = flat_e.contiguous()
    slot = torch.empty_like(flat_e)
    keep = torch.empty(flat_e.shape, dtype=torch.bool, device=flat_e.device)
    fn = _build.library("moe_positions").repro_moe_positions
    fn.argtypes = list(_SIGNATURE)
    fn.restype = ctypes.c_int
    status = fn(flat_e.data_ptr(), slot.data_ptr(), keep.data_ptr(),
                flat_e.numel(), num_experts, experts_first, num_held_experts,
                cap, torch.cuda.current_stream(flat_e.device).cuda_stream)
    LAUNCHES["moe_positions"] += 1
    _build.check(status, "moe_positions")
    return slot, keep


def moe_positions(flat_e: torch.Tensor, num_experts: int,
                  experts_first: int, num_held_experts: int, cap: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(slot, keep)`` of ``flat_e (N·k,)`` int64 in ``[0, E)``: keep is
    ``pos < cap`` for the held experts ``[experts_first, experts_first +
    num_held_experts)``, slot ``local · cap + pos`` (``local · cap`` for a
    dropped one, 0 for an expert held elsewhere)."""
    _check(flat_e, num_experts)
    if flat_e.device.type != "cuda":
        return moe_positions_ref(flat_e, num_experts, experts_first,
                                 num_held_experts, cap)
    return _launch(flat_e, num_experts, experts_first, num_held_experts, cap)
