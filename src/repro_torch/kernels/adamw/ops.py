"""Public wrapper of the CUDA AdamW update (one buffer a launch).

``adamw_update(g, p, m, v, ...)`` updates ``p`` and its moments in place.
Dispatch goes by where the tensors are, not by a setting: on real CUDA
tensors ``csrc/adamw.cu`` launches once, with no host sync and no scratch
(a gradient of another dtype or a strided one is first made a
contiguous float32 copy, as the plain loop's ``g.float()`` reads it); a
``p``, ``m`` or ``v`` the kernel cannot update in place (not float32, not
contiguous), lengths that differ or a second device raise ``ValueError``.
The CPU, ``meta`` and fake tensors of the dry runs take the plain loop of
``ref.py``.  Both give the same bits on the card.  ``LAUNCHES["adamw"]``
counts launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build
from repro_torch.kernels.adamw.ref import adamw_update_ref

LAUNCHES: Dict[str, int] = {"adamw": 0}
ENTRY = "repro_adamw"
_P, _F = ctypes.c_void_p, ctypes.c_float
# g, p, m, v, n, nine float32 scalars, decay, stream
_SIGNATURE = (_P, _P, _P, _P, ctypes.c_longlong, *(_F,) * 9, ctypes.c_int,
              _P)


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda and not is_fake(t)


def fusable(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
            v: torch.Tensor) -> bool:
    """Whether the kernel runs this buffer: True where any of the four is
    a real CUDA tensor, once all four have passed the kernel's checks;
    False for the CPU, ``meta`` and fake tensors."""
    ts = (g, p, m, v)
    if not any(_on_card(t) for t in ts):
        return False
    if not all(_on_card(t) for t in ts) or len({t.device for t in ts}) != 1:
        raise ValueError(f"adamw takes g, p, m, v on one card, got "
                         f"{[str(t.device) for t in ts]}")
    for name, t in zip("pmv", ts[1:]):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"adamw updates {name} in place: it must be "
                             f"contiguous float32, got {t.dtype} of "
                             f"strides {t.stride()}")
    if len({t.numel() for t in ts}) != 1:
        raise ValueError(f"adamw takes g, p, m, v of one length, got "
                         f"{[t.numel() for t in ts]}")
    return True


def _f32(x: float) -> float:
    return float(np.float32(x))


def _launch(g, p, m, v, *, lr, b1, b2, eps, weight_decay, b1c, b2c) -> None:
    # PyTorch divides a CUDA tensor by a CPU scalar as a product with the
    # scalar's float32 reciprocal, taken on the host
    inv_b1c = float(np.float32(1.0) / np.float32(b1c))
    inv_b2c = float(np.float32(1.0) / np.float32(b2c))
    fn = getattr(_build.library("adamw"), ENTRY)
    fn.argtypes = list(_SIGNATURE)
    fn.restype = ctypes.c_int
    status = fn(g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
                p.numel(), _f32(b1), _f32(1 - b1), _f32(b2), _f32(1 - b2),
                inv_b1c, inv_b2c, _f32(eps), _f32(lr), _f32(weight_decay),
                int(bool(weight_decay)),
                torch.cuda.current_stream(p.device).cuda_stream)
    LAUNCHES["adamw"] += 1
    _build.check(status, "adamw")


def adamw_update(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, *, lr: float, b1: float, b2: float,
                 eps: float, weight_decay: float, b1c: float,
                 b2c: float) -> bool:
    """One AdamW step of ``p``, ``m``, ``v`` in place from ``g`` (the bias
    corrections ``b1c``, ``b2c`` as the plain loop takes them); whether the
    kernel ran it."""
    args = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                b1c=b1c, b2c=b2c)
    if fusable(g, p, m, v):
        _launch(g.float().contiguous(), p, m, v, **args)
        return True
    adamw_update_ref(g, p, m, v, **args)
    return False
