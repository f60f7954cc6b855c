"""Matrix products at the precision a run asks for.

``fp32`` is float32 with TF32 off, as the configurations state it.
``tf32`` is the control: the nearest precision below.  On the card it
turns on TF32 for matrix products; on the CPU, which has no TF32, each
product's operands are rounded to TF32's 10-bit mantissa first, in the
backward too (the incoming gradient is rounded before the products that
take it), and the products accumulate in float32, as TF32's do.
"""

from __future__ import annotations

import contextlib

import torch

_MODE = {"emulate": False}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest TF32 value (ties to even)."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class _Round(torch.autograd.Function):
    """An operand rounded to TF32; its gradient passes as it is."""

    @staticmethod
    def forward(ctx, x):
        return tf32_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """The identity, whose incoming gradient is rounded to TF32 before
    the backward products take it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return tf32_round(g)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _MODE["emulate"]:
        return _RoundGrad.apply(torch.matmul(_Round.apply(a),
                                             _Round.apply(b)))
    return torch.matmul(a, b)


@contextlib.contextmanager
def precision(mode: str, device):
    """Products inside run at ``mode`` (``fp32`` or ``tf32``)."""
    if mode not in ("fp32", "tf32"):
        raise ValueError(f"unknown precision {mode!r}")
    cuda = torch.device(device).type == "cuda"
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32, _MODE["emulate"])
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32" and cuda
    torch.backends.cudnn.allow_tf32 = mode == "tf32" and cuda
    _MODE["emulate"] = mode == "tf32" and not cuda
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, _MODE["emulate"]) = old
