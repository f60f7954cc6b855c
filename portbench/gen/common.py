"""What both generators share."""

from __future__ import annotations


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
