"""Plain PyTorch oracle: masked softmax attention (causal / window / softcap)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q, k: (B,H,Tq|Tk,hd); v: (B,H,Tk,hdv) (heads pre-broadcast for
    GQA) → (B,H,Tq,hdv); ``scale``: the scores' factor (``None``:
    1 / sqrt(hd))."""
    hd = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s / np.sqrt(hd) if scale is None else s * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    tq, tk = q.shape[2], k.shape[2]
    qpos = torch.arange(tq, device=q.device)[:, None]
    kpos = torch.arange(tk, device=q.device)[None, :]
    ok = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
