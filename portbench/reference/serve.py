"""The reference's logits for served sequences: one full forward over each
prompt and its served tokens, no cache, read at the positions whose next
token was served."""

from __future__ import annotations

from typing import Any, Dict

import torch

from portbench import reference
from portbench.reference.precision import precision


@torch.no_grad()
def logits(cfg: Dict[str, Any], params, tokens: torch.Tensor,
           first: int, mode: str = "fp32") -> torch.Tensor:
    """``tokens`` (B, T): prompt then served tokens; the logits (B, T -
    first, V) of positions ``first..T-1``, each predicting the token
    after it."""
    model = reference.of(cfg)
    with precision(mode, tokens.device):
        x, _ = model.hidden(cfg, params, tokens)
        return model.head(cfg, params, x[:, first:])
