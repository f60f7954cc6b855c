"""Per-layer block: init / apply for the attention kinds with a dense MLP.

Every block is addressable individually — DynaComm schedules transmissions
layer by layer.  The recurrent kinds (mLSTM, sLSTM, RG-LRU) and the MoE MLP
wait for a later slice and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.configs.base import ArchConfig, LayerKind
from repro_torch.models import attention
from repro_torch.models.layers import apply_mlp, init_mlp, rms_norm

ATTN_KINDS = ("global_attn", "local_attn")


def _check(cfg: ArchConfig, kind: LayerKind) -> None:
    if kind not in ATTN_KINDS:
        if kind in ("mlstm", "slstm", "rglru"):
            raise NotImplementedError(
                f"layer kind {kind!r} is not ported yet (ROADMAP queue 1: "
                f"remaining families)")
        raise ValueError(kind)
    if cfg.is_moe:
        raise NotImplementedError("the MoE MLP is not ported yet (ROADMAP "
                                  "queue 1: remaining families)")


def init_block(gen, cfg: ArchConfig, kind: LayerKind, dtype=torch.float32,
               device="cpu"):
    _check(cfg, kind)
    p: dict = {"norm1": torch.zeros((cfg.d_model,), dtype=dtype,
                                    device=device)}
    p["attn"] = attention.init_attn_params(gen, cfg, dtype, device)
    if cfg.d_ff > 0:
        p["norm2"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype,
                            device)
    return p


def apply_block(params, x: torch.Tensor, cfg: ArchConfig, kind: LayerKind,
                *, mode: str, cache: Any = None
                ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Returns (x, new_cache, aux_loss)."""
    _check(cfg, kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    out, new_cache = attention.attention(
        params["attn"], h, cfg, local=(kind == "local_attn"), mode=mode,
        cache=cache)
    x = x + out
    if cfg.d_ff > 0:
        h2 = rms_norm(x, params["norm2"], cfg.norm_eps)
        x = x + apply_mlp(params["mlp"], h2, cfg.activation)
    return x, new_cache, aux
