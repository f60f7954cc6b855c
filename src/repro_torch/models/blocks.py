"""Per-layer block: init / apply for the attention kinds and the RG-LRU,
with a dense MLP or, when the config has experts, the MoE MLP
(``models/moe.py``), whose router load-balance loss is the block's aux.

Every block is addressable individually — DynaComm schedules transmissions
layer by layer.  The xLSTM kinds (mLSTM, sLSTM) wait for a later slice and
raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.configs.base import ArchConfig, LayerKind
from repro_torch.models import attention, ssm
from repro_torch.models.layers import apply_mlp, init_mlp, rms_norm
from repro_torch.models.moe import apply_moe, init_moe_params

ATTN_KINDS = ("global_attn", "local_attn")


def _check(cfg: ArchConfig, kind: LayerKind) -> None:
    if kind not in ATTN_KINDS + ("rglru",):
        if kind in ("mlstm", "slstm"):
            raise NotImplementedError(
                f"layer kind {kind!r} is not ported yet (ROADMAP queue 1: "
                f"remaining families)")
        raise ValueError(kind)


def init_block(gen, cfg: ArchConfig, kind: LayerKind, dtype=torch.float32,
               device="cpu"):
    _check(cfg, kind)
    p: dict = {"norm1": torch.zeros((cfg.d_model,), dtype=dtype,
                                    device=device)}
    if kind in ATTN_KINDS:
        p["attn"] = attention.init_attn_params(gen, cfg, dtype, device)
    else:
        p["rglru"] = ssm.init_rglru_params(gen, cfg, dtype, device)
    if cfg.d_ff > 0:
        p["norm2"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
        if cfg.is_moe:
            p["moe"] = init_moe_params(gen, cfg, dtype, device)
        else:
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                                dtype, device)
    return p


def apply_block(params, x: torch.Tensor, cfg: ArchConfig, kind: LayerKind,
                *, mode: str, cache: Any = None
                ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Returns (x, new_cache, aux_loss)."""
    _check(cfg, kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        out, new_cache = attention.attention(
            params["attn"], h, cfg, local=(kind == "local_attn"), mode=mode,
            cache=cache)
    else:
        out, new_cache = ssm.apply_rglru(params["rglru"], h, cfg, mode=mode,
                                         state=cache)
    x = x + out
    if cfg.d_ff > 0:
        h2 = rms_norm(x, params["norm2"], cfg.norm_eps)
        if cfg.is_moe:
            out2, aux = apply_moe(params["moe"], h2, cfg)
        else:
            out2 = apply_mlp(params["mlp"], h2, cfg.activation)
        x = x + out2
    return x, new_cache, aux
