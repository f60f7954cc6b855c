"""Per-layer block: init / apply for every layer kind (the attention kinds,
latent attention, mLSTM, sLSTM, the RG-LRU and Mamba-2), with the MLP
that ``cfg.mlp_kinds()`` gives the layer: a dense MLP (the leading
``first_dense_layers`` of an MoE model take ``dense_d_ff``) or the MoE MLP
(``models/moe.py``), whose router load-balance loss is the block's aux,
plus a shared SwiGLU expert where the config has one (``shared_d_ff``).
``apply_block`` reads which from the block's parameters.  xLSTM configs
have ``d_ff = 0``: their blocks carry their own up / down projections and
no MLP.  Each branch is added to the residual stream times
``cfg.residual_multiplier`` (granite 4.0's muP).

Every block is addressable individually — DynaComm schedules transmissions
layer by layer.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.configs.base import ArchConfig, LayerKind, MlpKind
from repro_torch.models import attention, ssm
from repro_torch.models.layers import apply_mlp, init_mlp, rms_norm
from repro_torch.models.moe import apply_moe, init_moe_params

ATTN_KINDS = ("global_attn", "local_attn")
MLA = "mla"
# recurrent kind -> (its parameter key's init, its apply)
RECURRENT = {"mlstm": (ssm.init_mlstm_params, ssm.apply_mlstm),
             "slstm": (ssm.init_slstm_params, ssm.apply_slstm),
             "rglru": (ssm.init_rglru_params, ssm.apply_rglru),
             "mamba2": (ssm.init_mamba2_params, ssm.apply_mamba2)}


def _check(cfg: ArchConfig, kind: LayerKind) -> None:
    if kind not in ATTN_KINDS and kind != MLA and kind not in RECURRENT:
        raise ValueError(kind)


def init_block(gen, cfg: ArchConfig, kind: LayerKind, dtype=torch.float32,
               device="cpu", *, mlp: MlpKind):
    """One block's parameters; ``mlp``: the layer's entry of
    ``cfg.mlp_kinds()``."""
    _check(cfg, kind)
    p: dict = {"norm1": torch.zeros((cfg.d_model,), dtype=dtype,
                                    device=device)}
    if kind in ATTN_KINDS:
        p["attn"] = attention.init_attn_params(gen, cfg, dtype, device)
    elif kind == MLA:
        p["mla"] = attention.init_mla_params(gen, cfg, dtype, device)
    else:
        p[kind] = RECURRENT[kind][0](gen, cfg, dtype, device)
    if mlp != "none":
        p["norm2"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
        if mlp == "moe":
            p["moe"] = init_moe_params(gen, cfg, dtype, device)
            if cfg.shared_d_ff:
                p["shared"] = init_mlp(gen, cfg.d_model, cfg.shared_d_ff,
                                       True, dtype, device)
        else:
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.dense_d_ff or cfg.d_ff,
                                cfg.gated_mlp, dtype, device)
    return p


def init_block_cache(cfg: ArchConfig, kind: LayerKind, batch: int,
                     max_len: int, dtype=torch.float32, device="cpu"):
    """The empty decode state of one block: a KV cache (a local layer's of
    ``min(max_len, window)`` slots) or the recurrence's zero state."""
    _check(cfg, kind)
    if kind in ATTN_KINDS:
        return attention.init_cache(cfg, batch, max_len,
                                    local=(kind == "local_attn"),
                                    dtype=dtype, device=device)
    if kind == MLA:
        return attention.init_mla_cache(cfg, batch, max_len, dtype=dtype,
                                        device=device)
    if kind == "rglru":
        return ssm.init_rglru_state(cfg, batch, dtype=dtype, device=device)
    if kind == "mamba2":
        return ssm.init_mamba2_state(cfg, batch, dtype=dtype, device=device)
    init = ssm.init_mlstm_state if kind == "mlstm" else ssm.init_slstm_state
    return init(cfg, batch, device=device)


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
    elif kind == MLA:
        out, new_cache = attention.mla(params["mla"], h, cfg, mode=mode,
                                       cache=cache)
    else:
        out, new_cache = RECURRENT[kind][1](params[kind], h, cfg, mode=mode,
                                            state=cache)
    x = _residual(x, out, cfg)
    if "norm2" in params:
        h2 = rms_norm(x, params["norm2"], cfg.norm_eps)
        if "moe" in params:
            out2, aux = apply_moe(params["moe"], h2, cfg)
            if "shared" in params:
                out2 = out2 + apply_mlp(params["shared"], h2, cfg.activation)
        else:
            out2 = apply_mlp(params["mlp"], h2, cfg.activation)
        x = _residual(x, out2, cfg)
    return x, new_cache, aux


def _residual(x: torch.Tensor, branch: torch.Tensor,
              cfg: ArchConfig) -> torch.Tensor:
    r = cfg.residual_multiplier
    return x + branch if r == 1.0 else x + r * branch
