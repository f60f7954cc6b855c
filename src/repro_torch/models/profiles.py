"""Analytic per-sched-layer FLOP counts → LayerProfile vectors.

These feed (a) the DynaComm scheduler's cost vectors in analytic mode and
(b) the roofline's MODEL_FLOPS (6·N·D dense / 6·N_active·D MoE) sanity term.
Forward FLOPs are matmul-dominated counts (2·M·N·K per matmul); backward
defaults to 2× forward.
"""

from __future__ import annotations

from typing import List

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.profiler import LayerProfile
from repro_torch.models.moe import expert_capacity
from repro_torch.models.model import sched_layer_bytes


def _attn_flops(cfg: ArchConfig, b: int, t: int, kv_len: int, local: bool) -> float:
    eff_kv = min(kv_len, cfg.sliding_window) if (local and cfg.sliding_window) \
        else kv_len
    proj = 2.0 * b * t * cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim)
    scores = 4.0 * b * cfg.num_heads * t * eff_kv * cfg.head_dim
    out = 2.0 * b * t * cfg.q_dim * cfg.d_model
    return proj + scores + out


def _mla_flops(cfg: ArchConfig, b: int, t: int, kv_len: int,
               decode: bool) -> float:
    """Latent attention: the q and latent projections, ``W_kvb`` over the
    tokens it decompresses (a decode step: every cached slot), the scores
    over the q / k head dim and P V over v's, the output projection."""
    h, r = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    proj = 2.0 * b * t * cfg.d_model * (cfg.q_dim + r + dr)
    kv_b = 2.0 * b * (kv_len if decode else t) * r * h * (dn + dv)
    scores = 2.0 * b * h * t * kv_len * (cfg.head_dim + dv)
    out = 2.0 * b * t * h * dv * cfg.d_model
    return proj + kv_b + scores + out


def _mlp_flops(cfg: ArchConfig, b: int, t: int) -> float:
    mats = 3 if cfg.gated_mlp else 2
    return 2.0 * b * t * cfg.d_model * (cfg.dense_d_ff or cfg.d_ff) * mats


def _moe_flops(cfg: ArchConfig, b: int, t: int) -> float:
    n = b * t
    cap = expert_capacity(n, cfg)
    mats = 3 if cfg.gated_mlp else 2
    router = 2.0 * n * cfg.d_model * cfg.num_experts
    experts = 2.0 * cfg.num_held_experts * cap * cfg.d_model * cfg.d_ff \
        * mats
    shared = 2.0 * n * cfg.d_model * cfg.shared_d_ff * 3
    return router + experts + shared


def _ssd_flops(cfg: ArchConfig, b: int, t: int, decode: bool) -> float:
    """The SSD's products: a decode step updates and reads each head's
    P x N state; train / prefill by chunks of Q, per chunk C B^T (Q^2 N a
    group), (L o C B^T)(dt x) (Q^2 P a head), the chunk's state and the
    output from the state it starts from (Q P N a head each)."""
    h, p, n = cfg.mamba_heads, cfg.mamba_head_dim, cfg.mamba_d_state
    if decode:
        return 2.0 * b * t * h * p * n * 2
    q = cfg.mamba_chunk
    chunks = -(-t // q)
    macs = q * q * (cfg.mamba_groups * n + h * p) + 2 * q * h * p * n
    return 2.0 * b * chunks * macs


def _mamba2_flops(cfg: ArchConfig, b: int, t: int, decode: bool) -> float:
    d, inner, conv = cfg.d_model, cfg.mamba_inner, cfg.mamba_conv_dim
    proj = 2.0 * b * t * d * (inner + conv + cfg.mamba_heads)
    out = 2.0 * b * t * inner * d
    return proj + 2.0 * b * t * conv * cfg.mamba_conv \
        + _ssd_flops(cfg, b, t, decode) + out


def _mlstm_flops(cfg: ArchConfig, b: int, t: int, quadratic: bool) -> float:
    d = cfg.d_model
    di = int(cfg.mlstm_proj_factor * d)
    hd = di // cfg.num_heads
    proj = 2.0 * b * t * d * di * 2 + 2.0 * b * t * di * (3 * di + 2 * cfg.num_heads)
    cell = 4.0 * b * cfg.num_heads * t * t * hd if quadratic \
        else 6.0 * b * cfg.num_heads * t * hd * hd
    down = 2.0 * b * t * di * d
    return proj + cell + down


def _slstm_flops(cfg: ArchConfig, b: int, t: int) -> float:
    d = cfg.d_model
    return 2.0 * b * t * d * d * 8 + 2.0 * b * t * d * d


def _rglru_flops(cfg: ArchConfig, b: int, t: int) -> float:
    d = cfg.d_model
    w = cfg.rglru_lru_width or d
    proj = 2.0 * b * t * d * w * 2
    conv = 2.0 * b * t * w * 4
    gates = 2.0 * b * t * w * w * 2
    scan = 10.0 * b * t * w
    out = 2.0 * b * t * w * d
    return proj + conv + gates + scan + out


def block_forward_flops(cfg: ArchConfig, kind: str, b: int, t: int,
                        kv_len: int, mode: str, mlp: str) -> float:
    """One block's forward: its mixer ``kind`` and its MLP ``mlp`` (the
    layer's entries of ``cfg.layer_kinds()`` and ``cfg.mlp_kinds()``)."""
    if kind in ("global_attn", "local_attn"):
        f = _attn_flops(cfg, b, t, kv_len, kind == "local_attn")
    elif kind == "mlstm":
        f = _mlstm_flops(cfg, b, t, quadratic=(mode != "decode"))
    elif kind == "slstm":
        f = _slstm_flops(cfg, b, t)
    elif kind == "rglru":
        f = _rglru_flops(cfg, b, t)
    elif kind == "mamba2":
        f = _mamba2_flops(cfg, b, t, decode=(mode == "decode"))
    elif kind == "mla":
        f = _mla_flops(cfg, b, t, kv_len, decode=(mode == "decode"))
    else:
        raise ValueError(kind)
    if mlp == "moe":
        f += _moe_flops(cfg, b, t)
    elif mlp == "dense":
        f += _mlp_flops(cfg, b, t)
    return f


def layer_profiles(cfg: ArchConfig, shape: InputShape,
                   param_dtype=torch.float32) -> List[LayerProfile]:
    """One LayerProfile per sched layer (embed, blocks..., head)."""
    b = shape.global_batch
    if shape.mode == "decode":
        t, kv_len = 1, shape.seq_len
    else:
        t = shape.seq_len
        kv_len = shape.seq_len
    pbytes = sched_layer_bytes(cfg, param_dtype)
    kinds = cfg.layer_kinds()

    profs = [LayerProfile(name="embed", param_bytes=pbytes[0],
                          flops_fwd=2.0 * b * t * cfg.d_model)]
    for i, (kind, mlp) in enumerate(zip(kinds, cfg.mlp_kinds())):
        profs.append(LayerProfile(
            name=f"block{i}:{kind}",
            param_bytes=pbytes[1 + i],
            flops_fwd=block_forward_flops(cfg, kind, b, t, kv_len, shape.mode,
                                          mlp),
        ))
    head_flops = 2.0 * b * t * cfg.d_model * cfg.vocab_size
    profs.append(LayerProfile(name="head", param_bytes=pbytes[-1],
                              flops_fwd=head_flops))
    return profs


def model_flops_per_token(cfg: ArchConfig) -> float:
    """The roofline's MODEL_FLOPS/token: 6·N (dense) or 6·N_active (MoE)."""
    from repro_torch.models.model import param_count
    n = param_count(cfg)
    if cfg.is_moe:
        # subtract inactive expert params
        mats = 3 if cfg.gated_mlp else 2
        per_expert = mats * cfg.d_model * cfg.d_ff
        # a share of the experts sees top_k x held / E of a token's
        active = cfg.top_k * cfg.num_held_experts / cfg.num_experts
        inactive = (cfg.num_held_experts - active) * per_expert \
            * cfg.mlp_kinds().count("moe")
        n = n - inactive
    return 6.0 * n
