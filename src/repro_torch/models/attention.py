"""GQA attention with rope, sliding window and logit softcap (train/prefill).

On a CUDA tensor every train / prefill call goes through the flash-attention
kernel (``kernels/flash_attention``), whatever T is.  On the CPU the plain
``_sdpa`` runs up to ``FULL_ATTN_MAX`` and the blockwise ``_sdpa_chunked``
above it, as in the reference.  Decode mode and its KV cache wait for the
serving slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, dense, init_dense, softcap

DECODE_PENDING = ("decode mode and the KV cache are not ported yet: they "
                  "wait for the serving slice (ROADMAP, queue 1)")


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S, n_kv, head_dim)
    v: torch.Tensor       # (B, S, n_kv, head_dim)
    pos: torch.Tensor     # () int32 — number of tokens already cached


def init_attn_params(gen, cfg: ArchConfig, dtype=torch.float32,
                     device="cpu"):
    return {
        "wq": init_dense(gen, cfg.d_model, cfg.q_dim, dtype, device),
        "wk": init_dense(gen, cfg.d_model, cfg.kv_dim, dtype, device),
        "wv": init_dense(gen, cfg.d_model, cfg.kv_dim, dtype, device),
        "wo": init_dense(gen, cfg.q_dim, cfg.d_model, dtype, device),
    }


def _mask_bias(q_pos, k_pos, *, causal: bool, window: int, dtype):
    """(Tq, Tk) additive bias; window>0 limits lookback (sliding window)."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    neg = torch.full((), -1e30, dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, neg).to(dtype)


def _sdpa(q, k, v, bias, n_rep: int, cap: float):
    """q: (B,Tq,Hq,hd); k,v: (B,Tk,Hkv,hd); bias: (Tq,Tk)."""
    b, tq, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, tq, hkv, n_rep, hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k) \
        / float(np.float32(np.sqrt(hd)))
    logits = softcap(logits.float(), cap)
    logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v)
    return out.reshape(b, tq, hq, hd)


# Sequences longer than this use the blockwise online-softmax path on the
# CPU (the full T×T score matrix would not fit); on the card the flash
# kernel serves every length.
FULL_ATTN_MAX = 1024


def _block_bias(q_pos, k_pos, *, causal, window):
    return _mask_bias(q_pos, k_pos, causal=causal, window=window,
                      dtype=torch.float32)


def _sdpa_chunked(q, k, v, *, n_rep: int, cap: float, causal: bool,
                  window: int, chunk: int | None = None):
    """Blockwise attention with online softmax (the flash pattern, plain).

    Memory O(Tq·chunk) instead of O(Tq·Tk); causal/windowed query blocks
    skip key blocks that are entirely masked, so FLOPs follow the mask.
    """
    b, tq, hq, hd = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if chunk is None:
        chunk = min(tk, max(1024, tk // 16))
    while tk % chunk:
        chunk //= 2
    n_kv = tk // chunk
    n_q = tq // chunk if tq % chunk == 0 else 1
    qc = tq // n_q

    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(b, tq, hkv, n_rep, hd)
    outs = []
    for qi in range(n_q):
        q_lo, q_hi = qi * qc, (qi + 1) * qc
        q_pos = torch.arange(q_lo, q_hi, device=q.device)
        qq = qg[:, q_lo:q_hi]
        m = torch.full((b, hkv, n_rep, qc), -np.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, n_rep, qc), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, hkv, n_rep, qc, hd), dtype=torch.float32,
                          device=q.device)
        for ki in range(n_kv):
            k_lo, k_hi = ki * chunk, (ki + 1) * chunk
            if causal and k_lo > q_hi - 1:
                continue                       # entirely in the future
            if window > 0 and k_hi - 1 <= q_lo - window:
                continue                       # entirely out of the window
            k_pos = torch.arange(k_lo, k_hi, device=q.device)
            kk, vv = k[:, k_lo:k_hi], v[:, k_lo:k_hi]
            s = torch.einsum("bqgrd,bkgd->bgrqk", qq, kk).float()
            s = softcap(s * scale, cap)
            s = s + _block_bias(q_pos, k_pos, causal=causal, window=window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bgrqk,bkgd->bgrqd", p.to(q.dtype), vv).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, qc, hq, hd)
                    .to(q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def attention(params, x: torch.Tensor, cfg: ArchConfig, *,
              local: bool, mode: str,
              cache: Optional[KVCache] = None,
              positions: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (output (B,T,d_model), updated cache or None)."""
    if mode not in ("train", "prefill"):
        raise NotImplementedError(DECODE_PENDING)
    b, t, _ = x.shape
    n_rep = cfg.num_heads // cfg.num_kv_heads
    window = cfg.sliding_window if local else 0

    q = dense(x, params["wq"]).reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = dense(x, params["wk"]).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    v = dense(x, params["wv"]).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)

    pos = torch.arange(t, device=x.device) if positions is None else positions
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    if x.is_cuda:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=cfg.causal,
                              window=window,
                              softcap=cfg.attn_logit_softcap).transpose(1, 2)
    elif t > FULL_ATTN_MAX:
        out = _sdpa_chunked(q, k, v, n_rep=n_rep,
                            cap=cfg.attn_logit_softcap,
                            causal=cfg.causal, window=window)
    else:
        bias = _mask_bias(pos, pos, causal=cfg.causal, window=window,
                          dtype=torch.float32)
        out = _sdpa(q, k, v, bias, n_rep, cfg.attn_logit_softcap)
    out = out.reshape(b, t, cfg.q_dim)
    new_cache = None
    if mode == "prefill":
        if window and t > window:
            # rotating buffer invariant: absolute position p sits at slot
            # p % window
            shift = (t - window) % window
            ck = torch.roll(k[:, -window:], shifts=shift, dims=1)
            cv = torch.roll(v[:, -window:], shifts=shift, dims=1)
        elif window and t < window:
            padw = window - t
            ck = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, padw))
            cv = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, padw))
        else:
            ck, cv = k, v
        new_cache = KVCache(k=ck, v=cv, pos=torch.tensor(
            t, dtype=torch.int32, device=x.device))
    return dense(out, params["wo"]), new_cache
