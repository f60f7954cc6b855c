"""GQA attention with rope (or no positions: ``position_embedding``
``nope``), sliding window, logit softcap, a scale of the scores
(``attention_multiplier``, by default 1 / sqrt(head_dim)) and a KV cache.

Three modes share one code path, as in the reference:

* ``train`` / ``prefill`` — full-sequence attention, causal or
  bidirectional (encoder).  On a CUDA tensor every call goes through the
  flash-attention kernel (``kernels/flash_attention``), whatever T is; on
  the CPU the plain ``_sdpa`` runs up to ``FULL_ATTN_MAX`` and the
  blockwise ``_sdpa_chunked`` above it.  Prefill also returns the cache.
* ``decode`` — one new token against the cache: the plain ``_sdpa`` over
  every slot with a slot-validity bias, on either device (the reference
  computes it outside its Pallas kernel too).  Global layers cache the
  whole sequence; local layers keep a rotating window-sized cache in which
  absolute position p sits at slot ``p % S``.

Decode writes the new key and value into the cache **in place** (an index
copy at a slot computed on the device, so no host sync) and returns the
same tensors with ``pos + 1``; the reference returns new arrays.  A caller
that keeps a cache across steps must clone it.

**Latent attention** (``mla``, DeepSeek-V2/V3's MLA; :func:`mla`): per
token ``q = h W_q`` (H heads of ``[q_nope | q_pe]``), ``[c | k_pe] = h
W_kva``, ``c = rms(c, kv_norm)``, ``[k_nope | v] = c W_kvb`` per head;
``q_pe`` and the one-head ``k_pe`` take rope, ``k = [k_nope | k_pe]``
broadcast over the heads, and the causal softmax of ``q k^T`` (scale
1 / sqrt(head_dim) by default) weighs v, whose head dim is narrower than
q's and k's.  Train and prefill run the full sequence through flash on
the card (its 192 / 128 template).  The cache is the latent: ``c`` and the
rotated ``k_pe`` a token (:class:`MLACache`), and a decode step writes its
token's into it in place, then decompresses every slot's k and v through
``W_kvb`` and attends over them with the plain ``_sdpa``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import (apply_rope, dense, init_dense,
                                       rms_norm, softcap)

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


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, local: bool,
               dtype=torch.float32, device="cpu") -> KVCache:
    """Zeros; a local layer's cache has ``min(max_len, window)`` slots."""
    s = min(max_len, cfg.sliding_window) if local and cfg.sliding_window \
        else max_len
    shape = (batch, s, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=torch.zeros((), dtype=torch.int32, device=device))


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


def _sdpa(q, k, v, bias, n_rep: int, cap: float,
          scale: Optional[float] = None):
    """q, k: (B,Tq|Tk,Hq|Hkv,hd); v: (B,Tk,Hkv,hdv); bias: (Tq,Tk);
    ``scale``: the scores' factor (``None``: 1 / sqrt(hd))."""
    b, tq, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, tq, hkv, n_rep, hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k)
    logits = logits / float(np.float32(np.sqrt(hd))) if scale is None \
        else logits * scale
    logits = softcap(logits.float(), cap)
    logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v)
    return out.reshape(b, tq, hq, v.shape[-1])


# Sequences longer than this use the blockwise online-softmax path on the
# CPU (the full T×T score matrix would not fit); on the card the flash
# kernel serves every length.
FULL_ATTN_MAX = 1024


def _block_bias(q_pos, k_pos, *, causal, window):
    return _mask_bias(q_pos, k_pos, causal=causal, window=window,
                      dtype=torch.float32)


def _sdpa_chunked(q, k, v, *, n_rep: int, cap: float, causal: bool,
                  window: int, chunk: int | None = None,
                  scale: Optional[float] = None):
    """Blockwise attention with online softmax (the flash pattern, plain).

    Memory O(Tq·chunk) instead of O(Tq·Tk); causal/windowed query blocks
    skip key blocks that are entirely masked, so FLOPs follow the mask.
    """
    b, tq, hq, hd = q.shape
    tk, hkv, hdv = k.shape[1], k.shape[2], v.shape[-1]
    if chunk is None:
        chunk = min(tk, max(1024, tk // 16))
    while tk % chunk:
        chunk //= 2
    n_kv = tk // chunk
    n_q = tq // chunk if tq % chunk == 0 else 1
    qc = tq // n_q

    scale = 1.0 / np.sqrt(hd) if scale is None else scale
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
        acc = torch.zeros((b, hkv, n_rep, qc, hdv), dtype=torch.float32,
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
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, qc, hq, hdv)
                    .to(q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def _full(q, k, v, cfg: ArchConfig, pos: torch.Tensor, *, window: int,
          n_rep: int) -> torch.Tensor:
    """Full-sequence attention of q, k (B, T, H | Hkv, hd) and v (B, T,
    Hkv, hdv): the flash kernel on the card; on the CPU the plain
    ``_sdpa`` up to ``FULL_ATTN_MAX``, the blockwise one above."""
    scale = cfg.attention_multiplier
    if q.is_cuda:
        return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=cfg.causal,
                               window=window, softcap=cfg.attn_logit_softcap,
                               scale=scale).transpose(1, 2)
    if q.shape[1] > FULL_ATTN_MAX:
        return _sdpa_chunked(q, k, v, n_rep=n_rep,
                             cap=cfg.attn_logit_softcap, causal=cfg.causal,
                             window=window, scale=scale)
    bias = _mask_bias(pos, pos, causal=cfg.causal, window=window,
                      dtype=torch.float32)
    return _sdpa(q, k, v, bias, n_rep, cfg.attn_logit_softcap, scale)


def attention(params, x: torch.Tensor, cfg: ArchConfig, *,
              local: bool, mode: str,
              cache: Optional[KVCache] = None,
              positions: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (output (B,T,d_model), updated cache or None)."""
    b, t, _ = x.shape
    n_rep = cfg.num_heads // cfg.num_kv_heads
    window = cfg.sliding_window if local else 0

    q = dense(x, params["wq"]).reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = dense(x, params["wk"]).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    v = dense(x, params["wv"]).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)

    if mode == "decode":
        out, new_cache = _decode(q, k, v, cache, cfg, window, n_rep)
        return dense(out, params["wo"]), new_cache
    if mode not in ("train", "prefill"):
        raise ValueError(f"unknown attention mode {mode!r}")

    pos = torch.arange(t, device=x.device) if positions is None else positions
    if cfg.position_embedding == "rope":
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = _full(q, k, v, cfg, pos, window=window, n_rep=n_rep)
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
        new_cache = KVCache(k=ck, v=cv, pos=torch.full(
            (), t, dtype=torch.int32, device=x.device))
    return dense(out, params["wo"]), new_cache


def _decode(q, k, v, cache: Optional[KVCache], cfg: ArchConfig, window: int,
            n_rep: int) -> Tuple[torch.Tensor, KVCache]:
    """One token (T = 1) against ``cache``, written into it in place.

    ``pos`` stays a 0-d device tensor throughout: the slot, the key
    positions and the bias are computed on the device."""
    b, t = q.shape[:2]
    if cache is None or t != 1:
        raise ValueError(f"decode takes one token and a cache, got T = {t} "
                         f"and cache {type(cache).__name__}")
    pos = cache.pos                    # () int32: the new token's position
    if cfg.position_embedding == "rope":
        q = apply_rope(q, pos[None][None, :], cfg.rope_theta)
        k = apply_rope(k, pos[None][None, :], cfg.rope_theta)

    s = cache.k.shape[1]
    if window and window < 10**9:
        slot = torch.remainder(pos, s)
    else:
        # jax.lax.dynamic_update_slice clamps its start: at pos >= S the
        # reference overwrites the last slot, and so does the port
        slot = pos.clamp(max=s - 1)
    index = slot.reshape(1).long()
    cache.k.index_copy_(1, index, k)
    cache.v.index_copy_(1, index, v)

    # key positions: slot i holds the latest absolute p <= pos with
    # p % s == i (a floor modulus of a negative number: torch.remainder)
    slots = torch.arange(s, device=q.device)
    kpos = pos - torch.remainder(pos - slots, s) if window else slots
    valid = (kpos <= pos) & (kpos >= 0)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    neg = torch.full((), -1e30, dtype=torch.float32, device=q.device)
    bias = torch.where(valid, zero, neg)[None, :]

    out = _sdpa(q, cache.k, cache.v, bias, n_rep, cfg.attn_logit_softcap,
                cfg.attention_multiplier)
    return out.reshape(b, t, cfg.q_dim), KVCache(k=cache.k, v=cache.v,
                                                 pos=pos + 1)


# ---------------------------------------------------------------------------
# latent attention (MLA)
# ---------------------------------------------------------------------------


class MLACache(NamedTuple):
    c: torch.Tensor       # (B, S, kv_lora_rank): the normed latent
    k_pe: torch.Tensor    # (B, S, qk_rope_head_dim): the rotated rope key
    pos: torch.Tensor     # () int32 — number of tokens already cached


def init_mla_params(gen, cfg: ArchConfig, dtype=torch.float32,
                    device="cpu"):
    """``wq (d, H (nope + rope))``, ``wkv_a (d, r + rope)``, ``kv_norm
    (r,)`` (zeros: the norm scales by ``1 + s``), ``wkv_b (r, H (nope +
    v))`` with each head's ``[k_nope | v]`` columns side by side, ``wo
    (H v, d)``."""
    h, r, dr = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    return {"wq": init_dense(gen, cfg.d_model, cfg.q_dim, dtype, device),
            "wkv_a": init_dense(gen, cfg.d_model, r + dr, dtype, device),
            "kv_norm": torch.zeros((r,), dtype=dtype, device=device),
            "wkv_b": init_dense(gen, r, h * (cfg.qk_nope_head_dim
                                             + cfg.v_head_dim), dtype,
                                device),
            "wo": init_dense(gen, h * cfg.v_head_dim, cfg.d_model, dtype,
                             device)}


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int,
                   dtype=torch.float32, device="cpu") -> MLACache:
    """Zeros: ``kv_lora_rank + qk_rope_head_dim`` numbers a token."""
    return MLACache(
        c=torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                      device=device),
        k_pe=torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                         dtype=dtype, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device))


def _mla_project(params, x: torch.Tensor, cfg: ArchConfig,
                 pos: torch.Tensor):
    """q (B, T, H, nope + rope) with its rope part rotated, the normed
    latent c (B, T, r) and the rotated one-head rope key (B, T, rope)."""
    b, t, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = dense(x, params["wq"]).reshape(b, t, cfg.num_heads, dn + dr)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    q = torch.cat([q_nope, apply_rope(q_pe, pos, cfg.rope_theta)], dim=-1)
    c, k_pe = dense(x, params["wkv_a"]).split([cfg.kv_lora_rank, dr],
                                               dim=-1)
    c = rms_norm(c, params["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(k_pe[:, :, None], pos, cfg.rope_theta)[:, :, 0]
    return q, c, k_pe


def _mla_keys(params, c: torch.Tensor, k_pe: torch.Tensor,
              cfg: ArchConfig):
    """k (B, S, H, nope + rope): each head's ``c W_kvb`` nope part beside
    the shared rope key; v (B, S, H, v_head_dim), a view."""
    b, s, _ = c.shape
    h, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    kv = dense(c, params["wkv_b"]).reshape(b, s, h, dn + cfg.v_head_dim)
    k_nope, v = kv.split([dn, cfg.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(b, s, h, dr)], dim=-1)
    return k, v


def mla(params, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
        cache: Optional[MLACache] = None
        ) -> Tuple[torch.Tensor, Optional[MLACache]]:
    """Returns (output (B, T, d_model), the latent cache or None); spans
    ``mla.attention`` (forward and recompute) and ``mla.backward``."""
    with tracing.span("mla.attention"):
        out, new_cache = _mla(params, x, cfg, mode, cache)
    tracing.backward_span("mla.backward", x, (out,))
    return out, new_cache


def _mla(params, x, cfg: ArchConfig, mode: str, cache):
    b, t, _ = x.shape
    width = cfg.num_heads * cfg.v_head_dim
    if mode == "decode":
        if cache is None or t != 1:
            raise ValueError(f"decode takes one token and a cache, got "
                             f"T = {t} and cache {type(cache).__name__}")
        pos = cache.pos
        q, c, k_pe = _mla_project(params, x, cfg, pos[None][None, :])
        s = cache.c.shape[1]
        index = pos.clamp(max=s - 1).reshape(1).long()
        cache.c.index_copy_(1, index, c)
        cache.k_pe.index_copy_(1, index, k_pe)
        k, v = _mla_keys(params, cache.c, cache.k_pe, cfg)
        slots = torch.arange(s, device=x.device)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        neg = torch.full((), -1e30, dtype=torch.float32, device=x.device)
        bias = torch.where(slots <= pos, zero, neg)[None, :]
        out = _sdpa(q, k, v, bias, 1, cfg.attn_logit_softcap,
                    cfg.attention_multiplier)
        return dense(out.reshape(b, t, width), params["wo"]), \
            MLACache(c=cache.c, k_pe=cache.k_pe, pos=pos + 1)
    if mode not in ("train", "prefill"):
        raise ValueError(f"unknown attention mode {mode!r}")
    pos = torch.arange(t, device=x.device)
    q, c, k_pe = _mla_project(params, x, cfg, pos)
    k, v = _mla_keys(params, c, k_pe, cfg)
    out = _full(q, k, v, cfg, pos, window=0, n_rep=1).reshape(b, t, width)
    new_cache = MLACache(c=c, k_pe=k_pe, pos=torch.full(
        (), t, dtype=torch.int32, device=x.device)) \
        if mode == "prefill" else None
    return dense(out, params["wo"]), new_cache
