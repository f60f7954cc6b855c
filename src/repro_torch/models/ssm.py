"""Recurrent blocks: xLSTM (mLSTM + sLSTM), the RG-LRU of RecurrentGemma /
Griffin and the Mamba-2 mixer of granite 4.0-H (train, prefill and the
O(1)-state decode step).

The first three follow the reference (``repro/models/ssm.py``), not the
published models: the same parameter keys, shapes and arithmetic order.
Mamba-2 has no counterpart there; it follows the published layer
(Mamba-2, arXiv:2405.21060; granite 4.0-H's ``GraniteMoeHybridMambaLayer``)
and is held to the benchmark's plain reference
(``portbench/reference/granite_hybrid.py``).

* mLSTM — matrix-memory LSTM (arXiv:2405.04517 eq. 19-27).  Up to
  ``MLSTM_CHUNK`` steps the stabilised quadratic parallel form runs; above
  it the chunkwise form (intra-chunk parallel, inter-chunk carry of
  (C, n, m)), which also gives the prefill state.
* sLSTM — scalar-memory LSTM with exponential gating and state
  normalisation, a loop over time.  The four input products ``x_t @ W_g``
  do not depend on the carry and are taken for all T at once before the
  loop; inside it each gate sums ``x@W + h@R`` in the reference's order.
* RG-LRU — real-gated linear recurrent unit (arXiv:2402.19427 §2.4) inside
  the Griffin recurrent block: input projection → 4-tap temporal conv →
  gated linear recurrence → gated output projection, with dense W×W gates.
  The recurrence always goes through ``kernels/rglru_scan``: the CUDA
  kernel on a CUDA tensor, its plain loop on a CPU tensor (the
  reference's ``use_kernel`` switch is gone: dispatch goes by the
  tensor's device, as for attention).

``mode="decode"`` takes one token (T = 1) and the block's state (the
prefill's, or ``init_*_state``) and returns the next state, as the
reference: the mLSTM through ``_mlstm_step``, the sLSTM through
``_slstm_step``, the RG-LRU through its 4-tap conv over ``state.conv``
and the token, then ``h = a·h + x_in`` (plain torch on either device: one
step needs no scan kernel).  States are new tensors, never updated in
place.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.models.layers import dense, init_dense, normal, rms_norm


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere (``F.softplus``
    turns into the identity above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``, through ``_softplus`` so
    that a cumulative sum of it starts from the reference's bits."""
    return -_softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


class MLSTMState(NamedTuple):
    c: torch.Tensor     # (B, H, hd, hd) matrix memory
    n: torch.Tensor     # (B, H, hd) normaliser
    m: torch.Tensor     # (B, H) stabiliser


def init_mlstm_params(gen, cfg: ArchConfig, dtype=torch.float32,
                      device="cpu"):
    d = cfg.d_model
    di = int(cfg.mlstm_proj_factor * d)
    return {
        "up": init_dense(gen, d, di, dtype, device),
        "up_gate": init_dense(gen, d, di, dtype, device),
        "wq": init_dense(gen, di, di, dtype, device),
        "wk": init_dense(gen, di, di, dtype, device),
        "wv": init_dense(gen, di, di, dtype, device),
        "wi": init_dense(gen, di, cfg.num_heads, dtype, device),
        "wf": init_dense(gen, di, cfg.num_heads, dtype, device),
        "down": init_dense(gen, di, d, dtype, device),
    }


def _check_step(mode: str, state, t: int) -> None:
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "decode" and (state is None or t != 1):
        raise ValueError(f"decode takes one token and a state, got T = {t} "
                         f"and state {type(state).__name__}")


def _causal(t: int, device) -> torch.Tensor:
    return torch.ones((t, t), dtype=torch.bool, device=device).tril()


def _mlstm_parallel(q, k, v, i_gate, f_gate):
    """Stabilised parallel form.  q,k,v: (B,H,T,hd); gates: (B,H,T)."""
    hd = q.shape[-1]
    logf = _log_sigmoid(f_gate.float())                          # (B,H,T)
    F_ = torch.cumsum(logf, dim=-1)                              # Σ_{s<=t}
    # D̃[t,s] = F_t - F_s + ĩ_s  for s<=t
    dtil = F_[..., :, None] - F_[..., None, :] + i_gate.float()[..., None, :]
    dtil = torch.where(_causal(q.shape[2], q.device), dtil, -np.inf)
    m = dtil.amax(dim=-1, keepdim=True)                          # (B,H,T,1)
    dmat = torch.exp(dtil - m)
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) \
        / float(np.float32(np.sqrt(hd)))
    sd = s * dmat
    norm = torch.maximum(sd.sum(dim=-1, keepdim=True).abs(), torch.exp(-m))
    h = torch.einsum("bhts,bhsd->bhtd", sd / norm, v.float())
    return h.to(q.dtype)


# Sequences longer than this use the chunkwise form in train / prefill (the
# full T×T decay matrix grows as T²): intra-chunk parallel (c×c tiles),
# inter-chunk recurrent carry (C, n, m), mathematically the parallel form.
MLSTM_CHUNK = 256


def _mlstm_chunkwise(q, k, v, i_gate, f_gate, chunk: Optional[int] = None):
    """q,k,v: (B,H,T,hd); gates: (B,H,T) → h: (B,H,T,hd), final state."""
    if chunk is None:
        chunk = MLSTM_CHUNK          # module attribute: patchable
    b, h, t, hd = q.shape
    while t % chunk:
        chunk //= 2
    scale = 1.0 / np.sqrt(hd)
    causal = _causal(chunk, q.device)
    C = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, h, hd), dtype=torch.float32, device=q.device)
    m_run = torch.zeros((b, h), dtype=torch.float32, device=q.device)
    outs = []
    for lo in range(0, t, chunk):
        part = slice(lo, lo + chunk)
        qq32, kk32, vv32 = (x[:, :, part].float() for x in (q, k, v))
        lf = _log_sigmoid(f_gate[..., part].float())          # (B,H,c)
        a = torch.cumsum(lf, dim=-1)                          # local decay
        A = a[..., -1]                                        # (B,H)
        ii32 = i_gate[..., part].float()

        # intra-chunk scores D̃[t,j] = a_t - a_j + ĩ_j (j<=t)
        dtil = a[..., :, None] - a[..., None, :] + ii32[..., None, :]
        dtil = torch.where(causal, dtil, -np.inf)
        inter_log = a + m_run[..., None]                      # (B,H,c)
        m_t = torch.maximum(dtil.amax(dim=-1), inter_log)     # (B,H,c)

        d = torch.exp(dtil - m_t[..., None])
        s = torch.einsum("bhtd,bhjd->bhtj", qq32, kk32) * scale
        sd = s * d
        num_intra = torch.einsum("bhtj,bhjd->bhtd", sd, vv32)
        den_intra = sd.sum(dim=-1)

        w_inter = torch.exp(inter_log - m_t)                  # (B,H,c)
        num_inter = torch.einsum("bhde,bhte->bhtd", C, qq32) \
            * w_inter[..., None]
        den_inter = torch.einsum("bhd,bhtd->bht", n, qq32) * w_inter

        denom = torch.maximum((den_intra + den_inter).abs(),
                              torch.exp(-m_t))
        outs.append(((num_intra + num_inter) / denom[..., None])
                    .to(q.dtype))

        # state update to the chunk's end
        bj = A[..., None] - a + ii32                          # (B,H,c)
        m_new = torch.maximum(m_run + A, bj.amax(dim=-1))
        w_old = torch.exp(m_run + A - m_new)
        wj = torch.exp(bj - m_new[..., None])
        kfs = kk32 * scale
        C = w_old[..., None, None] * C \
            + torch.einsum("bhj,bhjd,bhje->bhde", wj, vv32, kfs)
        n = w_old[..., None] * n + torch.einsum("bhj,bhjd->bhd", wj, kfs)
        m_run = m_new
    return torch.cat(outs, dim=2), MLSTMState(c=C, n=n, m=m_run)


def _mlstm_step(q, k, v, i_gate, f_gate, state: MLSTMState):
    """One decode step.  q,k,v: (B,H,hd); gates: (B,H)."""
    hd = q.shape[-1]
    logf = _log_sigmoid(f_gate.float())
    m_new = torch.maximum(logf + state.m, i_gate.float())
    f_p = torch.exp(logf + state.m - m_new)
    i_p = torch.exp(i_gate.float() - m_new)
    kf = k.float() / float(np.float32(np.sqrt(hd)))
    c = f_p[..., None, None] * state.c \
        + i_p[..., None, None] * torch.einsum("bhd,bhe->bhde", v.float(), kf)
    n = f_p[..., None] * state.n + i_p[..., None] * kf
    num = torch.einsum("bhde,bhe->bhd", c, q.float())
    den = torch.maximum(
        torch.einsum("bhd,bhd->bh", n, q.float()).abs()[..., None],
        torch.exp(-m_new)[..., None])
    return (num / den).to(q.dtype), MLSTMState(c=c, n=n, m=m_new)


def init_mlstm_state(cfg: ArchConfig, batch: int,
                     device="cpu") -> MLSTMState:
    di = int(cfg.mlstm_proj_factor * cfg.d_model)
    hd = di // cfg.num_heads

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return MLSTMState(c=zeros(batch, cfg.num_heads, hd, hd),
                      n=zeros(batch, cfg.num_heads, hd),
                      m=zeros(batch, cfg.num_heads))


def apply_mlstm(params, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
                state: Optional[MLSTMState] = None
                ) -> Tuple[torch.Tensor, Optional[MLSTMState]]:
    """Returns (output (B, T, d_model), the prefill / decode state or
    None)."""
    b, t, _ = x.shape
    _check_step(mode, state, t)
    heads = cfg.num_heads
    up = dense(x, params["up"])
    gate = F.silu(dense(x, params["up_gate"]))
    di = up.shape[-1]
    hd = di // heads             # the mLSTM's own head dim, not cfg.head_dim

    def split(w):
        return dense(up, w).reshape(b, t, heads, hd).transpose(1, 2)
    q, k, v = split(params["wq"]), split(params["wk"]), split(params["wv"])
    ig = dense(up, params["wi"]).transpose(1, 2)         # (B, H, T)
    fg = dense(up, params["wf"]).transpose(1, 2)

    if mode == "decode":
        h, new_state = _mlstm_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                   ig[:, :, 0], fg[:, :, 0], state)
        return dense(h.reshape(b, 1, di) * gate, params["down"]), new_state
    if t > MLSTM_CHUNK:
        h, final_state = _mlstm_chunkwise(q, k, v, ig, fg)
    else:
        h = _mlstm_parallel(q, k, v, ig, fg)             # (B,H,T,hd)
        final_state = None
        if mode == "prefill":
            _, final_state = _mlstm_chunkwise(q, k, v, ig, fg,
                                              chunk=min(t, MLSTM_CHUNK))
    new_state = final_state if mode == "prefill" else None
    out = h.transpose(1, 2).reshape(b, t, di)
    return dense(out * gate, params["down"]), new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

SLSTM_GATES = ("i", "f", "z", "o")


class SLSTMState(NamedTuple):
    c: torch.Tensor     # (B, D)
    n: torch.Tensor     # (B, D)
    h: torch.Tensor     # (B, D)
    m: torch.Tensor     # (B, D)


def init_slstm_params(gen, cfg: ArchConfig, dtype=torch.float32,
                      device="cpu"):
    d = cfg.d_model
    p = {f"w{g}": init_dense(gen, d, d, dtype, device) for g in SLSTM_GATES}
    for g in SLSTM_GATES:
        p[f"r{g}"] = init_dense(gen, d, d, dtype, device) * 0.1
    p["down"] = init_dense(gen, d, d, dtype, device)
    return p


def init_slstm_state(cfg: ArchConfig, batch: int,
                     device="cpu") -> SLSTMState:
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z, h=z, m=z)


def _slstm_cell(params, xw: Dict[str, torch.Tensor], s: SLSTMState,
                one: torch.Tensor) -> SLSTMState:
    """One step from the input products ``xw[g] = x_t @ W_g``; ``one`` is a
    0-d 1.0.  ``torch.maximum(n, one)`` splits the gradient at a tie as
    ``jnp.maximum`` does (n = 1.0 exactly at t = 0 when ĩ >= log f);
    ``clamp(min=1)`` would pass all of it to n."""
    def gate(name):
        w = xw[name]
        return (w + dense(s.h.to(w.dtype), params[f"r{name}"])).float()
    itil, ftil = gate("i"), gate("f")
    z = torch.tanh(gate("z"))
    o = torch.sigmoid(gate("o"))
    logf_m = _log_sigmoid(ftil) + s.m
    m_new = torch.maximum(logf_m, itil)
    i_p = torch.exp(itil - m_new)
    f_p = torch.exp(logf_m - m_new)
    c = f_p * s.c + i_p * z
    n = f_p * s.n + i_p
    h = o * c / torch.maximum(n, one)
    return SLSTMState(c=c, n=n, h=h, m=m_new)


def _slstm_step(params, x_t: torch.Tensor, s: SLSTMState) -> SLSTMState:
    """One step from the input ``x_t`` (B, D), as the reference's."""
    return _slstm_cell(params, {g: dense(x_t, params[f"w{g}"])
                                for g in SLSTM_GATES}, s,
                       torch.ones((), dtype=torch.float32,
                                  device=x_t.device))


def apply_slstm(params, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
                state: Optional[SLSTMState] = None
                ) -> Tuple[torch.Tensor, Optional[SLSTMState]]:
    """Returns (output (B, T, d_model), the prefill / decode state or
    None)."""
    b, t, _ = x.shape
    _check_step(mode, state, t)
    if mode == "decode":
        s = _slstm_step(params, x[:, 0], state)
        return dense(s.h[:, None].to(x.dtype), params["down"]), s
    s = init_slstm_state(cfg, b, x.device)
    # the input products for all T at once: one (B·T, d) × (d, d) a gate
    xw = {g: dense(x, params[f"w{g}"]) for g in SLSTM_GATES}
    one = torch.ones((), dtype=torch.float32, device=x.device)
    hs = []
    for i in range(t):
        s = _slstm_cell(params, {g: w[:, i] for g, w in xw.items()}, s, one)
        hs.append(s.h)
    out = torch.stack(hs, dim=1).to(x.dtype)
    new_state = s if mode == "prefill" else None
    return dense(out, params["down"]), new_state


# ---------------------------------------------------------------------------
# RG-LRU (Griffin recurrent block)
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0
_CONV_WIDTH = 4


class RGLRUState(NamedTuple):
    h: torch.Tensor       # (B, W) recurrent state
    conv: torch.Tensor    # (B, CONV_WIDTH-1, W) trailing inputs for the conv


def _uniform(gen, shape, lo: float, hi: float, device) -> torch.Tensor:
    """``U(lo, hi)`` in fp32; shapes only on ``meta``."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return u * (hi - lo) + lo


def init_rglru_params(gen, cfg: ArchConfig, dtype=torch.float32,
                      device="cpu"):
    d = cfg.d_model
    w = cfg.rglru_lru_width or d
    # Λ init so a^c stays in (0.9, 0.999) — Griffin appendix
    lam = _uniform(gen, (w,), 0.9, 0.999, device)
    lam_param = torch.log(torch.exp(-torch.log(lam) / _RGLRU_C) - 1.0)
    return {
        "in_x": init_dense(gen, d, w, dtype, device),
        "in_gate": init_dense(gen, d, w, dtype, device),
        "conv": normal(gen, (_CONV_WIDTH, w), 0.1, dtype, device),
        "w_rgate": init_dense(gen, w, w, dtype, device),
        "w_igate": init_dense(gen, w, w, dtype, device),
        "lam": lam_param.float(),
        "out": init_dense(gen, w, d, dtype, device),
    }


def init_rglru_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device="cpu") -> RGLRUState:
    w = cfg.rglru_lru_width or cfg.d_model
    return RGLRUState(
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, _CONV_WIDTH - 1, w), dtype=dtype,
                         device=device))


def _rglru_gates(params, u: torch.Tensor):
    """u: (..., W) post-conv activations → (a, gated input), float32."""
    r = torch.sigmoid(dense(u, params["w_rgate"]).float())
    i = torch.sigmoid(dense(u, params["w_igate"]).float())
    log_a = -_RGLRU_C * _softplus(params["lam"]) * r
    a = torch.exp(log_a)
    x_in = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * i * u.float()
    return a, x_in


def apply_rglru(params, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
                state: Optional[RGLRUState] = None
                ) -> Tuple[torch.Tensor, Optional[RGLRUState]]:
    """Returns (output (B, T, d_model), the prefill / decode state or
    None)."""
    b, t, _ = x.shape
    _check_step(mode, state, t)
    gate = F.gelu(dense(x, params["in_gate"]), approximate="tanh")
    u = dense(x, params["in_x"])                                  # (B, T, W)

    if mode == "decode":
        hist = torch.cat([state.conv, u], dim=1)                  # (B, 4, W)
        # a Python sum from 0, in tap order, as the prefill's
        conv = sum(hist[:, i] * params["conv"][i].to(u.dtype)
                   for i in range(_CONV_WIDTH))
        a, x_in = _rglru_gates(params, conv)
        h = a * state.h + x_in
        out = h[:, None].to(x.dtype)
        return dense(out * gate, params["out"]), RGLRUState(h=h,
                                                            conv=hist[:, 1:])

    pad = torch.zeros((b, _CONV_WIDTH - 1, u.shape[-1]), dtype=u.dtype,
                      device=u.device)
    upad = torch.cat([pad, u], dim=1)
    # a Python sum from 0, in tap order, as the reference's
    conv = sum(upad[:, i:i + t] * params["conv"][i].to(u.dtype)
               for i in range(_CONV_WIDTH))
    a, x_in = _rglru_gates(params, conv)
    h = rglru_scan(a, x_in)
    new_state = None
    if mode == "prefill":
        new_state = RGLRUState(h=h[:, -1], conv=upad[:, -(_CONV_WIDTH - 1):])
    out = h.to(x.dtype)
    return dense(out * gate, params["out"]), new_state


# ---------------------------------------------------------------------------
# Mamba-2 (granite 4.0-H; arXiv:2405.21060)
# ---------------------------------------------------------------------------


class Mamba2State(NamedTuple):
    conv: torch.Tensor    # (B, conv_dim, conv - 1) inputs before the conv
    ssm: torch.Tensor     # (B, H, P, N) state of every head, float32


def init_mamba2_params(gen, cfg: ArchConfig, dtype=torch.float32,
                       device="cpu"):
    """``in_proj`` (d, [z | x B C | dt]), the depthwise causal ``conv``
    (taps, conv_dim) and its bias, per-head ``dt_bias``, ``A_log`` and
    skip ``D``, the gated norm's scale and ``out_proj`` (inner, d).
    Decays as Mamba-2 draws them: dt log-uniform in [1e-3, 1e-1] (its
    ``dt_bias`` the inverse softplus of that), A uniform in [1, 16]."""
    d, h = cfg.d_model, cfg.mamba_heads
    inner, conv_dim = cfg.mamba_inner, cfg.mamba_conv_dim
    lo, hi = np.log(1e-3), np.log(1e-1)
    dt = torch.exp(_uniform(gen, (h,), lo, hi, device))
    return {
        "in_proj": init_dense(gen, d, inner + conv_dim + h, dtype, device),
        "conv": normal(gen, (cfg.mamba_conv, conv_dim),
                       cfg.mamba_conv ** -0.5, dtype, device),
        "conv_bias": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "A_log": torch.log(_uniform(gen, (h,), 1.0, 16.0, device)),
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "norm": torch.zeros((inner,), dtype=dtype, device=device),
        "out_proj": init_dense(gen, inner, d, dtype, device),
    }


def init_mamba2_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                      device="cpu") -> Mamba2State:
    return Mamba2State(
        conv=torch.zeros((batch, cfg.mamba_conv_dim, cfg.mamba_conv - 1),
                         dtype=dtype, device=device),
        ssm=torch.zeros((batch, cfg.mamba_heads, cfg.mamba_head_dim,
                         cfg.mamba_d_state), dtype=torch.float32,
                        device=device))


def ssd_chunked(x, dt, A, B, C, chunk: int,
                initial: Optional[torch.Tensor] = None):
    """The state-space dual (SSD) scan by chunks: per head h,
    ``S_t = exp(dt_t A_h) S_{t-1} + dt_t x_t B_t^T`` and ``y_t = S_t C_t``.

    x: (b, T, H, P); dt: (b, T, H); A: (H,); B, C: (b, T, G, N) (head h
    reads group h // (H / G)); ``initial``: (b, H, P, N) or zeros.  Returns
    y (b, T, H, P) and the last state (b, H, P, N), float32.  T is padded
    to whole chunks with dt = 0 steps, which leave the state as it is.

    Inside a chunk the output is the quadratic form ``(L o C B^T)(dt x)``
    with ``L[i, j] = exp(a_i - a_j)`` (j <= i) from the chunk's cumulative
    ``a = cumsum(dt A)``; each chunk's state passes on to the next through
    ``exp(a_last)``.  The cumulative sums and their differences are taken
    in float64, where a long chunk's sum would cancel in float32.
    """
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    r = h // g
    pad = (-t) % chunk
    if pad:
        x, dt, B, C = (F.pad(v, (0, 0) * (v.dim() - 2) + (0, pad))
                       for v in (x, dt, B, C))
    c = (t + pad) // chunk
    x = x.float().reshape(b, c, chunk, g, r, p)
    dt = dt.float().reshape(b, c, chunk, g, r)
    B = B.float().reshape(b, c, chunk, g, n)
    C = C.float().reshape(b, c, chunk, g, n)
    acum = torch.cumsum(dt.double() * A.double().reshape(g, r), dim=2)
    a = acum.permute(0, 1, 3, 4, 2)                         # (b,c,g,r,Q)
    causal = _causal(chunk, x.device)
    seg = torch.where(causal, a[..., :, None] - a[..., None, :],
                      -np.inf).float()
    L = torch.exp(seg)                                      # (b,c,g,r,Q,Q)
    xdt = x * dt[..., None]                                 # (b,c,Q,g,r,p)

    # within each chunk: (L o C B^T) (dt x)
    cb = torch.einsum("bcign,bcjgn->bcgij", C, B)
    y = torch.einsum("bcgrij,bcjgrp->bcigrp", cb[:, :, :, None] * L, xdt)

    # each chunk's own contribution to its last state, then the states
    # passed from chunk to chunk
    to_end = torch.exp((acum[:, :, -1:] - acum).float())    # (b,c,Q,g,r)
    states = torch.einsum("bcjgn,bcjgr,bcjgrp->bcgrpn", B, to_end, xdt)
    through = torch.exp(acum[:, :, -1].float())             # (b,c,g,r)
    s = torch.zeros((b, g, r, p, n), dtype=torch.float32, device=x.device) \
        if initial is None else initial.float().reshape(b, g, r, p, n)
    before = []
    for i in range(c):
        before.append(s)
        s = through[:, i, ..., None, None] * s + states[:, i]
    before = torch.stack(before, dim=1)                     # (b,c,g,r,p,n)

    # the state a chunk starts from, decayed to each of its steps
    y = y + torch.einsum("bcign,bcgrpn,bcigr->bcigrp", C, before,
                         torch.exp(acum.float()))
    y = y.reshape(b, c * chunk, h, p)[:, :t]
    return y, s.reshape(b, h, p, n)


def ssd_step(x, dt, A, B, C, state: torch.Tensor):
    """One step of the recurrence.  x: (b, H, P); dt: (b, H); B, C:
    (b, G, N); state: (b, H, P, N) → (y (b, H, P), next state)."""
    r = x.shape[1] // B.shape[1]
    Bh = B.float().repeat_interleave(r, dim=1)              # (b, H, N)
    Ch = C.float().repeat_interleave(r, dim=1)
    decay = torch.exp(dt.float() * A.float())               # (b, H)
    s = decay[..., None, None] * state \
        + (dt.float()[..., None] * x.float())[..., None] * Bh[:, :, None]
    return torch.einsum("bhpn,bhn->bhp", s, Ch), s


def apply_mamba2(params, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
                 state: Optional[Mamba2State] = None
                 ) -> Tuple[torch.Tensor, Optional[Mamba2State]]:
    """The Mamba-2 mixer: ``[z | xBC | dt] = x W_in``; ``xBC =
    silu(conv(xBC) + b)`` split into x (H heads of P), B and C (G groups
    of N); ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the SSD
    scan (train / prefill: ``ssd_chunked`` at ``cfg.mamba_chunk``; decode:
    ``ssd_step``) plus ``D x``; then ``rms(y silu(z)) W_out``.  Returns
    (output (B, T, d_model), the prefill / decode state or None)."""
    b, t, _ = x.shape
    _check_step(mode, state, t)
    h, p = cfg.mamba_heads, cfg.mamba_head_dim
    gn = cfg.mamba_groups * cfg.mamba_d_state
    inner, conv_dim, k = cfg.mamba_inner, cfg.mamba_conv_dim, cfg.mamba_conv
    with tracing.span("mamba.mixer"):
        z, xbc, dt = torch.split(dense(x, params["in_proj"]),
                                 [inner, conv_dim, h], dim=-1)
        w = params["conv"].to(xbc.dtype)
        if mode == "decode":
            hist = torch.cat([state.conv, xbc.transpose(1, 2)], dim=-1)
            # a Python sum from 0, in tap order, as the prefill's
            conv = sum(hist[..., i] * w[i] for i in range(k))[:, None]
            new_conv = hist[..., 1:]
        else:
            upad = F.pad(xbc, (0, 0, k - 1, 0))
            conv = sum(upad[:, i:i + t] * w[i] for i in range(k))
            new_conv = upad[:, t:].transpose(1, 2)
        xbc = F.silu(conv + params["conv_bias"].to(xbc.dtype))
        xs, B, C = torch.split(xbc, [inner, gn, gn], dim=-1)
        xs = xs.reshape(b, t, h, p)
        B = B.reshape(b, t, cfg.mamba_groups, cfg.mamba_d_state)
        C = C.reshape(b, t, cfg.mamba_groups, cfg.mamba_d_state)
        dt = _softplus(dt.float() + params["dt_bias"].float())
        A = -torch.exp(params["A_log"].float())
        if mode == "decode":
            y, s = ssd_step(xs[:, 0], dt[:, 0], A, B[:, 0], C[:, 0],
                            state.ssm)
            y = y[:, None]
        else:
            with tracing.span("mamba.scan"):
                y, s = ssd_chunked(xs, dt, A, B, C, cfg.mamba_chunk)
        y = y + xs.float() * params["D"].float()[:, None]
        y = y.to(x.dtype).reshape(b, t, inner)
        y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
        out = dense(y, params["out_proj"])
    tracing.backward_span("mamba.backward", x, (out,))
    new_state = Mamba2State(conv=new_conv, ssm=s) \
        if mode in ("prefill", "decode") else None
    return out, new_state
