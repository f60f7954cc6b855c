"""The granite 4.0-H hybrid (``granitemoehybrid``) as its configuration file
states it, in plain float32 PyTorch.

    x = embed[tokens] * embedding_multiplier
    per layer:  x += residual_multiplier * mixer(rms(x, norm1))
                h = rms(x, norm2)
                x += residual_multiplier * (moe(h) + shared(h))
    logits = rms(x, final_norm) @ embed.T / logits_scaling   (tied head)

The mixer is Mamba-2 or attention, as ``layer_types`` says layer by layer.
``rms(x, s) = x / sqrt(mean(x^2) + eps) * (1 + s)`` (the published norms'
weight is ``1 + s``).

Mamba-2 (arXiv:2405.21060; the published ``GraniteMoeHybridMambaLayer``):
``[z | xBC | dt] = h W_in``; ``xBC = silu(causal depthwise conv(xBC) + b)``
split into x (H heads of P), B and C (G groups of N; head i reads group
``i // (H / G)``); ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``;
per head the state ``S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T`` gives
``y_t = S_t C_t + D x_t``; then ``rms(y * silu(z), norm) W_out``.  The scan
is the SSD's quadratic dual form over the whole sequence,
``Y = (L o C B^T)(dt x)`` with ``L[t, s] = exp(cum_t - cum_s)`` for
``s <= t`` and ``cum = cumsum(dt A)`` (float64, where a sum over thousands
of steps would cancel in float32), taken in blocks of rows, each
recomputed in the backward.  It shares no algorithm with the port's
chunked scan.

Attention: GQA without positions (NoPE), causal softmax of
``q k^T * attention_multiplier``.  MoE: softmax router over all
``num_router_experts`` experts, top-k by a stable descending sort (ties:
the lower expert first), the k weights renormalised, each expert holding at
most ``C = max(int(N k capacity_factor / E), k)`` of the N tokens'
assignments in token-major order (the rest dropped); this device computes
only its share, experts ``first_local_expert`` .. ``+ num_local_experts -
1``, and assignments to the others add nothing here.  The Switch
load-balance loss ``E * sum_e frac_e * mean_prob_e`` is the whole
router's, weighted by ``router_aux_loss_coef``.  The shared expert is a
SwiGLU of ``shared_intermediate_size``.

Departures from the published model, each stated in the configuration
file: the capacity (the published MoE drops nothing), the expert share
and the cut in depth.  The loss is the mean cross-entropy plus the
weighted aux of every layer.

Parameters: a dict kind -> list (``embed`` and ``final_norm`` are single
tensors).  A kind that only some layers have (a mixer's weights) is a
list over those layers in order: ``("wq", 0)`` is the first attention
layer's query projection, ``("in_proj", 8)`` the ninth Mamba-2 layer's.
Dense weights are ``(in, out)``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.granite import rms, swiglu
from portbench.reference.precision import mm

Params = Dict[str, Any]
COMMON = ("norm1", "norm2", "router", "e_gate", "e_up", "e_down",
          "s_gate", "s_up", "s_down")
ATTENTION = ("wq", "wk", "wv", "wo")
MAMBA = ("in_proj", "conv", "conv_bias", "dt_bias", "A_log", "D", "m_norm",
         "out_proj")
ROWS = 256                  # rows of the SSD's quadratic form at a time


def layer_types(cfg: Dict[str, Any]) -> List[str]:
    return list(cfg["layer_types"][:cfg["num_hidden_layers"]])


def mixer_kinds(kind: str) -> Tuple[str, ...]:
    return MAMBA if kind == "mamba" else ATTENTION


def kinds(cfg: Dict[str, Any]) -> Tuple[str, ...]:
    present = set(layer_types(cfg))
    return COMMON + sum((mixer_kinds(k) for k in ("attention", "mamba")
                         if k in present), ())


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------


def _ssd_rows(cum, cb, xdt, lo: int, hi: int):
    """Rows ``lo..hi-1`` of ``(L o C B^T)(dt x)``: cum (b, H, T) float64,
    cb (b, G, hi - lo, hi), xdt (b, H, T, P)."""
    b, h = cum.shape[:2]
    g = cb.shape[1]
    seg = cum[:, :, lo:hi, None] - cum[:, :, None, :hi]       # (b,H,R,hi)
    t = torch.arange(hi, device=cum.device)
    past = t[None, :] <= t[lo:hi, None]
    L = torch.exp(torch.where(past, seg, -np.inf).float())
    m = (L.view(b, g, h // g, hi - lo, hi) * cb[:, :, None]) \
        .view(b, h, hi - lo, hi)
    return mm(m, xdt[:, :, :hi])                              # (b,H,R,P)


def ssd(x, dt, A, B, C) -> torch.Tensor:
    """x (b, T, H, P), dt (b, T, H), A (H,), B and C (b, T, G, N) → y
    (b, T, H, P) without the skip: the quadratic form by rows."""
    b, t, h, p = x.shape
    cum = torch.cumsum(dt.double() * A.double(), dim=1).transpose(1, 2)
    xdt = (x * dt[..., None]).transpose(1, 2)                 # (b,H,T,P)
    Bt, Ct = B.permute(0, 2, 1, 3), C.permute(0, 2, 1, 3)     # (b,G,T,N)
    rows = []
    for lo in range(0, t, ROWS):
        hi = min(lo + ROWS, t)
        cb = mm(Ct[:, :, lo:hi], Bt[:, :, :hi].transpose(-1, -2))
        rows.append(checkpoint(_ssd_rows, cum, cb, xdt, lo, hi,
                               use_reentrant=False))
    return torch.cat(rows, dim=2).transpose(1, 2)


def mamba(cfg, x, in_proj, conv, conv_bias, dt_bias, A_log, D, m_norm,
          out_proj) -> torch.Tensor:
    b, t, _ = x.shape
    h, p = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    gn = cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    inner, k = h * p, cfg["mamba_d_conv"]
    z, xbc, dt = torch.split(mm(x, in_proj), [inner, inner + 2 * gn, h],
                             dim=-1)
    xpad = F.pad(xbc, (0, 0, k - 1, 0))
    xbc = F.silu(sum(xpad[:, i:i + t] * conv[i] for i in range(k))
                 + conv_bias)
    xs, B, C = torch.split(xbc, [inner, gn, gn], dim=-1)
    xs = xs.reshape(b, t, h, p)
    B = B.reshape(b, t, cfg["mamba_n_groups"], cfg["mamba_d_state"])
    C = C.reshape(b, t, cfg["mamba_n_groups"], cfg["mamba_d_state"])
    dt = F.softplus(dt + dt_bias)
    y = ssd(xs, dt, -torch.exp(A_log), B, C) + xs * D[:, None]
    y = rms(y.reshape(b, t, inner) * F.silu(z), m_norm, cfg["rms_norm_eps"])
    return mm(y, out_proj)


# ---------------------------------------------------------------------------
# attention, MoE, block
# ---------------------------------------------------------------------------


def attention(cfg, h, wq, wk, wv, wo) -> torch.Tensor:
    """Causal GQA without positions (NoPE)."""
    b, t, _ = h.shape
    nh, nkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    q = mm(h, wq).view(b, t, nh, hd).transpose(1, 2)        # (B, H, T, hd)
    k = mm(h, wk).view(b, t, nkv, hd).transpose(1, 2)
    v = mm(h, wv).view(b, t, nkv, hd).transpose(1, 2)
    k = k.repeat_interleave(nh // nkv, dim=1)
    v = v.repeat_interleave(nh // nkv, dim=1)
    s = mm(q, k.transpose(-1, -2)) * cfg["attention_multiplier"]
    future = torch.ones(t, t, dtype=torch.bool, device=h.device).triu(1)
    s = s.masked_fill(future, float("-inf"))
    o = mm(torch.softmax(s, dim=-1), v)
    return mm(o.transpose(1, 2).reshape(b, t, nh * hd), wo)


def capacity(cfg, n: int) -> int:
    e, k = cfg["num_router_experts"], cfg["num_experts_per_tok"]
    return max(int(n * k * cfg["capacity_factor"] / e), k)


def moe(cfg, x, router, e_gate, e_up, e_down):
    """This device's experts' part of the layer's output, and the whole
    router's aux."""
    b, t, d = x.shape
    xf = x.reshape(-1, d)
    n, e, k = xf.shape[0], cfg["num_router_experts"], \
        cfg["num_experts_per_tok"]
    probs = torch.softmax(mm(xf, router), dim=-1)             # (N, E)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    flat = top_e.reshape(-1)
    onehot = F.one_hot(flat, e)
    before = (torch.cumsum(onehot, 0) - onehot).gather(1, flat[:, None])[:, 0]
    kept = (before < capacity(cfg, n)).view(n, k)
    out = torch.zeros_like(xf)
    first = cfg["first_local_expert"]
    for j in range(cfg["num_local_experts"]):
        tok, slot = torch.nonzero((top_e == first + j) & kept, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(xf[tok], e_gate[j], e_up[j], e_down[j])
        out = out.index_add(0, tok, y * top_p[tok, slot][:, None])
    counts = onehot.float().sum(0)
    aux = e * (counts / counts.sum() * probs.mean(0)).sum()
    return out.view(b, t, d), aux


def block(cfg, kind, x, *leaves) -> Tuple[torch.Tensor, torch.Tensor]:
    p = dict(zip(COMMON + mixer_kinds(kind), leaves))
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    h = rms(x, p["norm1"], eps)
    mix = mamba if kind == "mamba" else attention
    x = x + r * mix(cfg, h, *(p[w] for w in mixer_kinds(kind)))
    h = rms(x, p["norm2"], eps)
    y, aux = moe(cfg, h, p["router"], p["e_gate"], p["e_up"], p["e_down"])
    y = y + swiglu(h, p["s_gate"], p["s_up"], p["s_down"])
    return x + r * y, aux


def _layer_leaves(cfg, params: Params) -> List[Tuple[str, List]]:
    """Each layer's kind and leaves, in ``block``'s order."""
    seen = {"mamba": 0, "attention": 0}
    out = []
    for i, kind in enumerate(layer_types(cfg)):
        j = seen[kind]
        seen[kind] += 1
        out.append((kind, [params[w][i] for w in COMMON]
                    + [params[w][j] for w in mixer_kinds(kind)]))
    return out


def hidden(cfg, params: Params, tokens: torch.Tensor,
           remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The last layer's output (before the final norm) and the summed
    aux; with ``remat`` each block is recomputed in the backward."""
    x = F.embedding(tokens, params["embed"]) * cfg["embedding_multiplier"]
    aux = torch.zeros((), device=x.device)
    for kind, leaves in _layer_leaves(cfg, params):
        if remat:
            x, a = checkpoint(lambda *a_, _k=kind: block(cfg, _k, *a_), x,
                              *leaves, use_reentrant=False)
        else:
            x, a = block(cfg, kind, x, *leaves)
        aux = aux + a
    return x, aux


def head(cfg, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = rms(x, params["final_norm"], cfg["rms_norm_eps"])
    return mm(x, params["embed"].t()) / cfg["logits_scaling"]


def loss(cfg, params: Params, tokens, labels,
         remat: bool = True) -> torch.Tensor:
    x, aux = hidden(cfg, params, tokens, remat=remat)
    logits = head(cfg, params, x)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         labels.reshape(-1))
    return ce + cfg.get("router_aux_loss_coef", 0.0) * aux


def params_from_stacked(cfg, stacked: Dict[str, torch.Tensor],
                        grad: bool = False) -> Params:
    """Copies of the drawn weights, one tensor per layer and kind."""
    def own(x):
        x = x.clone()
        return x.requires_grad_() if grad else x
    out: Params = {"embed": own(stacked["embed"]),
                   "final_norm": own(stacked["final_norm"])}
    for k in kinds(cfg):
        out[k] = [own(x) for x in stacked[k].unbind(0)]
    return out


def leaf_items(cfg, params: Params):
    """``((kind, index), tensor)`` for every leaf, in a fixed order."""
    yield ("embed", None), params["embed"]
    yield ("final_norm", None), params["final_norm"]
    for k in sorted(kinds(cfg)):
        for j, x in enumerate(params[k]):
            yield (k, j), x
