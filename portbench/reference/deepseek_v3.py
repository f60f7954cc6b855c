"""A DeepSeek-V3-style decoder (``deepseek_v3``: Moonlight-16B-A3B) as its
configuration file states it, in plain float32 PyTorch.

    x = embed[tokens]
    per layer:  x += mla(rms(x, norm1))
                h = rms(x, norm2)
                x += swiglu(h)                       (the leading
                                                      first_k_dense_replace)
                x += moe(h) + shared(h)              (the others)
    logits = rms(x, final_norm) @ head               (untied)

``rms(x, s) = x / sqrt(mean(x^2) + eps) * (1 + s)`` (the published norms'
weight is ``1 + s``).

Multi-head latent attention (arXiv:2405.04434), per token, H heads:
``q = h W_q``, each head ``[q_nope | q_pe]``; ``[c | k_pe] = h W_kva``,
``c = rms(c, kv_norm)``, ``[k_nope | v] = c W_kvb`` per head;
``q_pe`` and the one-head ``k_pe`` take rope (theta ``rope_theta``) on the
two halves of each rope slice; ``k = [k_nope | k_pe]`` with ``k_pe``
broadcast over the heads; ``o = softmax(q k^T / sqrt(nope + rope),
causal) v`` over the whole sequence as one matrix; ``out = o W_o``.  No
kernel, no cache, no blocks.

MoE: ``s = sigmoid(h W_r)`` over all ``num_router_experts`` experts; the
experts are the top k of ``s + b`` (b: the layer's correction bias) by a
stable descending sort (ties: the lower expert first); each chosen
expert's weight is its ``s`` over the chosen ones' sum, times
``routed_scaling_factor``.  Each expert holds at most
``C = max(int(N k capacity_factor / E), k)`` of the N tokens'
assignments in token-major order (the rest dropped); this device computes
only its share, experts ``first_local_expert`` .. ``+ n_routed_experts -
1``, and assignments to the others add nothing here.  The aux loss is the
Switch loss ``E * sum_e frac_e * mean_prob_e`` of ``s`` normalised over
the experts, per sequence (``seq_aux``), their mean, weighted by
``router_aux_loss_coef``.  The shared experts are one SwiGLU of
``n_shared_experts x moe_intermediate_size``.

Departures from the published model, each stated in the configuration
file: the capacity (the published MoE drops nothing); the correction bias
is a constant of the step (DeepSeek-V3 moves it between steps by the
sign of each expert's load error; here it stays as drawn, and as it has
no gradient path it is not among the leaves whose gradient and change are
compared); rope on halves where DeepSeek's code de-interleaves adjacent
pairs (a fixed permutation of the rope columns of ``W_q`` and ``W_kva``);
the expert share and the vocabulary slice.  The loss is the mean
cross-entropy over the slice plus the weighted aux of every MoE layer.

One thing here is taken from the program, unlike the package's other
references: where the program's top-k set of a token differs from the
reference's own only by a near-tie of ``s + b`` (within ``TIE``), the
reference takes the program's set (``settle_ties``), so that float32
roundings choosing an expert either way do not move the compared
numbers; a wider difference stays the reference's own.  A run without
the program's routing (the control) keeps its own throughout.

Parameters: a dict kind -> list (``embed``, ``head`` and ``final_norm``
are single tensors).  Latent attention and the norms are indexed by the
layer, the dense MLP's kinds (``d_gate``, ...) by the layer's place among
the dense layers, the MoE's by its place among the MoE layers.  Dense
weights are ``(in, out)``.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.granite import rms, rope, swiglu
from portbench.reference.precision import mm

Params = Dict[str, Any]
LAYER = ("norm1", "norm2", "wq", "wkv_a", "kv_norm", "wkv_b", "wo")
DENSE = ("d_gate", "d_up", "d_down")
MOE = ("router", "router_bias", "e_gate", "e_up", "e_down", "s_gate",
       "s_up", "s_down")
CONSTANT = ("router_bias",)      # no gradient path: a constant of the step


def dense_layers(cfg: Dict[str, Any]) -> int:
    return min(cfg["first_k_dense_replace"], cfg["num_hidden_layers"])


def kinds(cfg: Dict[str, Any]) -> Tuple[str, ...]:
    nd, L = dense_layers(cfg), cfg["num_hidden_layers"]
    return LAYER + (DENSE if nd else ()) + (MOE if L > nd else ())


def mla(cfg, h, wq, wkv_a, kv_norm, wkv_b, wo) -> torch.Tensor:
    b, t, _ = h.shape
    nh, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    q = mm(h, wq).view(b, t, nh, dn + dr)
    kv_a = mm(h, wkv_a)
    c = rms(kv_a[..., :r], kv_norm, cfg["rms_norm_eps"])
    k_pe = rope(kv_a[..., r:].reshape(b, t, 1, dr), cfg["rope_theta"])
    kv = mm(c, wkv_b).view(b, t, nh, dn + dv)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], cfg["rope_theta"])], -1)
    k = torch.cat([kv[..., :dn], k_pe.expand(b, t, nh, dr)], -1)
    q, k = q.transpose(1, 2), k.transpose(1, 2)             # (B, H, T, dq)
    v = kv[..., dn:].transpose(1, 2)                         # (B, H, T, dv)
    s = mm(q, k.transpose(-1, -2)) / (dn + dr) ** 0.5
    future = torch.ones(t, t, dtype=torch.bool, device=h.device).triu(1)
    s = s.masked_fill(future, float("-inf"))
    o = mm(torch.softmax(s, dim=-1), v)                     # (B, H, T, dv)
    return mm(o.transpose(1, 2).reshape(b, t, nh * dv), wo)


def capacity(cfg, n: int) -> int:
    e, k = cfg["num_router_experts"], cfg["num_experts_per_tok"]
    return max(int(n * k * cfg["capacity_factor"] / e), k)


def kept(cfg, top_e: torch.Tensor) -> torch.Tensor:
    """``(N, k)``: each assignment within its expert's capacity, counted
    in token-major order over the whole router."""
    n = top_e.shape[0]
    flat = top_e.reshape(-1)
    onehot = F.one_hot(flat, cfg["num_router_experts"])
    before = (torch.cumsum(onehot, 0) - onehot).gather(1, flat[:, None])[:, 0]
    return (before < capacity(cfg, n)).view(n, -1)


# Near-ties.  Where two experts' ``s + b`` lie within float32 roundings
# of each other at the k-th place, the program's and the reference's top
# k may differ by them, and one flipped assignment moves a token's output
# by a whole expert's share (and, past the capacity, which later token an
# expert drops).  The reference then takes the program's set for that
# token, if every expert the program chose lies at most ``TIE`` below
# every expert it passed over (by the reference's own scores); a set that
# passes over an expert by more stays the reference's own, and its gap
# shows in the check.  The program's routing of a call is the recorded
# one (``portbench/families/deepseek_v3.py::ROUTED``) whose sets agree
# with the reference's own at the most tokens; a run without records (the
# control, the tests of the reference alone) keeps its own.  At the
# Moonlight cell's size on an H100 the two sides' sets differed at 1-19
# of 212,992 token-layers a step, by gaps up to 1.3e-6 at the first step
# and 1.2e-5 at the third (the parameters apart by then by AdamW's
# normalised roundings); with the program's products at TF32 they
# differed at 4,700-22,000, of which 56-66 by gaps under 1e-5.
TIE = 1e-4
WITNESS: Dict[int, Dict[str, float]] = {}    # record index -> what it saw
_FORWARD: List[int] = []                     # the indices of one forward
_STACK: Dict[Any, Any] = {}


def _program_call(mine: torch.Tensor):
    """The index of the recorded routing that matches ``mine`` (``(N,
    k)``, each row sorted) at all but a quarter of its tokens, or None."""
    from portbench.families.deepseek_v3 import ROUTED
    if not ROUTED:
        return None
    key = (len(ROUTED), id(ROUTED[0][0]), id(ROUTED[-1][0]),
           tuple(mine.shape), mine.device)
    if key not in _STACK:
        idx = [i for i, (e, _) in enumerate(ROUTED)
               if e.shape == mine.shape and e.device == mine.device]
        _STACK.clear()
        _STACK[key] = (idx, torch.stack([ROUTED[i][0].sort(-1).values
                                         for i in idx]) if idx else None)
    idx, stack = _STACK[key]
    if not idx:
        return None
    miss = (stack != mine.to(stack.dtype)).any(-1).sum(-1)
    j = int(miss.argmin())
    return idx[j] if int(miss[j]) <= mine.shape[0] // 4 else None


def settle_ties(cfg, top_e: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The reference's top k ``top_e`` of ``z = s + b`` with the program's
    set in place of its own at each near-tie (above); what the comparison
    saw goes to ``WITNESS`` under the program's call."""
    from portbench.families.deepseek_v3 import ROUTED
    index = _program_call(top_e.sort(-1).values)
    if index is None:
        return top_e
    prog_e, prog_keep = ROUTED[index]
    prog_e = prog_e.long()
    n, e = z.shape
    differ = (prog_e.sort(-1).values != top_e.sort(-1).values).any(-1)
    chosen = torch.zeros_like(z, dtype=torch.bool).scatter_(1, prog_e, True)
    gap = z.masked_fill(chosen, -torch.inf).max(-1).values \
        - z.masked_fill(~chosen, torch.inf).min(-1).values
    adopt = differ & (gap <= TIE)
    settled = torch.where(adopt[:, None], prog_e, top_e)

    first = cfg["first_local_expert"]
    held = slice(first, first + cfg["n_routed_experts"])

    def kept_held(experts, flags):
        return torch.zeros_like(z, dtype=torch.bool).scatter_(
            1, experts, flags)[:, held]
    prog = kept_held(prog_e, prog_keep.view(n, -1))
    own = kept_held(top_e, kept(cfg, top_e))
    refused = differ & ~adopt
    WITNESS[index] = {
        "tokens": n, "differ": int(differ.sum()), "adopted": int(adopt.sum()),
        "widest_adopted": float(gap[adopt].max()) if adopt.any() else 0.0,
        "narrowest_refused": float(gap[refused].min()) if refused.any()
        else None,
        "capacity_flips": int(((prog != own) & ~differ[:, None]).sum()),
        "keep_differs_after": int((prog != kept_held(
            settled, kept(cfg, settled))).sum()),
        "held": int(chosen[:, held].sum()), "held_kept": int(prog.sum())}
    _FORWARD.append(index)
    return settled


def moe(cfg, x, router, bias, e_gate, e_up, e_down):
    """This device's experts' part of the layer's output, and the whole
    router's aux (the mean of each sequence's)."""
    b, t, d = x.shape
    xf = x.reshape(-1, d)
    n, e, k = xf.shape[0], cfg["num_router_experts"], \
        cfg["num_experts_per_tok"]
    s = torch.sigmoid(mm(xf, router))                         # (N, E)
    z = (s + bias).detach()
    top_e = settle_ties(cfg, torch.sort(z, dim=-1, descending=True,
                                        stable=True)[1][:, :k], z)
    w = s.gather(1, top_e)
    w = w / w.sum(-1, keepdim=True) * cfg["routed_scaling_factor"]
    keep = kept(cfg, top_e)
    out = torch.zeros_like(xf)
    first = cfg["first_local_expert"]
    for j in range(cfg["n_routed_experts"]):
        # an expert no kept assignment reaches still takes its (empty)
        # product, so that its weights get their zero gradient
        tok, slot = torch.nonzero((top_e == first + j) & keep, as_tuple=True)
        y = swiglu(xf[tok], e_gate[j], e_up[j], e_down[j])
        out = out.index_add(0, tok, y * w[tok, slot][:, None])
    probs = (s / s.sum(-1, keepdim=True)).view(b, t, e)
    counts = F.one_hot(top_e.reshape(-1), e).view(b, t * k, e).float() \
        .sum(1)                                                # (B, E)
    frac = counts / counts.sum(-1, keepdim=True)
    aux = (e * (frac * probs.mean(1)).sum(-1)).mean()
    return out.view(b, t, d), aux


def block(cfg, kind, x, *leaves) -> Tuple[torch.Tensor, torch.Tensor]:
    p = dict(zip(LAYER + (DENSE if kind == "dense" else MOE), leaves))
    eps = cfg["rms_norm_eps"]
    x = x + mla(cfg, rms(x, p["norm1"], eps),
                *(p[w] for w in LAYER[2:]))
    h = rms(x, p["norm2"], eps)
    if kind == "dense":
        return x + swiglu(h, p["d_gate"], p["d_up"], p["d_down"]), \
            torch.zeros((), device=x.device)
    y, aux = moe(cfg, h, p["router"], p["router_bias"], p["e_gate"],
                 p["e_up"], p["e_down"])
    y = y + swiglu(h, p["s_gate"], p["s_up"], p["s_down"])
    return x + y, aux


def _layer_leaves(cfg, params: Params) -> List[Tuple[str, List]]:
    """Each layer's kind (``dense`` or ``moe``) and leaves, in ``block``'s
    order."""
    nd, out = dense_layers(cfg), []
    for i in range(cfg["num_hidden_layers"]):
        kind, own, j = ("dense", DENSE, i) if i < nd else ("moe", MOE, i - nd)
        out.append((kind, [params[w][i] for w in LAYER]
                    + [params[w][j] for w in own]))
    return out


def hidden(cfg, params: Params, tokens: torch.Tensor,
           remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The last layer's output (before the final norm) and the summed
    aux; with ``remat`` each block is recomputed in the backward."""
    x = F.embedding(tokens, params["embed"])
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
    return mm(rms(x, params["final_norm"], cfg["rms_norm_eps"]),
              params["head"])


def witness_line(indices: List[int]) -> str:
    """What the routing's comparison saw in the program's calls
    ``indices`` (one forward), on one line."""
    w = [WITNESS[i] for i in indices]

    def total(key):
        return sum(x[key] for x in w)
    refused = [x["narrowest_refused"] for x in w
               if x["narrowest_refused"] is not None]
    return (f"reference routing against the program's, {len(w)} MoE "
            f"calls: top-k sets differ at {total('differ')} of "
            f"{total('tokens')} tokens, {total('adopted')} decided as the "
            f"program did (gaps of s + b up to "
            f"{max(x['widest_adopted'] for x in w):.3g}, TIE {TIE:g}), "
            f"{total('differ') - total('adopted')} not (the narrowest gap "
            f"{min(refused) if refused else None}); "
            f"{total('capacity_flips')} capacity flips at tokens whose sets "
            f"agree; keep flags differing after: "
            f"{total('keep_differs_after')}; the program's held "
            f"assignments kept: "
            f"{100.0 * total('held_kept') / max(total('held'), 1):.2f}%")


def loss(cfg, params: Params, tokens, labels,
         remat: bool = True) -> torch.Tensor:
    _FORWARD.clear()
    x, aux = hidden(cfg, params, tokens, remat=remat)
    if _FORWARD:
        print(witness_line(list(_FORWARD)), file=sys.stderr, flush=True)
    logits = head(cfg, params, x)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         labels.reshape(-1))
    return ce + cfg.get("router_aux_loss_coef", 0.0) * aux


def params_from_stacked(cfg, stacked: Dict[str, torch.Tensor],
                        grad: bool = False) -> Params:
    """Copies of the drawn weights, one tensor per layer and kind; the
    correction bias never requires a gradient."""
    def own(x, k=None):
        x = x.clone()
        return x.requires_grad_() if grad and k not in CONSTANT else x
    out: Params = {k: own(stacked[k]) for k in ("embed", "head",
                                                 "final_norm")}
    for k in kinds(cfg):
        out[k] = [own(x, k) for x in stacked[k].unbind(0)]
    return out


def leaf_items(cfg, params: Params):
    """``((kind, index), tensor)`` for every leaf a gradient reaches, in a
    fixed order (the correction bias, a constant of the step, is not
    one)."""
    for k in ("embed", "final_norm", "head"):
        yield (k, None), params[k]
    for k in sorted(kinds(cfg)):
        if k in CONSTANT:
            continue
        for j, x in enumerate(params[k]):
            yield (k, j), x
