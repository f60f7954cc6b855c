"""Mixture-of-Experts FFN with capacity-bounded scatter dispatch.

Top-k routing → position-in-expert (``kernels.moe_positions``: a CUDA
kernel on the card, the one-hot cumulative count elsewhere) → scatter tokens
into an ``(E·C, d)`` dispatch buffer → batched per-expert (gated) FFN →
gather + weighted combine, step for step as the reference's
``repro.models.moe``.  Tokens beyond an expert's capacity are dropped
(their combine weight is zero).  The capacity comes from the tokens
``apply_moe`` sees: the local batch under ZeRO, one micro-batch in the
pipeline.

**The expert share.**  A device may hold a share of the experts
(``cfg.experts_first``, ``cfg.num_held_experts``), as one rank of expert
parallelism does.  The router keeps its width and routes over every
expert, each assignment's position inside its expert and the capacity are
counted over all of them, and the layer computes only its held experts'
kept assignments: an assignment to an expert held elsewhere is dropped
here, and the layer's output is the held experts' part of the whole
layer's.  The load-balance loss is the whole router's.

**Sigmoid routing** (``cfg.router_scoring == "sigmoid"``, DeepSeek-V3's
``noaux_tc`` with one group): the scores are ``sigmoid(logits)``; the
experts are the top k of the scores plus the layer's correction bias
(``params["bias"]``, which only chooses: it has no gradient path); the
weights are the chosen experts' unshifted scores over their sum, times
``cfg.routed_scaling``.  The aux loss is the Switch loss of the scores
normalised over the experts, per sequence where ``cfg.seq_aux`` says so
(the mean over the batch's sequences).  DeepSeek-V3's between-step
update of the bias is not part of the gradient step, and the port leaves
it out.

Three rules keep the port's routing the reference's, integer for integer,
and the card's result the same from run to run:

* **top-k ties**: ``jax.lax.top_k`` puts the lower index first among equal
  values; ``torch.topk`` promises no order.  The top k come from a stable
  descending ``torch.sort`` instead.
* **the dispatch adds**: a dropped assignment points at slot ``e·C + 0``,
  which is also the slot of expert e's first kept token, so the scatter is
  an ``index_add`` into zeros with the dropped rows zeroed first; a plain
  indexed store would let a dropped zero overwrite a kept row.  (An
  assignment to an expert held elsewhere points at slot 0.)
* **order-free atomics**: on CUDA the scatter and the gather's backward add
  through atomics.  Every extra contribution to a slot is an exact zero
  (dropped rows are weighted by ``keep``, as in the reference), so the sum
  is the same bits in any order.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.moe_positions import moe_positions
from repro_torch.models.layers import activation_fn, dense, init_dense


def expert_capacity(num_tokens: int, cfg: ArchConfig) -> int:
    cap = int(num_tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(cap, cfg.top_k)


def init_moe_params(gen, cfg: ArchConfig, dtype=torch.float32,
                    device="cpu"):
    """``router (d, E)``, ``up (E', d, f)``, ``down (E', f, d)`` and, when
    gated, ``gate (E', d, f)``, for the E' experts held; each expert draws
    its own ``init_dense``.  Sigmoid routing adds the correction ``bias
    (E,)``, zeros (DeepSeek-V3's initial value)."""
    e, d, f = cfg.num_held_experts, cfg.d_model, cfg.d_ff

    def expert_stack(din, dout):
        return torch.stack([init_dense(gen, din, dout, dtype, device)
                            for _ in range(e)])
    p = {"router": init_dense(gen, d, cfg.num_experts, dtype, device),
         "up": expert_stack(d, f),
         "down": expert_stack(f, d)}
    if cfg.gated_mlp:
        p["gate"] = expert_stack(d, f)
    if cfg.router_scoring == "sigmoid":
        p["bias"] = torch.zeros((cfg.num_experts,), dtype=dtype,
                                device=device)
    return p


def router_load_balance_loss(probs: torch.Tensor, expert_idx: torch.Tensor,
                             num_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * Σ_e fraction_e · mean_prob_e."""
    counts = F.one_hot(expert_idx, num_experts).float().sum(dim=(0, 1))
    frac = counts / torch.clamp(counts.sum(), min=1.0)
    mean_prob = probs.mean(dim=0)
    return num_experts * (frac * mean_prob).sum()


def sequence_load_balance_loss(probs: torch.Tensor, expert_idx: torch.Tensor,
                               num_experts: int, batch: int) -> torch.Tensor:
    """The Switch loss of each of ``batch`` sequences (``probs (B T, E)``,
    ``expert_idx (B T, k)``, sequence-major), their mean."""
    counts = F.one_hot(expert_idx.reshape(batch, -1), num_experts).float() \
        .sum(dim=1)                                             # (B, E)
    frac = counts / torch.clamp(counts.sum(dim=-1, keepdim=True), min=1.0)
    mean_prob = probs.reshape(batch, -1, num_experts).mean(dim=1)
    return (num_experts * (frac * mean_prob).sum(dim=-1)).mean()


class Routing(NamedTuple):
    top_p: torch.Tensor     # (N, k) renormalised routing weights
    top_e: torch.Tensor     # (N, k) int64 chosen experts, best first
    slot: torch.Tensor      # (N·k,) int64 row of the dispatch buffer
    keep: torch.Tensor      # (N·k,) bool: held here, within capacity


def route(probs: torch.Tensor, cfg: ArchConfig, cap: int) -> Routing:
    """Top-k of ``probs (N, E)`` (ties: the lower expert first), then each
    assignment's position inside its expert in assignment-major order; the
    dispatch rows are the held experts' (``E' x cap``)."""
    e, k = cfg.num_experts, cfg.top_k
    with tracing.span("moe.route"):
        top_p, top_e = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        top_p, top_e = top_p[:, :k], top_e[:, :k]
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
        flat_e = top_e.reshape(-1)                              # (N·k,)
        slot, keep = moe_positions(flat_e, e, cfg.experts_first,
                                   cfg.num_held_experts, cap)
    if tracing.recording():
        local = flat_e - cfg.experts_first
        held = (local >= 0) & (local < cfg.num_held_experts)
        tracing.count("moe.routed", keep.numel())
        tracing.count("moe.assignments", held.sum())
        tracing.count("moe.kept", keep.sum())
    return Routing(top_p, top_e, slot, keep)


def apply_moe(params, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) → (output, aux_loss): the held experts' part of the
    layer's output, the whole router's aux."""
    b, t, d = x.shape
    n = b * t
    e, k = cfg.num_held_experts, cfg.top_k
    cap = expert_capacity(n, cfg)
    xf = x.reshape(n, d)

    logits = dense(xf, params["router"]).float()                # (N, E)
    if cfg.router_scoring == "sigmoid":
        scores = torch.sigmoid(logits)
        r = route((scores + params["bias"].float()).detach(), cfg, cap)
        top_p = scores.gather(1, r.top_e)
        top_p = top_p / top_p.sum(dim=-1, keepdim=True) * cfg.routed_scaling
        probs = scores / scores.sum(dim=-1, keepdim=True)
    else:
        probs = torch.softmax(logits, dim=-1)
        r = route(probs, cfg, cap)
        top_p = r.top_p
    top_p = top_p.to(x.dtype)

    # scatter tokens into the dispatch buffer (dropped rows add zeros)
    src = torch.where(r.keep[:, None], xf.repeat_interleave(k, dim=0), 0.0)
    buf = torch.zeros((e * cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, r.slot, src).reshape(e, cap, d)

    # batched per-expert (gated) FFN
    act = activation_fn(cfg.activation)
    up = torch.einsum("ecd,edf->ecf", buf, params["up"].to(x.dtype))
    if "gate" in params:
        up = act(torch.einsum("ecd,edf->ecf", buf,
                              params["gate"].to(x.dtype))) * up
    else:
        up = act(up)
    out_buf = torch.einsum("ecf,efd->ecd", up, params["down"].to(x.dtype))
    out_buf = out_buf.reshape(e * cap, d)

    # gather back and combine with the routing weights (dropped → 0)
    gathered = out_buf.index_select(0, r.slot)                  # (N·k, d)
    w = top_p.reshape(-1) * r.keep.to(x.dtype)
    combined = (gathered * w[:, None]).reshape(n, k, d).sum(dim=1)

    aux = sequence_load_balance_loss(probs, r.top_e, cfg.num_experts, b) \
        if cfg.seq_aux else \
        router_load_balance_loss(probs, r.top_e, cfg.num_experts)
    out = combined.reshape(b, t, d)
    tracing.backward_span("moe.backward", x, (out, aux))
    return out, aux
