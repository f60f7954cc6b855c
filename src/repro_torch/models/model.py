"""Model builder: init / forward / loss over an ArchConfig.

Parameter layout (the "scheduling view" DynaComm consumes), the same nested
dict as the reference's::

    params = {
      "embed":  {...}          # sched layer 0   (token table / input proj)
      "layers": [block_0, ...] # sched layers 1..L
      "final":  {...}          # sched layer L+1 (final norm + untied head)
    }

``num_sched_layers = cfg.num_layers + 2``; per-sched-layer byte counts and
FLOPs come from ``profiles.py`` and feed the DP scheduler directly.

``forward`` runs ``train``, ``prefill`` (which also returns every block's
cache) and ``decode`` (one token against the caches: ``decode_step``,
driven by ``serve/decode.py``); ``init_caches`` gives the empty caches.

The audio frontend (hubert) takes pre-embedded frames through a learnt
``in_proj``; the vision frontend (llava) prepends the batch's
``vision_embeds`` to the token embeddings, and the loss pads the labels
with ``-1`` over them.  Both frontends are stubs (``models/frontend.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks
from repro_torch.models.layers import (dense, embed, init_dense,
                                       init_embedding, logits_from_embedding,
                                       rms_norm, softcap)

Params = Dict[str, Any]


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator] = None,
                dtype=torch.float32, device="cpu") -> Params:
    """Random parameters from ``gen`` (any generator on ``device``).

    On the ``meta`` device this only builds shapes (no ``gen`` needed).
    """
    p: Params = {"embed": {}, "layers": [], "final": {}}
    if cfg.frontend != "audio":
        p["embed"]["table"] = init_embedding(gen, cfg.vocab_size,
                                             cfg.d_model, dtype, device)
    else:
        # audio: frames arrive pre-embedded (stub frontend); learn a proj
        p["embed"]["in_proj"] = init_dense(gen, cfg.d_model, cfg.d_model,
                                           dtype, device)
    for kind, mlp in zip(cfg.layer_kinds(), cfg.mlp_kinds()):
        p["layers"].append(blocks.init_block(gen, cfg, kind, dtype, device,
                                             mlp=mlp))
    p["final"]["norm"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                     device=device)
    if not cfg.tie_embeddings:
        p["final"]["head"] = init_dense(gen, cfg.d_model, cfg.vocab_size,
                                        dtype, device)
    return p


def _embed_tokens(cfg: ArchConfig, tokens: torch.Tensor,
                  table: torch.Tensor) -> torch.Tensor:
    """The token table's rows times the embedding multiplier (by default
    float32(sqrt(d_model)))."""
    if cfg.embedding_multiplier is None:
        return embed(tokens, table)
    return embed(tokens, table, scale=False) * cfg.embedding_multiplier


# ---------------------------------------------------------------------------
# the per-sched-layer program (``forward``, the ZeRO / PS / pipeline steps
# and the measurement pass run every sched layer through these)
# ---------------------------------------------------------------------------


def apply_embed(cfg: ArchConfig, embed_tree: Any,
                batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sched layer 0: the (B, T, d) input sequence from the modality's
    batch."""
    if cfg.frontend == "audio":
        return dense(batch["frames"], embed_tree["in_proj"])
    x = _embed_tokens(cfg, batch["tokens"], embed_tree["table"])
    if cfg.frontend == "vision" and "vision_embeds" in batch:
        x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
    return x


def apply_train_block(cfg: ArchConfig, block_tree: Any, x: torch.Tensor,
                      kind: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """A middle sched layer: one block in train mode, ``(y, aux)``."""
    y, _, aux = blocks.apply_block(block_tree, x, cfg, kind, mode="train")
    return y, aux


def head_logits(cfg: ArchConfig, final_tree: Any, embed_tree: Any,
                x: torch.Tensor) -> torch.Tensor:
    """The final norm and the head (the embedding table when tied)."""
    x = rms_norm(x, final_tree["norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = logits_from_embedding(x, embed_tree["table"],
                                       cfg.final_logit_softcap)
    else:
        logits = softcap(dense(x, final_tree["head"]),
                         cfg.final_logit_softcap)
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return logits


def apply_final(cfg: ArchConfig, final_tree: Any, embed_tree: Any,
                x: torch.Tensor, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
    """The last sched layer: :func:`head_logits` and the masked CE (the
    labels padded with ``-1`` over prepended vision tokens)."""
    logits = head_logits(cfg, final_tree, embed_tree, x)
    return cross_entropy(logits, padded_labels(cfg, logits, batch["labels"]))


def aux_cotangent(cfg: ArchConfig, layer: int,
                  aux_ct: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The cotangent of sched layer ``layer``'s aux in :func:`layer_vjp`:
    ``aux_ct`` where the block routes to experts, ``None`` where it has a
    dense MLP (its aux is a constant zero, which carries no graph)."""
    return aux_ct if cfg.mlp_kinds()[layer - 1] == "moe" else None


def layer_vjp(fn: Callable, primals: Sequence[Any], cotangent) -> List[Any]:
    """Recompute ``fn(*primals)`` under autograd and pull ``cotangent``
    back to every primal tree (zeros where a primal is unused).

    ``fn`` may return a tuple of tensors, pulled back with a tuple of
    cotangents, as ``jax.vjp`` does.  A cotangent of ``None`` leaves its
    output out: a dense block's aux is a constant zero with no graph,
    which ``torch.autograd.grad`` refuses.  Every other output must carry
    a graph, or ``torch.autograd.grad`` raises: an MoE aux that lost its
    graph fails loudly instead of dropping the router's term."""
    vars_ = [tree.tree_map(lambda x: x.detach().requires_grad_(), p)
             for p in primals]
    with torch.enable_grad():
        out = fn(*vars_)
    if isinstance(out, tuple):
        pairs = [(o, c) for o, c in zip(out, cotangent) if c is not None]
        out = [o for o, _ in pairs]
        cotangent = [c for _, c in pairs]
    flat = [leaf for v in vars_ for leaf in tree.leaves(v)]
    grads = list(torch.autograd.grad(out, flat, grad_outputs=cotangent,
                                     allow_unused=True,
                                     materialize_grads=True))
    result, i = [], 0
    for v in vars_:
        n = len(tree.leaves(v))
        result.append(tree.unflatten(tree.structure(v), grads[i:i + n]))
        i += n
    return result


def forward(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, mode: str = "train", caches: Optional[List[Any]] = None,
            remat: bool = False, last_only: bool = False
            ) -> Tuple[torch.Tensor, Optional[List[Any]], torch.Tensor]:
    """Returns (logits, new_caches_or_None, aux_loss).

    ``decode`` embeds ``batch["token"]`` (B, 1) and steps every block from
    ``caches`` (a KV cache is written in place: ``models/attention.py``)."""
    if mode == "decode":
        if cfg.frontend == "audio":
            raise ValueError("encoder-only model has no decode mode")
        x = _embed_tokens(cfg, batch["token"], params["embed"]["table"])
    else:
        x = apply_embed(cfg, params["embed"], batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: List[Any] = []
    for i, kind in enumerate(cfg.layer_kinds()):
        if remat and mode == "train":
            x, c, a = checkpoint(
                lambda p, h, _k=kind: blocks.apply_block(
                    p, h, cfg, _k, mode="train"),
                params["layers"][i], x, use_reentrant=False)
        else:
            x, c, a = blocks.apply_block(
                params["layers"][i], x, cfg, kind, mode=mode,
                cache=None if caches is None else caches[i])
        new_caches.append(c)
        aux = aux + a
    if last_only:
        x = x[:, -1:]           # narrow before the (huge) vocab projection
    logits = head_logits(cfg, params["final"], params["embed"], x)
    out_caches = new_caches if mode in ("prefill", "decode") else None
    return logits, out_caches, aux


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.float32, device="cpu") -> List[Any]:
    """Every block's empty decode state (``blocks.init_block_cache``)."""
    return [blocks.init_block_cache(cfg, kind, batch, max_len, dtype, device)
            for kind in cfg.layer_kinds()]


def decode_step(cfg: ArchConfig, params: Params, token: torch.Tensor,
                caches: List[Any]) -> Tuple[torch.Tensor, List[Any]]:
    """serve_step: one token (B, 1) against the caches → (logits (B, 1, V),
    caches)."""
    logits, new_caches, _ = forward(cfg, params, {"token": token},
                                    mode="decode", caches=caches)
    return logits, new_caches


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over positions with label >= 0."""
    labels = labels.long()
    mask = (labels >= 0).float()
    safe = labels.clamp(min=0)
    x = logits.float()
    m = x.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(x - m).sum(dim=-1)) + m[..., 0]
    picked = x.gather(-1, safe[..., None])[..., 0]
    return ((lse - picked) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def train_loss(cfg: ArchConfig, params: Params,
               batch: Dict[str, torch.Tensor], *, aux_weight: float = 0.01,
               remat: bool = False) -> torch.Tensor:
    logits, _, aux = forward(cfg, params, batch, mode="train", remat=remat)
    return cross_entropy(logits, padded_labels(cfg, logits, batch["labels"])
                         ) + aux_weight * aux


def padded_labels(cfg: ArchConfig, logits: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """``labels`` with ``-1`` (ignored) over the vision tokens that the
    vision frontend prepends: as many as ``logits`` has positions more."""
    if cfg.frontend != "vision":
        return labels
    nv = logits.shape[1] - labels.shape[1]
    pad = torch.full(labels.shape[:1] + (nv,), -1, dtype=labels.dtype,
                     device=labels.device)
    return torch.cat([pad, labels], dim=1)


# ---------------------------------------------------------------------------
# scheduling view
# ---------------------------------------------------------------------------


def num_sched_layers(cfg: ArchConfig) -> int:
    return cfg.num_layers + 2


def sched_layer_trees(params: Params) -> List[Any]:
    """Per-sched-layer parameter trees (embed, blocks..., final)."""
    return [params["embed"], *params["layers"], params["final"]]


def params_from_sched_layers(trees: List[Any]) -> Params:
    return {"embed": trees[0], "layers": list(trees[1:-1]), "final": trees[-1]}


def tree_bytes(t) -> int:
    return sum(x.numel() * x.element_size() for x in tree.leaves(t))


def param_shapes(cfg: ArchConfig, dtype=torch.float32) -> Params:
    """The parameter tree on the ``meta`` device: shapes, no allocation."""
    return init_params(cfg, None, dtype, "meta")


def sched_layer_bytes(cfg: ArchConfig, dtype=torch.float32) -> List[int]:
    """Per-sched-layer parameter bytes (no allocation)."""
    return [tree_bytes(t) for t in sched_layer_trees(param_shapes(cfg, dtype))]


def param_count(cfg: ArchConfig) -> int:
    return sum(x.numel() for x in tree.leaves(param_shapes(cfg)))
