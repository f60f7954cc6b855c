"""Model builder: init / forward / loss over an ArchConfig (text models).

Parameter layout (the "scheduling view" DynaComm consumes), the same nested
dict as the reference's::

    params = {
      "embed":  {...}          # sched layer 0   (token table)
      "layers": [block_0, ...] # sched layers 1..L
      "final":  {...}          # sched layer L+1 (final norm + untied head)
    }

``num_sched_layers = cfg.num_layers + 2``; per-sched-layer byte counts and
FLOPs come from ``profiles.py`` and feed the DP scheduler directly.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks
from repro_torch.models.layers import (dense, embed, init_dense,
                                       init_embedding, logits_from_embedding,
                                       rms_norm, softcap)

Params = Dict[str, Any]


def _check_text(cfg: ArchConfig) -> None:
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend "
                                  f"is not ported yet (ROADMAP queue 1)")


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator] = None,
                dtype=torch.float32, device="cpu") -> Params:
    """Random parameters from ``gen`` (any generator on ``device``).

    On the ``meta`` device this only builds shapes (no ``gen`` needed).
    """
    _check_text(cfg)
    p: Params = {"embed": {}, "layers": [], "final": {}}
    p["embed"]["table"] = init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                         dtype, device)
    for kind in cfg.layer_kinds():
        p["layers"].append(blocks.init_block(gen, cfg, kind, dtype, device))
    p["final"]["norm"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                     device=device)
    if not cfg.tie_embeddings:
        p["final"]["head"] = init_dense(gen, cfg.d_model, cfg.vocab_size,
                                        dtype, device)
    return p


def _embed_inputs(cfg: ArchConfig, params: Params,
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Produce the (B, T, d) input sequence (text frontends only)."""
    _check_text(cfg)
    return embed(batch["tokens"], params["embed"]["table"])


def _head(cfg: ArchConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final"]["norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return logits_from_embedding(x, params["embed"]["table"],
                                     cfg.final_logit_softcap)
    return softcap(dense(x, params["final"]["head"]), cfg.final_logit_softcap)


def forward(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, mode: str = "train", remat: bool = False,
            last_only: bool = False
            ) -> Tuple[torch.Tensor, Optional[List[Any]], torch.Tensor]:
    """Returns (logits, new_caches_or_None, aux_loss); train / prefill."""
    x = _embed_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: List[Any] = []
    for i, kind in enumerate(cfg.layer_kinds()):
        if remat and mode == "train":
            x, c, a = checkpoint(
                lambda p, h, _k=kind: blocks.apply_block(
                    p, h, cfg, _k, mode="train"),
                params["layers"][i], x, use_reentrant=False)
        else:
            x, c, a = blocks.apply_block(params["layers"][i], x, cfg, kind,
                                         mode=mode)
        new_caches.append(c)
        aux = aux + a
    if last_only:
        x = x[:, -1:]           # narrow before the (huge) vocab projection
    logits = _head(cfg, params, x)
    return logits, (new_caches if mode == "prefill" else None), aux


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
    return cross_entropy(logits, batch["labels"]) + aux_weight * aux


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
