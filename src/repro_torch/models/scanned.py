"""The stacked-layer model: parameters stacked along a group axis.

The canonical model stores one parameter tree per layer (the view DynaComm
schedules over).  This module gives the reference's production layout
beside it: the layer pattern (period p) tiles the stack, the p trees of
each full period are stacked along a leading group axis
(``stack/<j>/...``, the paths the sharding rules and checkpoint keys
read), and the remainder (``num_layers mod p`` layers) stays unrolled.

Where the reference scans over groups (``lax.scan``), the port loops over
them eagerly.  The stacked leaves are split into per-group views once
(``torch.unbind``, whose backward stacks the groups' gradients without
adding zeros to them), so a group runs the same blocks on the same values
as ``model.forward``, and the logits, the loss and every unstacked
gradient equal the unrolled model's bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as blocks_lib
from repro_torch.models import model as model_lib


def group_count(cfg: ArchConfig) -> Tuple[int, int]:
    """(full periods of the layer pattern, remainder layers)."""
    p = len(cfg.layer_pattern)
    return cfg.num_layers // p, cfg.num_layers % p


def _stack_trees(trees: List[Any]) -> Any:
    """One tree whose every leaf stacks the trees' leaves (a new axis 0)."""
    columns = zip(*(tree.leaves(t) for t in trees))
    return tree.unflatten(tree.structure(trees[0]),
                          [torch.stack(c) for c in columns])


def stack_layer_params(cfg: ArchConfig, params: Dict[str, Any]
                       ) -> Dict[str, Any]:
    """Per-layer list → ``{embed, stack: [p stacked trees], remainder,
    final}`` (the stacked leaves are new tensors)."""
    p = len(cfg.layer_pattern)
    n_groups, _ = group_count(cfg)
    stack = []
    if n_groups > 0:
        for j in range(p):
            stack.append(_stack_trees([params["layers"][i * p + j]
                                       for i in range(n_groups)]))
    return {"embed": params["embed"], "stack": stack,
            "remainder": params["layers"][n_groups * p:],
            "final": params["final"]}


def unstack_layer_params(cfg: ArchConfig, sp: Dict[str, Any]
                         ) -> Dict[str, Any]:
    """Inverse of :func:`stack_layer_params`; each layer's leaves are views
    of the stacked ones."""
    p = len(cfg.layer_pattern)
    n_groups, _ = group_count(cfg)
    layers: List[Any] = []
    for i in range(n_groups):
        for j in range(p):
            layers.append(tree.tree_map(lambda x: x[i], sp["stack"][j]))
    layers.extend(sp["remainder"])
    return {"embed": sp["embed"], "layers": layers, "final": sp["final"]}


def init_stacked(cfg: ArchConfig, gen: Optional[torch.Generator] = None,
                 dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    """``init_params`` stacked (on ``meta`` it only builds shapes)."""
    return stack_layer_params(cfg, model_lib.init_params(cfg, gen, dtype,
                                                         device))


def _group_views(sp: Dict[str, Any], n_groups: int) -> List[List[Any]]:
    """``views[i][j]``: group i's tree of pattern slot j, each leaf one
    ``torch.unbind`` view of its stacked leaf."""
    views: List[List[Any]] = [[] for _ in range(n_groups)]
    for stacked in sp["stack"]:
        per_leaf = [torch.unbind(x) for x in tree.leaves(stacked)]
        struct = tree.structure(stacked)
        for i in range(n_groups):
            views[i].append(tree.unflatten(struct,
                                           [leaf[i] for leaf in per_leaf]))
    return views


def forward_scanned(cfg: ArchConfig, sp: Dict[str, Any],
                    batch: Dict[str, torch.Tensor], *, mode: str = "train",
                    remat: bool = True, last_only: bool = False,
                    barrier: bool = False, remat_sqrt: int = 0):
    """Returns ``(logits, caches_or_None, aux)``; train and prefill only.

    ``remat`` checkpoints each group (non-reentrant
    ``torch.utils.checkpoint``); ``remat_sqrt = r`` (train mode, ``r``
    dividing the group count) checkpoints chunks of ``r`` groups once more
    around that, so the backward keeps one input a chunk and re-runs the
    chunk.  A prefill returns ``{"scanned": (p caches, each leaf stacked
    along the group axis), "remainder": [caches]}``.

    ``barrier`` is accepted and does nothing: in the reference it stops
    XLA from hoisting a convert over the saved carries, and an eager
    program has no such hoist.  The reference's ``act_sharding`` /
    ``logits_sharding`` placement constraints have no eager counterpart
    and are not taken.
    """
    del barrier
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward_scanned runs train or prefill, got "
                         f"{mode!r}")
    pattern = cfg.layer_pattern
    n_groups, _ = group_count(cfg)
    x = model_lib.apply_embed(cfg, sp["embed"], batch)
    # a running sum in layer order, as model.forward adds the aux terms
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def group_body(h, aux, trees):
        caches = []
        for j, kind in enumerate(pattern):
            h, c, a = blocks_lib.apply_block(trees[j], h, cfg, kind,
                                             mode=mode, cache=None)
            aux = aux + a
            caches.append(c)
        return h, aux, caches

    def body(h, aux, trees):
        if remat and mode == "train":
            return checkpoint(group_body, h, aux, trees, use_reentrant=False)
        return group_body(h, aux, trees)

    views = _group_views(sp, n_groups)
    group_caches: List[List[Any]] = []
    if n_groups and remat_sqrt > 1 and n_groups % remat_sqrt == 0 \
            and mode == "train":
        def chunk(h, aux, chunk_views):
            for trees in chunk_views:
                h, aux, _ = body(h, aux, trees)
            return h, aux

        for c in range(n_groups // remat_sqrt):
            x, aux = checkpoint(chunk, x, aux,
                                views[c * remat_sqrt:(c + 1) * remat_sqrt],
                                use_reentrant=False)
    else:
        for trees in views:
            x, aux, caches = body(x, aux, trees)
            group_caches.append(caches)
    del views

    rem_caches = []
    for r, params in enumerate(sp["remainder"]):
        x, c, a = blocks_lib.apply_block(params, x, cfg,
                                         pattern[r % len(pattern)],
                                         mode=mode, cache=None)
        aux = aux + a
        rem_caches.append(c)

    if last_only:
        x = x[:, -1:]           # narrow before the (huge) vocab projection
    logits = model_lib.head_logits(cfg, sp["final"], sp["embed"], x)
    caches = None
    if mode == "prefill":
        scanned = (tuple(_stack_trees([g[j] for g in group_caches])
                         for j in range(len(pattern)))
                   if group_caches else None)
        caches = {"scanned": scanned, "remainder": rem_caches}
    return logits, caches, aux


def train_loss_scanned(cfg: ArchConfig, sp: Dict[str, Any],
                       batch: Dict[str, torch.Tensor], *,
                       aux_weight: float = 0.01, remat: bool = True,
                       barrier: bool = False,
                       remat_sqrt: int = 0) -> torch.Tensor:
    logits, _, aux = forward_scanned(cfg, sp, batch, mode="train",
                                     remat=remat, barrier=barrier,
                                     remat_sqrt=remat_sqrt)
    labels = model_lib.padded_labels(cfg, logits, batch["labels"])
    return model_lib.cross_entropy(logits, labels) + aux_weight * aux
