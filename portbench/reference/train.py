"""The reference's first training steps: loss, gradients and AdamW.

``run`` follows ``len(batches)`` steps from the drawn weights and returns
what the check compares: each step's loss, every leaf's gradient norm at
the first step, and every leaf's change after the last step.  Each block
is recomputed in the backward (``torch.utils.checkpoint``), so the
full-width model's activations fit beside its weights, both AdamW moments
and the gradients.

AdamW's ``b1``, ``b2`` and ``eps`` are the port's
(``repro_torch.optim.adamw``'s defaults: its runtime takes only the
learning rate), with no weight decay.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from portbench import reference
from portbench.reference.precision import precision


B1, B2, EPS = 0.9, 0.999, 1e-8


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x, dtype=torch.float64))


def run(cfg: Dict[str, Any], stacked: Dict[str, torch.Tensor],
        batches: Sequence[Dict[str, torch.Tensor]], lr: float,
        mode: str = "fp32") -> Dict[str, Any]:
    """``lr``: AdamW's learning rate.  ``mode``: the products' precision
    (``fp32``; the control: ``tf32``)."""
    device = stacked["embed"].device
    model = reference.of(cfg)
    params = model.params_from_stacked(cfg, stacked, grad=True)
    items = list(model.leaf_items(cfg, params))
    leaves = [x for _, x in items]
    m = [torch.zeros_like(x) for x in leaves]
    v = [torch.zeros_like(x) for x in leaves]
    losses: List[float] = []
    grad_norms: Dict[Any, float] = {}
    with precision(mode, device):
        for step, batch in enumerate(batches, start=1):
            loss = model.loss(cfg, params, batch["tokens"],
                              batch["labels"])
            grads = torch.autograd.grad(loss, leaves)
            losses.append(float(loss.detach()))
            if step == 1:
                grad_norms = {leaf: norm(g)
                              for (leaf, _), g in zip(items, grads)}
            b1c, b2c = 1.0 - B1 ** step, 1.0 - B2 ** step
            with torch.no_grad():
                for p, g, mi, vi in zip(leaves, grads, m, v):
                    mi.mul_(B1).add_(g, alpha=1.0 - B1)
                    vi.mul_(B2).addcmul_(g, g, value=1.0 - B2)
                    p.sub_(lr * ((mi / b1c) / ((vi / b2c).sqrt() + EPS)))
            del grads, loss
    del m, v
    change = {}
    with torch.no_grad():
        for leaf, p in items:
            change[leaf] = norm(p - _drawn(stacked, leaf))
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def _drawn(stacked, leaf) -> torch.Tensor:
    kind, layer = leaf
    return stacked[kind] if layer is None else stacked[kind][layer]
