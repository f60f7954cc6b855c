"""The numbers the correctness check compares, each against its limit.

Training (program and reference from the same drawn weights and batches):

* ``loss_gap``: the largest relative gap of a checked step's loss;
* ``grad_gap``: the worst leaf's gap between the program's and the
  reference's gradient norms at the first step, the program's read from
  its AdamW state after that step (``m_1 = (1 - b1) g_1``);
* ``change_gap``: the worst leaf's gap between the norms of the
  parameters' change over the checked steps.

A leaf's gap is ``|norm_program - norm_reference|`` over the larger of
the reference's norm of that leaf and of the median leaf (some gradients
are all but zero).  Leaves whose reference gradient is under a thousandth
of the median leaf's move under AdamW by round-off alone: they are left
out of ``change_gap`` by that rule, never by name.

Serving (the reference's full forward over each sampled request's prompt
and served tokens):

* ``token_gap``: the widest gap by which a served token's reference logit
  lies below the reference's best at that position;
* ``logit_gap``: the largest distance between the program's logit of a
  served token (its greedy best) and the reference's logit of it.
"""

from __future__ import annotations

import math
import statistics
from typing import Any, Dict, Iterable, Optional, Tuple

SKIP_BELOW = 1e-3          # of the median leaf's reference gradient norm


def rel_gap(got: float, want: float) -> float:
    if not math.isfinite(got):
        return math.inf
    return abs(got - want) / max(abs(want), 1e-30)


def leaf_gaps(got: Dict[Any, float], want: Dict[Any, float],
              leaves: Optional[Iterable[Any]] = None) -> Dict[Any, float]:
    """Each leaf's gap."""
    keys = list(want if leaves is None else leaves)
    scale = statistics.median(want[k] for k in keys)
    out = {}
    for k in keys:
        g = got.get(k, math.nan)
        out[k] = abs(g - want[k]) / max(want[k], scale, 1e-30) \
            if math.isfinite(g) else math.inf
    return out


def moving_leaves(ref_grads: Dict[Any, float]):
    """The leaves whose reference gradient is not nought to rounding."""
    floor = SKIP_BELOW * statistics.median(ref_grads.values())
    return [k for k, g in ref_grads.items() if g >= floor]


def train_numbers(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict:
    """Every training number a limits file may name (``loss_gap``,
    ``loss_gap_first``: the first step's alone, ``grad_gap``,
    ``grad_gap_median``, ``change_gap``, ``change_gap_median``: the median
    leaf's) and, under ``where``, each step's loss gap and the worst
    leaves."""
    steps = [rel_gap(a, b) for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        steps = [math.inf]
    grads = leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    moving = moving_leaves(ref["grad_norms"])
    change = leaf_gaps(prog["change_norms"], ref["change_norms"], moving)

    def worst(gaps, n=4):
        return [[str(k), gaps[k]] for k in sorted(gaps, key=gaps.get,
                                                  reverse=True)[:n]]
    return {"loss_gap": max(steps), "loss_gap_first": steps[0],
            "grad_gap": max(grads.values()),
            "grad_gap_median": statistics.median(grads.values()),
            "change_gap": max(change.values()),
            "change_gap_median": statistics.median(change.values()),
            "where": {"loss_gaps": steps, "grad_gap": worst(grads),
                      "change_gap": worst(change),
                      "left_out_of_change_gap":
                          len(ref["grad_norms"]) - len(moving)}}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number within its limit, {name: {value, limit}})."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        out[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, out
