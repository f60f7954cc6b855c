"""Decision → collective-bucket mapping.

The TPU-native integration: a forward decision's segments become parameter
**all-gather buckets** (the "pull"), a backward decision's segments become
gradient **reduce-scatter buckets** (the "push").  This module is pure
bookkeeping — it converts 1-indexed layer segments into 0-indexed layer-id
groups the distributed trainer consumes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from repro_torch.core.costmodel import (Segment, validate_backward_segments,
                                  validate_forward_segments)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Groups of 0-indexed layer ids, in launch order."""

    forward: Tuple[Tuple[int, ...], ...]   # all-gather buckets, first launched first
    backward: Tuple[Tuple[int, ...], ...]  # reduce-scatter buckets, first launched first

    @property
    def num_forward_collectives(self) -> int:
        return len(self.forward)

    @property
    def num_backward_collectives(self) -> int:
        return len(self.backward)


def plan_from_decision(fwd_segments: Sequence[Segment],
                       bwd_segments: Sequence[Segment],
                       num_layers: int) -> BucketPlan:
    validate_forward_segments(fwd_segments, num_layers)
    validate_backward_segments(bwd_segments, num_layers)
    fwd = tuple(tuple(range(lo - 1, hi)) for lo, hi in fwd_segments)
    bwd = tuple(tuple(range(hi - 1, lo - 2, -1)) for lo, hi in bwd_segments)
    return BucketPlan(forward=fwd, backward=bwd)


def decision_from_plan(plan: BucketPlan) -> Tuple[Tuple[Segment, ...],
                                                  Tuple[Segment, ...]]:
    """Inverse of :func:`plan_from_decision` — 1-indexed segments.

    Round-trips: ``decision_from_plan(plan_from_decision(f, b, L)) ==
    (f, b)`` for any valid decision."""
    if not plan.forward or not plan.backward:
        raise ValueError("plan has no buckets")
    fwd = tuple((min(b) + 1, max(b) + 1) for b in plan.forward)
    bwd = tuple((min(b) + 1, max(b) + 1) for b in plan.backward)
    L = max(hi for _, hi in fwd)
    validate_forward_segments(fwd, L)
    validate_backward_segments(bwd, L)
    return fwd, bwd


def flat_layer_order(plan_groups: Tuple[Tuple[int, ...], ...]) -> Tuple[int, ...]:
    return tuple(l for group in plan_groups for l in group)
