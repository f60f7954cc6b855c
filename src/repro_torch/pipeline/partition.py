"""Stage partitioning: split a profiled model into S contiguous stages.

The pipeline analogue of the transmission DPs in :mod:`repro_torch.core.dp`:
given per-sched-layer compute loads (fc + bc — the per-micro-batch work a
stage must execute), :func:`repro_torch.core.dp.dp_partition` finds the
contiguous split minimizing the *bottleneck stage* load, which is what
bounds pipeline throughput once the fill/drain bubble is amortized.

A :class:`StagePartition` carries the explicit maps both directions —
``segments`` (stage → 1-indexed inclusive sched-layer range, the
``Segment`` convention used everywhere in ``repro_torch.core``) and
``stage_of`` (0-indexed sched layer → stage) — so the trainer, the
transfer planner, and the verifier never re-derive them inconsistently.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.costmodel import Segment, validate_forward_segments
from repro_torch.core.dp import dp_partition
from repro_torch.core.profiler import LayerProfile


@dataclasses.dataclass(frozen=True)
class StagePartition:
    """A contiguous split of ``num_layers`` sched layers into stages."""

    segments: Tuple[Segment, ...]   # stage s -> (lo, hi), 1-indexed inclusive
    loads: Tuple[float, ...]        # per-stage load (same units as input)
    bottleneck: float               # max(loads): the throughput bound

    def __post_init__(self):
        validate_forward_segments(self.segments, self.num_layers)
        if len(self.loads) != len(self.segments):
            raise ValueError("one load per stage required")

    @property
    def num_stages(self) -> int:
        return len(self.segments)

    @property
    def num_layers(self) -> int:
        return self.segments[-1][1]

    @property
    def stage_of(self) -> Tuple[int, ...]:
        """0-indexed sched layer -> stage index."""
        out = []
        for s, (lo, hi) in enumerate(self.segments):
            out.extend([s] * (hi - lo + 1))
        return tuple(out)

    def layers_of(self, stage: int) -> Tuple[int, ...]:
        """0-indexed sched layers owned by ``stage``."""
        lo, hi = self.segments[stage]
        return tuple(range(lo - 1, hi))

    @property
    def num_boundaries(self) -> int:
        return self.num_stages - 1

    def as_dict(self) -> dict:
        return {"segments": [list(s) for s in self.segments],
                "loads": list(self.loads),
                "bottleneck": self.bottleneck}


def partition_loads(loads: Sequence[float], num_stages: int) -> StagePartition:
    """Min-max contiguous partition of raw per-layer loads (DP-optimal)."""
    arr = np.asarray(loads, dtype=np.float64)
    res = dp_partition(arr, num_stages)
    pref = np.concatenate([[0.0], np.cumsum(arr)])
    stage_loads = tuple(float(pref[hi] - pref[lo - 1])
                        for lo, hi in res.segments)
    return StagePartition(segments=res.segments, loads=stage_loads,
                          bottleneck=res.bottleneck)


def partition_profiles(profiles: Sequence[LayerProfile], num_stages: int,
                       *, compute_flops_per_s: float = 1.0) -> StagePartition:
    """Balance stages by per-layer fc + bc derived from FLOP profiles.

    The load unit is seconds when ``compute_flops_per_s`` is a real rate;
    the *split* is rate-invariant (min-max argmin is scale-free), so the
    default of 1.0 partitions by raw FLOPs.
    """
    if num_stages > len(profiles):
        raise ValueError(
            f"cannot split {len(profiles)} sched layers into "
            f"{num_stages} non-empty stages")
    loads = [(p.flops_fwd + p.bwd) / compute_flops_per_s for p in profiles]
    return partition_loads(loads, num_stages)
