"""Inter-stage activation transfers as DynaComm-scheduled segments.

Each pipeline boundary b (stage b → stage b+1) moves M micro-batch
activation tensors forward and M activation-gradient tensors backward.
The transfer problem is *isomorphic* to the paper's push/pull problem:
chunks of the boundary tensor play the role of layers, the receiving
stage's compute plays the role of layer compute, and
``dp_forward``/``dp_backward`` decide which chunks batch into one
message (amortizing Δt) versus segment to overlap with stage compute.

The virtual :class:`~repro_torch.core.costmodel.LayerCosts` for boundary
b has ``M * chunks`` entries, one per (micro-batch, chunk):

* ``pt``/``gt`` — per-chunk activation / activation-grad wire time;
* ``fc`` — the receiving stage's per-micro-batch forward compute,
  carried by each micro-batch's *last* chunk (compute can only start
  once the whole micro-batch has arrived);
* ``bc`` — the producing stage's per-micro-batch backward compute,
  carried by each micro-batch's *first* chunk (the grad is ready once
  that compute finishes).

The *whole-tensor* baseline is a single message covering every chunk —
no overlap, one Δt — which is what a naive pipeline does.  Solves ride
the memoised :class:`~repro_torch.core.planner.Planner` seam, so repeated
boundaries (homogeneous stages) collapse to cache hits and re-plans
warm-start.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.costmodel import LayerCosts, backward_time, forward_time
from repro_torch.core.scheduler import Decision, schedule

#: virtual-layer count guard: chunks * microbatches is the DP's L
_MAX_VIRTUAL_LAYERS = 4096


def boundary_costs(activation_bytes: float, microbatches: int, *, net,
                   stage_fwd_s: float, stage_bwd_s: float,
                   chunks: int = 1) -> LayerCosts:
    """Virtual LayerCosts for one stage boundary (see module docstring).

    ``activation_bytes`` is one micro-batch's boundary tensor;
    ``stage_fwd_s`` / ``stage_bwd_s`` are the receiving stage's forward
    and producing stage's backward per-micro-batch compute seconds.
    """
    if microbatches < 1 or chunks < 1:
        raise ValueError("microbatches and chunks must be >= 1")
    n = microbatches * chunks
    if n > _MAX_VIRTUAL_LAYERS:
        raise ValueError(f"microbatches*chunks = {n} exceeds "
                         f"{_MAX_VIRTUAL_LAYERS} virtual layers")
    chunk_time = float(net.transfer_time(
        np.asarray(activation_bytes / chunks)))
    pt = np.full(n, chunk_time)
    fc = np.zeros(n)
    bc = np.zeros(n)
    fc[chunks - 1::chunks] = float(stage_fwd_s)   # last chunk of each mb
    bc[0::chunks] = float(stage_bwd_s)            # first chunk of each mb
    return LayerCosts(pt=pt, fc=fc, bc=bc, gt=pt.copy(), dt=float(net.dt))


def whole_tensor_decision(costs: LayerCosts) -> Decision:
    """The unsegmented baseline: one message per direction, no overlap."""
    L = costs.num_layers
    return ((1, L),), ((1, L),)


@dataclasses.dataclass(frozen=True)
class TransferPlan:
    """One boundary's planned transfers, segmented vs whole-tensor."""

    boundary: int
    decision: Decision          # over virtual (micro-batch, chunk) layers
    fwd_time: float             # makespan of segmented forward transfers
    bwd_time: float
    whole_fwd_time: float       # single-message baseline
    whole_bwd_time: float
    fwd_compute_s: float        # Σ fc: the no-transfer compute floor
    bwd_compute_s: float        # Σ bc
    microbatches: int
    chunks: int

    @property
    def speedup(self) -> float:
        """whole / segmented makespan (>= 1 when segmentation wins)."""
        seg = self.fwd_time + self.bwd_time
        whole = self.whole_fwd_time + self.whole_bwd_time
        return whole / seg if seg > 0 else 1.0

    @property
    def effective_waits(self) -> Tuple[float, float]:
        """Per-micro-batch effective (fwd, bwd) boundary wait seconds.

        The segmented makespan minus the pure-compute floor, amortized
        over micro-batches — what
        :func:`repro_torch.pipeline.schedule.simulate` should charge per
        boundary crossing."""
        fwd = max(0.0, self.fwd_time - self.fwd_compute_s) / self.microbatches
        bwd = max(0.0, self.bwd_time - self.bwd_compute_s) / self.microbatches
        return fwd, bwd

    @property
    def whole_waits(self) -> Tuple[float, float]:
        """Per-micro-batch waits under the whole-tensor baseline."""
        fwd = max(0.0, self.whole_fwd_time - self.fwd_compute_s) \
            / self.microbatches
        bwd = max(0.0, self.whole_bwd_time - self.bwd_compute_s) \
            / self.microbatches
        return fwd, bwd


def plan_boundary(boundary: int, costs: LayerCosts, *,
                  planner: Optional[object] = None,
                  strategy: str = "dynacomm",
                  microbatches: int, chunks: int = 1) -> TransferPlan:
    """Plan one boundary's transfers; ``planner=`` rides the memo/warm
    seams so homogeneous boundaries are one DP solve + cache hits."""
    if planner is not None:
        decision = planner.decide(costs, strategy)
    else:
        decision = schedule(costs, strategy)
    f_seg, b_seg = decision
    wf, wb = whole_tensor_decision(costs)
    return TransferPlan(
        boundary=boundary,
        decision=decision,
        fwd_time=forward_time(costs, f_seg),
        bwd_time=backward_time(costs, b_seg),
        whole_fwd_time=forward_time(costs, wf),
        whole_bwd_time=backward_time(costs, wb),
        fwd_compute_s=float(np.sum(costs.fc)),
        bwd_compute_s=float(np.sum(costs.bc)),
        microbatches=microbatches,
        chunks=chunks,
    )
