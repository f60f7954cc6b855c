"""Cost model for layer-wise communication scheduling (DynaComm, JSAC'21).

Implements the paper's Section III formulation:

* every iteration is four procedures ``[pt, fc, bc, gt]`` decomposable into
  L per-layer mini-procedures;
* a *decision* partitions the L layers into contiguous transmission segments
  (forward: increasing layer order for parameter pulls; backward: decreasing
  layer order for gradient pushes);
* every transmission mini-procedure pays a fixed overhead ``dt`` (the paper's
  ``Δt``);
* ``f_m`` evaluates the end-to-end time of a decision in O(L) (the paper's
  "approximate cost measurement function", eq. 8).

Layers are 1-indexed in the paper; here cost vectors are 0-indexed numpy
arrays where index ``l-1`` holds layer ``l``'s cost.  Decisions are stored in
the canonical *segment* form — the zero-one vectors ``p`` / ``g`` of the
paper's ZOIP formulation are provided as conversions.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

Segment = Tuple[int, int]  # (lo, hi) 1-indexed inclusive layer range


@dataclasses.dataclass(frozen=True)
class LayerCosts:
    """Per-layer cost vectors and the per-transmission overhead Δt.

    pt: parameter-transmission cost per layer (seconds)
    fc: forward-computation cost per layer
    bc: backward-computation cost per layer
    gt: gradient-transmission cost per layer
    dt: fixed overhead per transmission mini-procedure (Δt)
    dt_bwd: optional distinct Δt for the backward (push) direction — an
        asymmetric link (parameter-server downlink vs uplink) pays different
        setup costs per direction.  ``None`` means symmetric (= ``dt``).
    """

    pt: np.ndarray
    fc: np.ndarray
    bc: np.ndarray
    gt: np.ndarray
    dt: float
    dt_bwd: float | None = None

    def __post_init__(self):
        for name in ("pt", "fc", "bc", "gt"):
            arr = np.asarray(getattr(self, name), dtype=np.float64)
            object.__setattr__(self, name, arr)
            if arr.ndim != 1:
                raise ValueError(f"{name} must be 1-D, got shape {arr.shape}")
            if arr.shape[0] != self.pt.shape[0]:
                raise ValueError("all cost vectors must share length L")
            if np.any(arr < 0):
                raise ValueError(f"{name} has negative costs")
        if self.dt < 0:
            raise ValueError("dt must be non-negative")
        if self.dt_bwd is not None and self.dt_bwd < 0:
            raise ValueError("dt_bwd must be non-negative")

    @property
    def num_layers(self) -> int:
        return int(self.pt.shape[0])

    @property
    def dt_push(self) -> float:
        """Δt of a gradient push (backward direction); ``dt`` if symmetric."""
        return self.dt if self.dt_bwd is None else self.dt_bwd

    @property
    def idle_window(self) -> float:
        """The Δt + gt¹ window (paper Table I): while layer 1's gradient
        push — always the last transmission of an iteration — is in
        flight, the worker's compute is idle and the forward scheduler for
        iteration i+1 can run hidden."""
        return self.dt_push + float(self.gt[0])

    def scaled(self, *, compute: float = 1.0, comm: float = 1.0,
               dt: float | None = None,
               dt_bwd: float | None = None) -> "LayerCosts":
        """Return a copy with compute / communication costs rescaled.

        Used by the sensitivity studies (paper Fig. 9): ``compute`` scales
        fc/bc (∝ batch size), ``comm`` scales pt/gt (∝ 1/bandwidth).

        Overriding ``dt`` alone yields a *symmetric* copy (any ``dt_bwd``
        of the original is dropped — the Δt sweeps study one overhead
        knob); pass ``dt_bwd`` too to set the push direction explicitly.
        """
        if dt_bwd is not None and dt is None:
            raise ValueError("dt_bwd override requires dt")
        return LayerCosts(
            pt=self.pt * comm,
            fc=self.fc * compute,
            bc=self.bc * compute,
            gt=self.gt * comm,
            dt=self.dt if dt is None else dt,
            dt_bwd=self.dt_bwd if dt is None else dt_bwd,
        )

    def compressed(self, *, gt_ratio: float = 1.0, pt_ratio: float = 1.0,
                   dt_bwd_extra: float = 0.0) -> "LayerCosts":
        """Costs under wire compression: transmissions shrink by the given
        ratios (compute untouched) while every push pays an extra
        per-segment header cost ``dt_bwd_extra`` (e.g. top-k index/length
        metadata), folded into Δt of the backward direction.

        This is the generic ratio view for sweeps and property tests;
        ``PSTopology.topology_costs(..., compressor=)`` computes the exact
        per-layer wire bytes instead.
        """
        for name, ratio in (("gt_ratio", gt_ratio), ("pt_ratio", pt_ratio)):
            if not 0.0 < ratio <= 1.0:
                raise ValueError(f"{name} must be in (0, 1], got {ratio}")
        if dt_bwd_extra < 0:
            raise ValueError("dt_bwd_extra must be non-negative")
        return LayerCosts(
            pt=self.pt * pt_ratio,
            fc=self.fc,
            bc=self.bc,
            gt=self.gt * gt_ratio,
            dt=self.dt,
            dt_bwd=self.dt_push + dt_bwd_extra,
        )


# ---------------------------------------------------------------------------
# Decision representations
# ---------------------------------------------------------------------------


def validate_forward_segments(segments: Sequence[Segment], L: int) -> None:
    """Forward segments must tile [1..L] in increasing order."""
    if not segments:
        raise ValueError("empty decision")
    expect = 1
    for lo, hi in segments:
        if lo != expect or hi < lo:
            raise ValueError(f"invalid forward segments {segments} for L={L}")
        expect = hi + 1
    if expect != L + 1:
        raise ValueError(f"forward segments {segments} do not cover 1..{L}")


def validate_backward_segments(segments: Sequence[Segment], L: int) -> None:
    """Backward segments must tile [L..1] in decreasing order.

    Stored as (lo, hi) inclusive; transmission order is the list order, so
    the first element contains layer L and the last contains layer 1.
    """
    if not segments:
        raise ValueError("empty decision")
    expect = L
    for lo, hi in segments:
        if hi != expect or hi < lo:
            raise ValueError(f"invalid backward segments {segments} for L={L}")
        expect = lo - 1
    if expect != 0:
        raise ValueError(f"backward segments {segments} do not cover {L}..1")


def forward_segments_from_p(p: Sequence[int]) -> Tuple[Segment, ...]:
    """Paper ZOIP vector p (length L-1; p[l-1]=1 enables the cut after layer l)."""
    L = len(p) + 1
    segs, lo = [], 1
    for l, bit in enumerate(p, start=1):
        if bit:
            segs.append((lo, l))
            lo = l + 1
    segs.append((lo, L))
    return tuple(segs)


def p_from_forward_segments(segments: Sequence[Segment]) -> Tuple[int, ...]:
    L = segments[-1][1]
    cuts = {hi for _, hi in segments if hi != L}
    return tuple(1 if l in cuts else 0 for l in range(1, L))


def backward_segments_from_g(g: Sequence[int]) -> Tuple[Segment, ...]:
    """Paper vector g (g[l-1]=1 enables the cut after layer L+1-l, backward order)."""
    L = len(g) + 1
    segs, hi = [], L
    for l, bit in enumerate(g, start=1):
        if bit:
            lo = L + 1 - l
            segs.append((lo, hi))
            hi = lo - 1
    segs.append((1, hi))
    return tuple(segs)


def g_from_backward_segments(segments: Sequence[Segment]) -> Tuple[int, ...]:
    L = segments[0][1]
    cuts = {lo for lo, _ in segments if lo != 1}  # cut sits after layer lo (downward)
    return tuple(1 if (L + 1 - l) in cuts else 0 for l in range(1, L))


def singleton_segments_forward(L: int) -> Tuple[Segment, ...]:
    return tuple((l, l) for l in range(1, L + 1))


def singleton_segments_backward(L: int) -> Tuple[Segment, ...]:
    return tuple((l, l) for l in range(L, 0, -1))


# ---------------------------------------------------------------------------
# f_m — the O(L) cost measurement function (paper eq. 8)
# ---------------------------------------------------------------------------


def forward_time(costs: LayerCosts, segments: Sequence[Segment]) -> float:
    """End time of the last forward-compute mini-procedure.

    Transmissions are serialized on the link and launched back-to-back
    (all parameters are available server-side at t=0); a segment's compute
    starts once (a) its parameters have arrived and (b) the previous
    segment's compute finished — exactly the partial orders of eqs. (1),
    (4), (5).
    """
    validate_forward_segments(segments, costs.num_layers)
    t_comm = 0.0
    t_comp = 0.0
    for lo, hi in segments:
        t_comm += costs.dt + float(np.sum(costs.pt[lo - 1:hi]))
        t_comp = max(t_comp, t_comm) + float(np.sum(costs.fc[lo - 1:hi]))
    return t_comp


def backward_time(costs: LayerCosts, segments: Sequence[Segment]) -> float:
    """End time of the last gradient-transmission mini-procedure.

    Backward compute runs layer L → 1 without stalls; a segment's gradients
    are pushed once (a) its layers' backward compute is done and (b) the
    link is free — eqs. (2), (6), (7).
    """
    validate_backward_segments(segments, costs.num_layers)
    t_comp = 0.0
    t_comm = 0.0
    for lo, hi in segments:
        t_comp += float(np.sum(costs.bc[lo - 1:hi]))
        t_comm = max(t_comm, t_comp) + costs.dt_push \
            + float(np.sum(costs.gt[lo - 1:hi]))
    return t_comm


def iteration_time(costs: LayerCosts,
                   fwd_segments: Sequence[Segment],
                   bwd_segments: Sequence[Segment]) -> float:
    """Total iteration time: forward phase then backward phase (eq. 3 chains
    them — bc_L cannot start before fc_L ends)."""
    return forward_time(costs, fwd_segments) + backward_time(costs, bwd_segments)


# ---------------------------------------------------------------------------
# Per-topology costs (parameter-server regime: W workers, each with its own
# compute rate and its own asymmetric link to the server shards)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TopologyCosts:
    """One ``LayerCosts`` per worker of a PS topology.

    The cluster-level ``LayerCosts`` models one homogeneous worker pool
    behind one link; a PS topology has per-worker fc/bc (heterogeneous edge
    hardware) and per-link pt/gt/Δt (asymmetric, per-worker up/down paths),
    so DynaComm must plan per worker — or pick one shared plan that
    minimizes the synchronous straggler (see
    ``repro_torch.core.scheduler.consensus_decision``).
    """

    workers: Tuple[LayerCosts, ...]

    def __post_init__(self):
        workers = tuple(self.workers)
        object.__setattr__(self, "workers", workers)
        if not workers:
            raise ValueError("TopologyCosts needs at least one worker")
        Ls = {c.num_layers for c in workers}
        if len(Ls) != 1:
            raise ValueError(f"workers disagree on layer count: {sorted(Ls)}")

    @property
    def num_workers(self) -> int:
        return len(self.workers)

    @property
    def num_layers(self) -> int:
        return self.workers[0].num_layers

    def iteration_times(self, fwd_segments: Sequence[Segment],
                        bwd_segments: Sequence[Segment]) -> Tuple[float, ...]:
        """Per-worker iteration time under one shared decision."""
        return tuple(iteration_time(c, fwd_segments, bwd_segments)
                     for c in self.workers)

    def makespan(self, fwd_segments: Sequence[Segment],
                 bwd_segments: Sequence[Segment]) -> float:
        """Synchronous-mode iteration time: the straggler's finish."""
        return max(self.iteration_times(fwd_segments, bwd_segments))

    def straggler(self, fwd_segments: Sequence[Segment],
                  bwd_segments: Sequence[Segment]) -> int:
        """Index of the worker that gates the synchronous barrier."""
        times = self.iteration_times(fwd_segments, bwd_segments)
        return int(np.argmax(times))

    @property
    def idle_window(self) -> float:
        """The topology-wide Δt + gt¹ idle window: the re-plan must be
        hidden for *every* worker (the scheduler cannot know which worker
        will straggle next epoch), so the binding window is the minimum
        over workers."""
        return min(c.idle_window for c in self.workers)

    def scaled(self, *, compute: float = 1.0, comm: float = 1.0
               ) -> "TopologyCosts":
        """Every worker's costs rescaled uniformly (sensitivity sweeps:
        ``comm`` ∝ 1/bandwidth on all links, ``compute`` ∝ batch size)."""
        return TopologyCosts(workers=tuple(
            c.scaled(compute=compute, comm=comm) for c in self.workers))

    def compressed(self, *, gt_ratio: float = 1.0, pt_ratio: float = 1.0,
                   dt_bwd_extra: float = 0.0) -> "TopologyCosts":
        """Every worker's costs under wire compression (see
        ``LayerCosts.compressed``)."""
        return TopologyCosts(workers=tuple(
            c.compressed(gt_ratio=gt_ratio, pt_ratio=pt_ratio,
                         dt_bwd_extra=dt_bwd_extra) for c in self.workers))


# ---------------------------------------------------------------------------
# Breakdown used by the paper's stacked-bar figures (Figs. 5-8)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PhaseBreakdown:
    total: float
    comm_busy: float          # link busy time
    comp_busy: float          # compute busy time
    overlap: float            # time both are busy
    comm_only: float          # non-overlapping communication
    comp_only: float          # non-overlapping computation
    idle: float               # neither busy (possible between segments)


def _busy_union(intervals):
    """Total measure of a union of [s, e) intervals."""
    if not intervals:
        return 0.0
    ivs = sorted(intervals)
    total, cur_s, cur_e = 0.0, ivs[0][0], ivs[0][1]
    for s, e in ivs[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s)


def _intersection(a, b):
    """Measure of intersection of two interval unions."""
    pts = []
    for s, e in a:
        pts.append((s, 0, 1))
        pts.append((e, 0, -1))
    for s, e in b:
        pts.append((s, 1, 1))
        pts.append((e, 1, -1))
    pts.sort()
    depth = [0, 0]
    last = None
    total = 0.0
    for t, which, d in pts:
        if last is not None and depth[0] > 0 and depth[1] > 0:
            total += t - last
        depth[which] += d
        last = t
    return total


def phase_breakdown(comm_intervals, comp_intervals) -> PhaseBreakdown:
    comm_busy = _busy_union(comm_intervals)
    comp_busy = _busy_union(comp_intervals)
    overlap = _intersection(comm_intervals, comp_intervals)
    ends = [e for _, e in comm_intervals] + [e for _, e in comp_intervals]
    starts = [s for s, _ in comm_intervals] + [s for s, _ in comp_intervals]
    total = (max(ends) - min(starts)) if ends else 0.0
    comm_only = comm_busy - overlap
    comp_only = comp_busy - overlap
    idle = total - comm_only - comp_only - overlap
    return PhaseBreakdown(total=total, comm_busy=comm_busy, comp_busy=comp_busy,
                          overlap=overlap, comm_only=comm_only,
                          comp_only=comp_only, idle=max(idle, 0.0))
