"""Parameter-server topology: S server shards × W edge workers.

The paper's deployment (Section II): parameter servers hold the model,
edge devices pull parameters down and push gradients up.  ``PSTopology``
describes that fabric explicitly —

* ``num_servers`` server shards, each owning a contiguous block of sched
  layers (``shard_of_layer``); a DynaComm transmission segment is one
  message against the shard owning its first layer (``owner_of_bucket``);
* one :class:`LinkModel` per worker: an *asymmetric* pair of
  ``core.netmodel`` network models — ``down`` times the parameter pull
  (server → worker), ``up`` times the gradient push (worker → server).
  Edge uplinks are routinely 5-20× slower than downlinks, which is what
  makes per-direction Δt/bandwidth worth modelling;
* per-worker compute rates (``worker_flops``) — heterogeneous edge
  hardware.

``worker_costs`` / ``topology_costs`` project the topology onto the
scheduler's cost interface: per-worker ``LayerCosts`` whose pt/Δt come
from the downlink, gt/Δt_bwd from the uplink, and fc/bc from that
worker's own compute rate — so DynaComm plans *per topology* rather than
per homogeneous cluster.

``TopologySchedule`` is the time-varying regime: a piecewise-constant
sequence of topologies indexed by epoch (mirroring
``core.netmodel.NetworkSchedule``) — an edge fleet whose uplinks degrade,
whose devices throttle thermally, or whose membership is re-provisioned
on epoch boundaries.  The dynamic PS trainers re-plan against the active
topology once per topology epoch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import numpy as np

from repro_torch.core.costmodel import LayerCosts, TopologyCosts
from repro_torch.core.netmodel import EdgeNetworkModel
from repro_torch.core.profiler import LayerProfile


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """One worker's asymmetric path to the parameter servers.

    ``down`` and ``up`` are network models exposing ``dt`` and
    ``transfer_time(nbytes)`` (any ``core.netmodel`` model qualifies).
    """

    down: Any                  # server → worker: parameter pulls
    up: Any                    # worker → server: gradient pushes

    def __post_init__(self):
        for name in ("down", "up"):
            m = getattr(self, name)
            if not hasattr(m, "dt") or not hasattr(m, "transfer_time"):
                raise TypeError(f"{name} model {m!r} lacks the network "
                                f"interface (dt + transfer_time)")


def asymmetric_link(down_bps: float, up_bps: float, *,
                    rtt_s: float = EdgeNetworkModel.rtt_s,
                    setup_s: float = EdgeNetworkModel.setup_s) -> LinkModel:
    """The common edge case: one RTT, different bandwidth per direction."""
    return LinkModel(
        down=EdgeNetworkModel(bandwidth_bps=down_bps, rtt_s=rtt_s,
                              setup_s=setup_s),
        up=EdgeNetworkModel(bandwidth_bps=up_bps, rtt_s=rtt_s,
                            setup_s=setup_s))


@dataclasses.dataclass(frozen=True)
class PSTopology:
    """S server shards × W edge workers with per-link, per-worker costs."""

    num_servers: int
    links: Tuple[LinkModel, ...]          # one per worker
    worker_flops: Tuple[float, ...]       # compute rate per worker (FLOP/s)

    def __post_init__(self):
        object.__setattr__(self, "links", tuple(self.links))
        object.__setattr__(self, "worker_flops",
                           tuple(float(f) for f in self.worker_flops))
        if self.num_servers < 1:
            raise ValueError(f"num_servers must be >= 1, got "
                             f"{self.num_servers}")
        if not self.links:
            raise ValueError("a topology needs at least one worker link")
        if len(self.worker_flops) != len(self.links):
            raise ValueError(f"{len(self.worker_flops)} worker_flops for "
                             f"{len(self.links)} links")
        if any(f <= 0 for f in self.worker_flops):
            raise ValueError("worker_flops must be positive")

    @property
    def num_workers(self) -> int:
        return len(self.links)

    @classmethod
    def uniform(cls, num_servers: int, num_workers: int, *,
                down_bps: float = 10e9, up_bps: float = 1e9,
                flops: float = 1e10,
                rtt_s: float = EdgeNetworkModel.rtt_s,
                setup_s: float = EdgeNetworkModel.setup_s) -> "PSTopology":
        """Homogeneous workers behind identical asymmetric links."""
        link = asymmetric_link(down_bps, up_bps, rtt_s=rtt_s,
                               setup_s=setup_s)
        return cls(num_servers=num_servers, links=(link,) * num_workers,
                   worker_flops=(flops,) * num_workers)

    # ------------------------------------------------------------------
    # server sharding
    # ------------------------------------------------------------------

    def shard_of_layer(self, layer: int, num_layers: int) -> int:
        """Owning server shard of 0-indexed sched layer ``layer``.

        Layers are split into ``num_servers`` contiguous blocks (block s
        holds layers [s*L/S, (s+1)*L/S)), so DynaComm's contiguous
        transmission segments mostly stay within one shard."""
        if not 0 <= layer < num_layers:
            raise ValueError(f"layer {layer} outside 0..{num_layers - 1}")
        return min(layer * self.num_servers // num_layers,
                   self.num_servers - 1)

    def owner_of_bucket(self, bucket: Sequence[int], num_layers: int) -> int:
        """The shard a segment's single pull/push message is routed to:
        the owner of the segment's lowest layer."""
        if not bucket:
            raise ValueError("empty bucket has no owner")
        return self.shard_of_layer(min(bucket), num_layers)

    def layers_of_shard(self, shard: int, num_layers: int) -> Tuple[int, ...]:
        if not 0 <= shard < self.num_servers:
            raise ValueError(f"shard {shard} outside 0..{self.num_servers - 1}")
        return tuple(l for l in range(num_layers)
                     if self.shard_of_layer(l, num_layers) == shard)

    # ------------------------------------------------------------------
    # projection onto the scheduler's cost interface
    # ------------------------------------------------------------------

    def worker_costs(self, worker: int, *, param_bytes: Sequence[float],
                     flops_fwd: Sequence[float],
                     flops_bwd: Sequence[float] | None = None,
                     grad_bytes: Sequence[float] | None = None,
                     compressor: Any | None = None) -> LayerCosts:
        """This worker's per-layer cost vectors.

        pt/Δt from its downlink, gt/Δt_bwd from its uplink, fc/bc from its
        own compute rate (bc defaults to 2× fc FLOPs).  With a
        ``compressor``, gradient pushes are timed on the *wire* payload
        (``compressor.wire_bytes``), and each push segment's Δt grows by
        the compressor's per-segment header cost over this uplink; pulls
        stay fp32."""
        if not 0 <= worker < self.num_workers:
            raise ValueError(f"worker {worker} outside "
                             f"0..{self.num_workers - 1}")
        link = self.links[worker]
        pb = np.asarray(param_bytes, dtype=np.float64)
        gb = pb if grad_bytes is None else np.asarray(grad_bytes, np.float64)
        ff = np.asarray(flops_fwd, dtype=np.float64)
        fb = 2.0 * ff if flops_bwd is None else np.asarray(flops_bwd,
                                                           np.float64)
        rate = self.worker_flops[worker]
        dt_bwd = link.up.dt
        if compressor is not None:
            gb = np.asarray(compressor.wire_bytes(gb), np.float64)
            dt_bwd += float(
                link.up.transfer_time(compressor.segment_overhead_bytes))
        return LayerCosts(pt=link.down.transfer_time(pb), fc=ff / rate,
                          bc=fb / rate, gt=link.up.transfer_time(gb),
                          dt=link.down.dt, dt_bwd=dt_bwd)

    def topology_costs(self, profiles: Sequence[LayerProfile], *,
                       compressor: Any | None = None) -> TopologyCosts:
        """Per-worker ``LayerCosts`` from one set of layer workloads."""
        pb = [p.param_bytes for p in profiles]
        gb = [p.gbytes for p in profiles]
        ff = [p.flops_fwd for p in profiles]
        fb = [p.bwd for p in profiles]
        return TopologyCosts(workers=tuple(
            self.worker_costs(w, param_bytes=pb, flops_fwd=ff, flops_bwd=fb,
                              grad_bytes=gb, compressor=compressor)
            for w in range(self.num_workers)))

    def topology_costs_measured(self, profiles: Sequence[LayerProfile], *,
                                fc: Sequence[float], bc: Sequence[float],
                                ref_flops: float | None = None,
                                compressor: Any | None = None
                                ) -> TopologyCosts:
        """Per-worker costs from *measured* per-layer fc/bc wall times.

        The measured vectors describe one physical host; they are taken
        as the timings of a worker running at ``ref_flops`` (default: the
        fleet's fastest rate) and rescaled to each worker's own compute
        rate — ``fc_w = fc * ref_flops / worker_flops[w]`` — while
        transmission costs (pt/gt/Δt per direction) still come from each
        worker's own links.  Byte payloads come from ``profiles``.
        """
        ref = max(self.worker_flops) if ref_flops is None else float(ref_flops)
        if ref <= 0:
            raise ValueError(f"ref_flops must be positive, got {ref}")
        pb = np.asarray([p.param_bytes for p in profiles], np.float64)
        gb = np.asarray([p.gbytes for p in profiles], np.float64)
        fc = np.asarray(fc, np.float64)
        bc = np.asarray(bc, np.float64)
        if fc.shape != (len(profiles),) or bc.shape != (len(profiles),):
            raise ValueError(f"fc/bc must have one entry per layer "
                             f"({len(profiles)}), got {fc.shape}/{bc.shape}")
        workers = []
        for w in range(self.num_workers):
            link = self.links[w]
            scale = ref / self.worker_flops[w]
            gb_w, dt_bwd = gb, link.up.dt
            if compressor is not None:
                gb_w = np.asarray(compressor.wire_bytes(gb), np.float64)
                dt_bwd += float(
                    link.up.transfer_time(compressor.segment_overhead_bytes))
            workers.append(LayerCosts(
                pt=link.down.transfer_time(pb), fc=fc * scale,
                bc=bc * scale, gt=link.up.transfer_time(gb_w),
                dt=link.down.dt, dt_bwd=dt_bwd))
        return TopologyCosts(workers=tuple(workers))


# ---------------------------------------------------------------------------
# Time-varying topologies (the dynamic-PS workload)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TopologySchedule:
    """Piecewise-constant time-varying :class:`PSTopology`.

    ``knots`` is a sequence of ``(start_epoch, topology)`` pairs with
    strictly increasing epochs starting at 0 (the ``NetworkSchedule``
    contract, applied to whole topologies): ``topology_at(e)`` returns the
    topology of the last knot whose start epoch is <= ``e``, so a shift
    applies to the boundary epoch itself.  Zero-length epochs (two knots
    at the same epoch) are rejected.

    Every knot must keep ``num_workers`` fixed — workers map 1:1 onto mesh
    devices (sync) or event-loop actors (async), neither of which can be
    re-provisioned mid-run; links, compute rates, and the server-shard
    count may all drift freely.
    """

    knots: Tuple[Tuple[int, PSTopology], ...]

    def __post_init__(self):
        knots = tuple((int(e), t) for e, t in self.knots)
        object.__setattr__(self, "knots", knots)
        if not knots:
            raise ValueError("TopologySchedule needs at least one knot")
        for e, topo in knots:
            if not isinstance(topo, PSTopology):
                raise TypeError(f"knot at epoch {e} is {type(topo).__name__},"
                                f" not PSTopology")
        epochs = [e for e, _ in knots]
        if epochs[0] != 0:
            raise ValueError(f"first knot must start at epoch 0, got "
                             f"{epochs[0]}")
        if any(b <= a for a, b in zip(epochs, epochs[1:])):
            raise ValueError(f"knot epochs must be strictly increasing, got "
                             f"{epochs}")
        workers = {t.num_workers for _, t in knots}
        if len(workers) != 1:
            raise ValueError(f"knots disagree on num_workers: "
                             f"{sorted(workers)} — workers cannot join or "
                             f"leave mid-run")

    @property
    def num_knots(self) -> int:
        return len(self.knots)

    @property
    def num_workers(self) -> int:
        return self.knots[0][1].num_workers

    def topology_at(self, epoch: int) -> PSTopology:
        if epoch < 0:
            raise ValueError(f"epoch must be >= 0, got {epoch}")
        active = self.knots[0][1]
        for start, topo in self.knots:
            if start > epoch:
                break
            active = topo
        return active

    def shift_epochs(self) -> Tuple[int, ...]:
        """Epochs at which the active topology changes (knots after the
        first)."""
        return tuple(e for e, _ in self.knots[1:])


def as_topology_schedule(topo) -> TopologySchedule:
    """Wrap a static ``PSTopology`` as a one-knot schedule (idempotent)."""
    if isinstance(topo, TopologySchedule):
        return topo
    return TopologySchedule(knots=((0, topo),))


def uplink_degradation(base: PSTopology, *, factor: float,
                       at_epoch: int) -> TopologySchedule:
    """The canonical drift demo: every worker's uplink bandwidth divided
    by ``factor`` at ``at_epoch`` (downlinks, RTTs, and compute rates
    unchanged) — gradient pushes suddenly dominate and the backward
    decomposition must re-segment."""
    if at_epoch < 1:
        raise ValueError(f"at_epoch must be >= 1, got {at_epoch}")
    if factor <= 0:
        raise ValueError(f"factor must be positive, got {factor}")
    degraded = []
    for w, link in enumerate(base.links):
        up = link.up
        # LinkModel's contract is duck-typed (dt + transfer_time); this
        # helper additionally needs a bandwidth-parameterized uplink
        for attr in ("bandwidth_bps", "rtt_s", "setup_s"):
            if not hasattr(up, attr):
                raise TypeError(
                    f"worker {w}'s uplink {up!r} has no {attr}; "
                    f"uplink_degradation needs EdgeNetworkModel-style "
                    f"uplinks — build the degraded TopologySchedule "
                    f"explicitly instead")
        degraded.append(LinkModel(
            down=link.down,
            up=EdgeNetworkModel(bandwidth_bps=up.bandwidth_bps / factor,
                                rtt_s=up.rtt_s, setup_s=up.setup_s)))
    after = PSTopology(num_servers=base.num_servers, links=tuple(degraded),
                       worker_flops=base.worker_flops)
    return TopologySchedule(knots=((0, base), (at_epoch, after)))
