"""Hardware / network cost sources for the profiler.

Two regimes:

* ``EdgeNetworkModel`` — the paper's testbed: parameter servers on a cloud,
  workers at the edge, ~10 ms RTT, 1-10 Gbps.  Δt is the per-transmission
  setup + coordination overhead (the paper measures ≈14 ms era values for
  Δt + a first-layer transmission, Table I).
* ``TPUSystemModel`` — the adaptation target: TPU v5e pod.  "Transmission"
  becomes an all-gather (pull) or reduce-scatter (push) over the ``data``
  mesh axis; Δt becomes the fixed collective launch + ICI latency cost.

Both produce the same interface: per-layer pt/gt seconds from per-layer
byte counts, plus dt.

``NetworkSchedule`` adds the *time-varying* regime the dynamic trainer
re-schedules against: a piecewise-constant sequence of network models
indexed by epoch (e.g. the edge uplink degrading 10 Gbps → 1 Gbps at
epoch k), so the same profiling → DP → decision loop sees different pt/gt/Δt
as training progresses.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np

# TPU v5e roofline constants (per chip) — also used by §Roofline.
TPU_PEAK_FLOPS_BF16 = 197e12          # FLOP/s
TPU_HBM_BW = 819e9                    # bytes/s
TPU_ICI_BW_PER_LINK = 50e9            # bytes/s per link (~ one direction)


@dataclasses.dataclass(frozen=True)
class EdgeNetworkModel:
    """Paper-faithful edge<->cloud network."""

    bandwidth_bps: float = 10e9       # bits per second (paper: 1/5/10 Gbps)
    rtt_s: float = 10.337e-3          # paper's measured average RTT
    setup_s: float = 3.5e-3           # socket/coordination setup per message

    @property
    def dt(self) -> float:
        # One RTT of coordination plus fixed setup per mini-procedure; with
        # the paper's constants this lands Δt ≈ 14 ms minus a first-layer
        # payload, matching Table I's (Δt + pt^1) ≈ 14 ms scale.
        return self.rtt_s + self.setup_s

    def transfer_time(self, nbytes: np.ndarray) -> np.ndarray:
        return np.asarray(nbytes, dtype=np.float64) * 8.0 / self.bandwidth_bps


@dataclasses.dataclass(frozen=True)
class TPUSystemModel:
    """TPU v5e pod: collectives over ICI on the ``data`` axis."""

    peak_flops: float = TPU_PEAK_FLOPS_BF16
    hbm_bw: float = TPU_HBM_BW
    ici_bw: float = TPU_ICI_BW_PER_LINK
    data_axis_size: int = 16
    collective_launch_s: float = 8e-6   # launch + DMA setup per collective
    ici_hop_latency_s: float = 1e-6     # per-hop latency, ring of data_axis_size
    mfu: float = 0.5                    # assumed model-flop utilization for fc/bc

    @property
    def dt(self) -> float:
        # A ring collective pays launch overhead plus (A-1) hop latencies
        # before the pipeline fills — the fixed, size-independent term.
        return self.collective_launch_s \
            + (self.data_axis_size - 1) * self.ici_hop_latency_s

    def transfer_time(self, nbytes: np.ndarray) -> np.ndarray:
        """Ring all-gather / reduce-scatter time for per-layer shard bytes.

        For a tensor of B bytes sharded A ways, each device moves
        B * (A-1)/A bytes through one link.
        """
        a = self.data_axis_size
        frac = (a - 1) / a
        return np.asarray(nbytes, dtype=np.float64) * frac / self.ici_bw

    def compute_time(self, flops: np.ndarray) -> np.ndarray:
        return np.asarray(flops, dtype=np.float64) / (self.peak_flops * self.mfu)


# ---------------------------------------------------------------------------
# Time-varying network conditions (the dynamic-rescheduling workload)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NetworkSchedule:
    """Piecewise-constant time-varying network condition.

    ``knots`` is a sequence of ``(start_epoch, model)`` pairs with strictly
    increasing epochs starting at 0; ``model_at(e)`` returns the model of the
    last knot whose start epoch is <= ``e``.  Any object exposing the network
    interface (``dt`` + ``transfer_time``) can be a knot model.
    """

    knots: Tuple[Tuple[int, Any], ...]

    def __post_init__(self):
        knots = tuple((int(e), m) for e, m in self.knots)
        object.__setattr__(self, "knots", knots)
        if not knots:
            raise ValueError("NetworkSchedule needs at least one knot")
        epochs = [e for e, _ in knots]
        if epochs[0] != 0:
            raise ValueError(f"first knot must start at epoch 0, got "
                             f"{epochs[0]}")
        if any(b <= a for a, b in zip(epochs, epochs[1:])):
            raise ValueError(f"knot epochs must be strictly increasing, got "
                             f"{epochs}")

    def model_at(self, epoch: int) -> Any:
        if epoch < 0:
            raise ValueError(f"epoch must be >= 0, got {epoch}")
        active = self.knots[0][1]
        for start, model in self.knots:
            if start > epoch:
                break
            active = model
        return active

    @property
    def num_knots(self) -> int:
        return len(self.knots)


def as_schedule(net: Any) -> NetworkSchedule:
    """Wrap a static network model as a one-knot schedule (idempotent)."""
    if isinstance(net, NetworkSchedule):
        return net
    return NetworkSchedule(knots=((0, net),))


def bandwidth_shift(before_bps: float, after_bps: float, *, at_epoch: int,
                    rtt_s: float = EdgeNetworkModel.rtt_s,
                    setup_s: float = EdgeNetworkModel.setup_s
                    ) -> NetworkSchedule:
    """The drift demo scenario: an edge uplink whose bandwidth steps from
    ``before_bps`` to ``after_bps`` at epoch ``at_epoch`` (RTT unchanged)."""
    if at_epoch < 1:
        raise ValueError(f"at_epoch must be >= 1, got {at_epoch}")
    return NetworkSchedule(knots=(
        (0, EdgeNetworkModel(bandwidth_bps=before_bps, rtt_s=rtt_s,
                             setup_s=setup_s)),
        (at_epoch, EdgeNetworkModel(bandwidth_bps=after_bps, rtt_s=rtt_s,
                                    setup_s=setup_s)),
    ))
