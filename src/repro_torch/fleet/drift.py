"""Measured drift detection over the fleet.

``core.profiler.EwmaDriftDetector`` watches ONE scalar stream (a link
bandwidth) and asks the dynamic trainers to re-plan when it shifts; this
module is its fleet-scale successor: the same EWMA / relative-shift /
patience discipline, but keyed **per worker** and fed the quantity the
event engine actually observes — each worker's commit gap (admission to
commit, simulated seconds).  Nothing here is scripted: a worker that
silently slows down (a ``drift`` fleet event, thermal throttling, a
congested uplink) changes its observed gaps, the detector's per-worker
baseline breaches for ``patience`` consecutive commits, and the trainer
re-plans with that worker's *believed* compute rate scaled to match the
measurement.

The detector is plain data (no wall clock, no RNG) and round-trips
through ``state_dict``/``load_state_dict`` so resumed runs detect
bit-identically.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class _WorkerStream:
    """EWMA state of one worker's observed commit gaps."""

    ewma: float = 0.0
    baseline: float = 0.0
    breaches: int = 0
    samples: int = 0


class FleetDriftDetector:
    """Per-worker EWMA drift detection on observed commit gaps.

    Parameters mirror :class:`repro_torch.core.profiler.EwmaDriftDetector`:
    ``alpha`` smooths each worker's gap stream, the first ``warmup``
    observations seed its baseline, and a relative shift
    ``|ewma − baseline| / baseline ≥ threshold`` sustained for
    ``patience`` consecutive observations triggers (re-seeding the
    baseline so the next drift is measured against the new regime).
    """

    def __init__(self, *, alpha: float = 0.2, threshold: float = 0.3,
                 patience: int = 3, warmup: int = 2):
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if threshold <= 0:
            raise ValueError(f"threshold must be positive, got {threshold}")
        if patience < 1 or warmup < 1:
            raise ValueError("patience and warmup must be >= 1")
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.warmup = warmup
        self._streams: Dict[int, _WorkerStream] = {}

    def observe(self, worker: int, gap: float) -> bool:
        """Feed one commit gap; True when ``worker``'s stream drifted."""
        if gap <= 0:
            raise ValueError(f"commit gap must be positive, got {gap}")
        st = self._streams.get(worker)
        if st is None:
            st = self._streams[worker] = _WorkerStream()
        st.samples += 1
        st.ewma = gap if st.samples == 1 else \
            self.alpha * gap + (1 - self.alpha) * st.ewma
        if st.samples <= self.warmup:
            st.baseline = st.ewma
            return False
        rel = abs(st.ewma - st.baseline) / st.baseline
        st.breaches = st.breaches + 1 if rel >= self.threshold else 0
        if st.breaches >= self.patience:
            st.baseline = st.ewma
            st.breaches = 0
            return True
        return False

    def observed_gap(self, worker: int) -> Optional[float]:
        """``worker``'s current EWMA commit gap (None before any)."""
        st = self._streams.get(worker)
        return st.ewma if st is not None and st.samples else None

    def forget(self, worker: int) -> None:
        """Drop a departed worker's stream."""
        self._streams.pop(worker, None)

    # -- serialization -------------------------------------------------

    def state_dict(self) -> dict:
        return {str(w): [st.ewma, st.baseline, st.breaches, st.samples]
                for w, st in self._streams.items()}

    def load_state_dict(self, state: dict) -> None:
        self._streams = {
            int(w): _WorkerStream(ewma=float(e), baseline=float(b),
                                  breaches=int(br), samples=int(s))
            for w, (e, b, br, s) in state.items()}
