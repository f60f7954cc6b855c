"""Fleet membership: who is in the worker set, and how it changes.

The elastic regime separates *what happens to the fleet* from *how the
trainer reacts*:

* :class:`FleetEvent` / :class:`FleetSchedule` — the scripted (or
  synthesized) timeline of membership changes: workers ``join`` with
  their own link/compute spec, ``leave`` gracefully, ``fail`` (mode
  ``"crash"``: the connection dies mid-push, pending segments are
  dropped server-side; mode ``"stall"``: the worker silently stops
  committing and must be *detected*), or ``drift`` (its real compute
  rate changes by a factor — also silent, left to measured drift
  detection rather than scripted re-planning);
* :class:`FleetMembership` — the live roster: which global worker ids
  are active, each one's :class:`WorkerSpec`, when it joined (time and
  server version — the conformance anchor for "a joined worker's pushes
  start at its join version") and when/why it departed.  It projects the
  active set onto a :class:`~repro_torch.ps.topology.PSTopology` whose link
  order follows ascending worker id, so topology position ``i`` is
  always ``active[i]``.

``FleetSchedule.synthesize`` generates reproducible churn from a seeded
generator — the only randomness in the subsystem, and it happens at
*construction* time; the event loop itself stays RNG-free.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.ps.topology import PSTopology, asymmetric_link

FLEET_EVENT_KINDS = ("join", "leave", "fail", "drift")
FAIL_MODES = ("crash", "stall")


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """One worker's link bandwidths and compute rate."""

    down_bps: float = 10e9        # server → worker (parameter pulls)
    up_bps: float = 1e9           # worker → server (gradient pushes)
    flops: float = 1e10           # compute rate (FLOP/s)

    def __post_init__(self):
        for name in ("down_bps", "up_bps", "flops"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive, got "
                                 f"{getattr(self, name)}")


@dataclasses.dataclass(frozen=True)
class FleetEvent:
    """One membership/environment change at simulated ``time``.

    ``kind``:

    * ``"join"`` — ``worker`` (a fresh global id) enters with ``spec``;
    * ``"leave"`` — graceful departure: uncommitted work is discarded;
    * ``"fail"`` — ``mode="crash"`` kills the worker mid-push (segments
      already sent stay in the ledger, the pending set is dropped), while
      ``mode="stall"`` makes it silently stop committing — nothing
      observable happens until the stall detector evicts it;
    * ``"drift"`` — the worker's true iteration time scales by
      ``factor`` (> 1 slower).  Silent: the planner only learns about it
      through measured drift detection.
    """

    time: float
    kind: str
    worker: int
    mode: str = "crash"           # fail events only
    factor: float = 1.0           # drift events only
    spec: Optional[WorkerSpec] = None   # join events only

    def __post_init__(self):
        if self.time < 0:
            raise ValueError(f"event time must be >= 0, got {self.time}")
        if self.kind not in FLEET_EVENT_KINDS:
            raise ValueError(f"kind must be one of {FLEET_EVENT_KINDS}, "
                             f"got {self.kind!r}")
        if self.worker < 0:
            raise ValueError(f"worker id must be >= 0, got {self.worker}")
        if self.kind == "fail" and self.mode not in FAIL_MODES:
            raise ValueError(f"fail mode must be one of {FAIL_MODES}, got "
                             f"{self.mode!r}")
        if self.kind == "drift" and self.factor <= 0:
            raise ValueError(f"drift factor must be positive, got "
                             f"{self.factor}")
        if self.spec is not None and self.kind != "join":
            raise ValueError(f"only join events carry a spec "
                             f"(got kind={self.kind!r})")

    def to_dict(self) -> dict:
        d = {"time": self.time, "kind": self.kind, "worker": self.worker}
        if self.kind == "fail":
            d["mode"] = self.mode
        if self.kind == "drift":
            d["factor"] = self.factor
        if self.spec is not None:
            d["spec"] = dataclasses.asdict(self.spec)
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "FleetEvent":
        d = dict(d)
        spec = d.pop("spec", None)
        if spec is not None and not isinstance(spec, WorkerSpec):
            spec = WorkerSpec(**spec)
        return cls(spec=spec, **d)


@dataclasses.dataclass(frozen=True)
class FleetSchedule:
    """A time-ordered script of :class:`FleetEvent`\\ s."""

    events: Tuple[FleetEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        times = [e.time for e in self.events]
        if times != sorted(times):
            raise ValueError("fleet events must be ordered by time")

    def __len__(self) -> int:
        return len(self.events)

    @property
    def horizon(self) -> float:
        return self.events[-1].time if self.events else 0.0

    def validate_against(self, initial_workers: Sequence[int]) -> None:
        """Check the script is coherent for a fleet starting as
        ``initial_workers``: joins introduce fresh ids, leaves/fails/
        drifts name a currently-active id."""
        active = set(initial_workers)
        ever = set(initial_workers)
        for e in self.events:
            if e.kind == "join":
                if e.worker in ever:
                    raise ValueError(f"t={e.time}: worker {e.worker} "
                                     f"joins but the id was already used")
                active.add(e.worker)
                ever.add(e.worker)
            else:
                if e.worker not in active:
                    raise ValueError(f"t={e.time}: {e.kind} names worker "
                                     f"{e.worker}, which is not active")
                if e.kind in ("leave", "fail"):
                    active.remove(e.worker)

    @classmethod
    def synthesize(cls, initial_workers: Sequence[int], *, churn: float,
                   horizon: float, seed: int = 0,
                   join_spec: WorkerSpec = WorkerSpec(),
                   kind_weights: Tuple[float, float, float] = (0.4, 0.3,
                                                              0.3),
                   fail_stall_fraction: float = 0.5,
                   min_fleet: Optional[int] = None) -> "FleetSchedule":
        """Reproducible churn: ~``churn * horizon`` events, uniform in
        time, kinds drawn as (join, leave, fail) per ``kind_weights``.
        Departures are skipped while the fleet is at ``min_fleet``
        (default: half the initial size, at least 1); join ids continue
        above the largest id ever seen.  Deterministic per ``seed``."""
        initial = sorted(initial_workers)
        if not initial:
            raise ValueError("need at least one initial worker")
        floor = max(1, len(initial) // 2) if min_fleet is None else min_fleet
        rng = np.random.default_rng(seed)
        n = int(rng.poisson(churn * horizon))
        times = sorted(float(t) for t in rng.uniform(0.0, horizon, size=n))
        weights = np.asarray(kind_weights, float)
        weights = weights / weights.sum()
        active = list(initial)
        next_id = max(initial) + 1
        events: List[FleetEvent] = []
        for t in times:
            kind = ("join", "leave", "fail")[
                int(rng.choice(3, p=weights))]
            if kind == "join":
                events.append(FleetEvent(time=t, kind="join",
                                         worker=next_id, spec=join_spec))
                active.append(next_id)
                next_id += 1
                continue
            if len(active) <= floor:
                continue              # departure would sink the fleet
            victim = active.pop(int(rng.integers(len(active))))
            if kind == "leave":
                events.append(FleetEvent(time=t, kind="leave",
                                         worker=victim))
            else:
                mode = "stall" if rng.random() < fail_stall_fraction \
                    else "crash"
                events.append(FleetEvent(time=t, kind="fail", worker=victim,
                                         mode=mode))
        return cls(tuple(events))


class FleetMembership:
    """The live worker roster, projectable onto a :class:`PSTopology`."""

    def __init__(self, specs: Mapping[int, WorkerSpec]):
        if not specs:
            raise ValueError("need at least one initial worker")
        self._specs: Dict[int, WorkerSpec] = dict(sorted(specs.items()))
        # (join time, server version at join); initial fleet joins at 0
        self.joined_at: Dict[int, Tuple[float, int]] = {
            w: (0.0, 0) for w in self._specs}
        # (departure time, reason) — reasons: leave | crash | stall
        self.departed: Dict[int, Tuple[float, str]] = {}

    # -- roster --------------------------------------------------------

    @property
    def active(self) -> Tuple[int, ...]:
        return tuple(sorted(self._specs))

    @property
    def num_active(self) -> int:
        return len(self._specs)

    def is_active(self, worker: int) -> bool:
        return worker in self._specs

    def spec(self, worker: int) -> WorkerSpec:
        return self._specs[worker]

    def index_of(self, worker: int) -> int:
        """Topology position of ``worker`` (link order = ascending id)."""
        return self.active.index(worker)

    def join(self, worker: int, spec: WorkerSpec, *, time: float,
             version: int) -> None:
        if worker in self._specs:
            raise ValueError(f"worker {worker} is already active")
        if worker in self.departed:
            raise ValueError(f"worker id {worker} was already used; "
                             f"joins need fresh ids")
        self._specs[worker] = spec
        self._specs = dict(sorted(self._specs.items()))
        self.joined_at[worker] = (time, version)

    def depart(self, worker: int, *, time: float, reason: str) -> None:
        if worker not in self._specs:
            raise ValueError(f"worker {worker} is not active")
        del self._specs[worker]
        self.departed[worker] = (time, reason)

    # -- projection ----------------------------------------------------

    def topology(self, num_servers: int, *,
                 flops_scale: Optional[Mapping[int, float]] = None
                 ) -> PSTopology:
        """The active fleet as a :class:`PSTopology` (links in ascending
        worker-id order).  ``flops_scale[w] = f`` divides ``w``'s compute
        rate by ``f`` — the planner's *believed* slowdown factors from
        drift detection."""
        scale = flops_scale or {}
        links = tuple(asymmetric_link(self._specs[w].down_bps,
                                      self._specs[w].up_bps)
                      for w in self.active)
        flops = tuple(self._specs[w].flops / float(scale.get(w, 1.0))
                      for w in self.active)
        return PSTopology(num_servers=num_servers, links=links,
                          worker_flops=flops)

    # -- serialization -------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "specs": {str(w): dataclasses.asdict(s)
                      for w, s in self._specs.items()},
            "joined_at": {str(w): list(v)
                          for w, v in self.joined_at.items()},
            "departed": {str(w): list(v)
                         for w, v in self.departed.items()},
        }

    @classmethod
    def from_state(cls, state: dict) -> "FleetMembership":
        m = cls({int(w): WorkerSpec(**s)
                 for w, s in state["specs"].items()})
        m.joined_at = {int(w): (float(t), int(v))
                       for w, (t, v) in state["joined_at"].items()}
        m.departed = {int(w): (float(t), str(r))
                      for w, (t, r) in state["departed"].items()}
        return m
