"""Frozen, JSON-round-trippable runtime configuration.

One serialized description shared by launchers, examples, benchmarks, and
checkpoints: a :class:`RuntimeConfig` names a registered runtime (see
``repro_torch.runtime.registry``) plus three nested blocks —

* :class:`ScheduleConfig` — what the scheduler re-plans against: the
  strategy, the re-plan interval, drift detection, and either a scalar
  edge :class:`NetworkConfig` (ZeRO regimes) or a :class:`TopologyConfig`
  (PS regimes), both optionally time-varying;
* :class:`ExecutionConfig` — how plans execute: ``zero`` (bucketed ZeRO
  collectives), ``ps-sync`` (consensus plan, one pull + one push per
  segment), or ``ps-async`` (bounded-staleness event loop with a
  ``reject``/``wait`` throttle and optional BSP push aggregation);
* :class:`MeasureConfig` — where fc/bc come from: deterministic analytic
  profiles or measured :class:`~repro_torch.core.profiler.LayerTimingHook`
  wall times, re-measured every ``remeasure_every`` re-plan epochs.

``to_json`` → ``from_json`` is exact (``config == RuntimeConfig.from_json(
config.to_json())``), and every cross-field inconsistency — staleness on a
synchronous runtime, a PS topology on a ZeRO regime, aggregation without
the wait throttle — raises ``ValueError`` at construction, not at step 1.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple, Union

# registry-name → execution regime; the single source of truth for which
# combinations exist (the registry registers exactly these names)
RUNTIME_REGIMES = {
    "local": "local",
    "zero": "zero",
    "dynamic": "zero",
    "ps": "ps-sync",
    "dynamic-ps": "ps-sync",
    "ps-async": "ps-async",
    "dynamic-ps-async": "ps-async",
    "fleet-async": "ps-async",
    "pipeline": "pipeline",
}
DYNAMIC_RUNTIMES = ("dynamic", "dynamic-ps", "dynamic-ps-async",
                    "fleet-async")

_STRATEGIES = ("sequential", "lbl", "ibatch", "dynacomm", "bruteforce")
_THROTTLES = ("reject", "wait")
_COST_SOURCES = ("analytic", "measured")


def _as_tuple(x) -> Optional[Tuple[float, ...]]:
    """Normalize per-worker scalars/sequences so JSON round-trips equal."""
    if x is None or isinstance(x, (int, float)):
        return x
    return tuple(float(v) for v in x)


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Scalar edge network of the ZeRO regimes (one shared uplink)."""

    bandwidth_gbps: float = 10.0
    shift_gbps: Optional[float] = None    # drift target at shift_epoch
    shift_epoch: int = 1

    def __post_init__(self):
        if self.bandwidth_gbps <= 0:
            raise ValueError(f"bandwidth_gbps must be positive, got "
                             f"{self.bandwidth_gbps}")
        if self.shift_gbps is not None and self.shift_gbps <= 0:
            raise ValueError(f"shift_gbps must be positive, got "
                             f"{self.shift_gbps}")

    def build(self):
        """The ``core.netmodel`` object this block describes."""
        from repro_torch.core import EdgeNetworkModel, bandwidth_shift
        if self.shift_gbps is None:
            return EdgeNetworkModel(bandwidth_bps=self.bandwidth_gbps * 1e9)
        return bandwidth_shift(self.bandwidth_gbps * 1e9,
                               self.shift_gbps * 1e9,
                               at_epoch=self.shift_epoch)


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """S server shards × W workers of the PS regimes.

    ``down_gbps`` / ``up_gbps`` / ``worker_flops`` accept a scalar
    (homogeneous fleet) or one value per worker (heterogeneous edges —
    the regime the consensus/straggler machinery exists for).
    ``workers=None`` resolves at build time to one worker per device
    (sync) or per-device logical workers (async).
    """

    servers: int = 2
    workers: Optional[int] = None
    down_gbps: Union[float, Tuple[float, ...]] = 10.0
    up_gbps: Union[float, Tuple[float, ...]] = 1.0
    worker_flops: Union[float, Tuple[float, ...]] = 1e10
    up_shift_factor: Optional[float] = None   # every uplink /= factor ...
    shift_epoch: int = 1                      # ... at this epoch

    def __post_init__(self):
        for name in ("down_gbps", "up_gbps", "worker_flops"):
            object.__setattr__(self, name, _as_tuple(getattr(self, name)))
        if self.servers < 1:
            raise ValueError(f"servers must be >= 1, got {self.servers}")
        if self.workers is not None and self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.up_shift_factor is not None and self.up_shift_factor <= 0:
            raise ValueError(f"up_shift_factor must be positive, got "
                             f"{self.up_shift_factor}")

    def _per_worker(self, value, W: int) -> Tuple[float, ...]:
        if isinstance(value, tuple):
            if len(value) != W:
                raise ValueError(f"{len(value)} per-worker values for "
                                 f"{W} workers")
            return value
        return (float(value),) * W

    def build(self, default_workers: int):
        """The ``PSTopology`` (or ``TopologySchedule`` when drifting)."""
        from repro_torch.ps import (PSTopology, asymmetric_link,
                                    uplink_degradation)
        W = self.workers
        if W is None:
            W = max(len(t) for t in (self.down_gbps, self.up_gbps,
                                     self.worker_flops)
                    if isinstance(t, tuple)) \
                if any(isinstance(t, tuple)
                       for t in (self.down_gbps, self.up_gbps,
                                 self.worker_flops)) else default_workers
        down = self._per_worker(self.down_gbps, W)
        up = self._per_worker(self.up_gbps, W)
        flops = self._per_worker(self.worker_flops, W)
        base = PSTopology(
            num_servers=self.servers,
            links=tuple(asymmetric_link(d * 1e9, u * 1e9)
                        for d, u in zip(down, up)),
            worker_flops=flops)
        if self.up_shift_factor is None:
            return base
        return uplink_degradation(base, factor=self.up_shift_factor,
                                  at_epoch=self.shift_epoch)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Stage-partitioned pipeline execution (``repro_torch.pipeline``).

    ``stages`` contiguous stages balanced by profiled fc + bc, ``schedule``
    micro-batch order (``gpipe`` fill/drain or ``1f1b`` PipeDream-flush),
    and ``chunks`` boundary-tensor chunks per micro-batch for the
    DynaComm-segmented activation transfers (1 ⇒ segment only across
    micro-batches).
    """

    stages: int = 2
    microbatches: int = 2
    schedule: str = "1f1b"
    chunks: int = 1

    def __post_init__(self):
        from repro_torch.pipeline.schedule import SCHEDULES
        if self.stages < 1:
            raise ValueError(f"stages must be >= 1, got {self.stages}")
        if self.microbatches < 1:
            raise ValueError(f"microbatches must be >= 1, got "
                             f"{self.microbatches}")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown pipeline schedule {self.schedule!r}; "
                             f"choose from {list(SCHEDULES)}")
        if self.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """What the scheduler plans against, and how often it re-plans."""

    strategy: str = "dynacomm"
    reschedule_every: int = 20       # steps (sync) / pushes (async) per epoch
    drift_detect: bool = False       # dynamic runtime: EWMA step-time drift
    async_planning: bool = False     # pre-plan epoch e+1 in e's idle window
    plan_cache_size: int = 256       # memoized decisions kept (LRU)
    network: Optional[NetworkConfig] = None
    topology: Optional[TopologyConfig] = None

    def __post_init__(self):
        if self.strategy not in _STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; choose "
                             f"from {sorted(_STRATEGIES)}")
        if self.reschedule_every < 1:
            raise ValueError(f"reschedule_every must be >= 1, got "
                             f"{self.reschedule_every}")
        if self.plan_cache_size < 1:
            raise ValueError(f"plan_cache_size must be >= 1, got "
                             f"{self.plan_cache_size}")
        if self.network is not None and self.topology is not None:
            raise ValueError("give either a network (ZeRO regimes) or a "
                             "topology (PS regimes), not both")


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """How decided plans execute."""

    regime: Optional[str] = None     # None ⇒ derived from the runtime name
    staleness: Optional[int] = None  # ps-async bound k
    throttle: str = "reject"         # ps-async: reject | wait
    aggregate: bool = False          # wait throttle: BSP push aggregation
    zero3: bool = False

    def __post_init__(self):
        if self.regime is not None and \
                self.regime not in set(RUNTIME_REGIMES.values()):
            raise ValueError(f"unknown regime {self.regime!r}; choose from "
                             f"{sorted(set(RUNTIME_REGIMES.values()))}")
        if self.throttle not in _THROTTLES:
            raise ValueError(f"throttle must be one of {_THROTTLES}, got "
                             f"{self.throttle!r}")
        if self.staleness is not None and self.staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {self.staleness}")
        if self.aggregate and self.throttle != "wait":
            raise ValueError("aggregate=True is the wait throttle's BSP "
                             "mode; it cannot be combined with "
                             f"throttle={self.throttle!r}")
        if self.aggregate and self.staleness not in (None, 0):
            raise ValueError(
                f"aggregate=True admits workers in full-fleet cohorts, so "
                f"staleness={self.staleness} would be inert (every commit "
                f"lands at staleness 0) — set staleness to 0 or drop "
                f"aggregation")


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Gradient push compression (``repro_torch.compress``) on the PS regimes.

    ``scheme="int8"`` quantizes each push to int8 with per-tile fp32
    scales; ``"topk"`` keeps the ``topk_fraction`` largest-magnitude
    entries per flat buffer.  ``error_feedback`` carries each push's
    compression error into the next one (per worker, per layer).  Pulls
    always stay fp32 — the paper's asymmetric edge uplink is the
    bottleneck the wire savings target.
    """

    scheme: str = "none"             # none | int8 | topk
    topk_fraction: Optional[float] = None
    error_feedback: bool = True

    def __post_init__(self):
        from repro_torch.compress import SCHEMES
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown compression scheme {self.scheme!r}; "
                             f"choose from {sorted(SCHEMES)}")
        if self.scheme == "topk":
            if self.topk_fraction is None:
                raise ValueError("scheme='topk' needs topk_fraction")
            if not 0.0 < self.topk_fraction <= 1.0:
                raise ValueError(f"topk_fraction must be in (0, 1], got "
                                 f"{self.topk_fraction}")
        elif self.topk_fraction is not None:
            raise ValueError(f"topk_fraction only applies to scheme='topk' "
                             f"(got scheme={self.scheme!r})")

    @property
    def enabled(self) -> bool:
        return self.scheme != "none"

    def build(self):
        """The :class:`repro_torch.compress.Compressor` (``None`` when
        off)."""
        if not self.enabled:
            return None
        from repro_torch.compress import make_compressor
        return make_compressor(self.scheme,
                               topk_fraction=self.topk_fraction,
                               error_feedback=self.error_feedback)


@dataclasses.dataclass(frozen=True)
class FleetEventConfig:
    """One scripted membership/environment change (``repro_torch.fleet``).

    ``kind="join"`` may carry the joining worker's link/compute spec via
    ``down_gbps``/``up_gbps``/``flops`` (defaults when unset);
    ``kind="fail"`` picks ``mode`` (``crash`` | ``stall``);
    ``kind="drift"`` scales the worker's true iteration time by
    ``factor``.
    """

    time: float = 0.0
    kind: str = "join"
    worker: int = 0
    mode: str = "crash"
    factor: float = 1.0
    down_gbps: Optional[float] = None
    up_gbps: Optional[float] = None
    flops: Optional[float] = None

    def __post_init__(self):
        from repro_torch.fleet.membership import FAIL_MODES, FLEET_EVENT_KINDS
        if self.kind not in FLEET_EVENT_KINDS:
            raise ValueError(f"kind must be one of {FLEET_EVENT_KINDS}, "
                             f"got {self.kind!r}")
        if self.mode not in FAIL_MODES:
            raise ValueError(f"mode must be one of {FAIL_MODES}, got "
                             f"{self.mode!r}")
        if self.time < 0:
            raise ValueError(f"time must be >= 0, got {self.time}")
        if self.factor <= 0:
            raise ValueError(f"factor must be positive, got {self.factor}")
        if self.kind != "join" and (self.down_gbps is not None or
                                    self.up_gbps is not None or
                                    self.flops is not None):
            raise ValueError(f"only join events carry a worker spec "
                             f"(got kind={self.kind!r})")

    def build(self):
        """The :class:`repro_torch.fleet.FleetEvent` this block describes."""
        from repro_torch.fleet.membership import FleetEvent, WorkerSpec
        spec = None
        if self.kind == "join" and (self.down_gbps is not None or
                                    self.up_gbps is not None or
                                    self.flops is not None):
            defaults = WorkerSpec()
            spec = WorkerSpec(
                down_bps=(self.down_gbps * 1e9 if self.down_gbps is not None
                          else defaults.down_bps),
                up_bps=(self.up_gbps * 1e9 if self.up_gbps is not None
                        else defaults.up_bps),
                flops=self.flops if self.flops is not None
                else defaults.flops)
        return FleetEvent(time=self.time, kind=self.kind,
                          worker=self.worker, mode=self.mode,
                          factor=self.factor, spec=spec)


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Elastic-fleet knobs of the ``fleet-async`` runtime.

    The membership script comes from either explicit ``events`` or a
    synthesized churn process (``churn`` events per simulated second up
    to ``horizon``, reproducible per ``churn_seed``) — not both.
    ``workers_per_shard > 0`` lets the server's shard count track the
    fleet (``S = ceil(active / workers_per_shard)``), re-sharding in
    place on membership changes.  The remaining knobs parameterize the
    failure detector and the per-worker drift detector.
    """

    events: Tuple[FleetEventConfig, ...] = ()
    churn: float = 0.0               # synthesized events per simulated second
    horizon: float = 0.0             # synthesized-churn time window
    churn_seed: int = 0
    workers_per_shard: int = 0       # 0 ⇒ shard count fixed by topology
    check_interval: float = 0.0      # 0 ⇒ slowest believed iteration
    stall_factor: float = 4.0
    drift_alpha: float = 0.2
    drift_threshold: float = 0.3
    drift_patience: int = 3
    drift_warmup: int = 2

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(
            FleetEventConfig(**e) if isinstance(e, dict) else e
            for e in self.events))
        if self.churn < 0:
            raise ValueError(f"churn must be >= 0, got {self.churn}")
        if self.churn > 0 and self.horizon <= 0:
            raise ValueError("synthesized churn needs a positive horizon")
        if self.churn > 0 and self.events:
            raise ValueError("give either explicit events or synthesized "
                             "churn, not both")
        if self.workers_per_shard < 0:
            raise ValueError(f"workers_per_shard must be >= 0, got "
                             f"{self.workers_per_shard}")
        if self.check_interval < 0:
            raise ValueError(f"check_interval must be >= 0, got "
                             f"{self.check_interval}")
        if self.stall_factor <= 1:
            raise ValueError(f"stall_factor must be > 1, got "
                             f"{self.stall_factor}")
        if not 0 < self.drift_alpha <= 1:
            raise ValueError(f"drift_alpha must be in (0, 1], got "
                             f"{self.drift_alpha}")
        if self.drift_threshold <= 0:
            raise ValueError(f"drift_threshold must be positive, got "
                             f"{self.drift_threshold}")
        if self.drift_patience < 1 or self.drift_warmup < 1:
            raise ValueError("drift_patience and drift_warmup must be >= 1")

    def build_schedule(self, initial_workers):
        """The :class:`repro_torch.fleet.FleetSchedule` this describes."""
        from repro_torch.fleet.membership import FleetSchedule
        if self.churn > 0:
            return FleetSchedule.synthesize(
                initial_workers, churn=self.churn, horizon=self.horizon,
                seed=self.churn_seed)
        return FleetSchedule(tuple(e.build() for e in self.events))

    def build_detector(self):
        """The fleet's :class:`FleetDriftDetector` this describes."""
        from repro_torch.fleet.drift import FleetDriftDetector
        return FleetDriftDetector(alpha=self.drift_alpha,
                                  threshold=self.drift_threshold,
                                  patience=self.drift_patience,
                                  warmup=self.drift_warmup)


@dataclasses.dataclass(frozen=True)
class MeasureConfig:
    """Where fc/bc cost vectors come from."""

    cost_source: str = "analytic"    # analytic | measured
    remeasure_every: int = 1         # re-plan epochs between measurements
    measure_iters: int = 3
    measure_warmup: int = 1
    compute_flops_per_s: float = 1e10   # analytic host rate (ZeRO regimes)

    def __post_init__(self):
        if self.cost_source not in _COST_SOURCES:
            raise ValueError(f"cost_source must be one of {_COST_SOURCES}, "
                             f"got {self.cost_source!r}")
        if self.remeasure_every < 0:
            raise ValueError(f"remeasure_every must be >= 0, got "
                             f"{self.remeasure_every}")
        if self.measure_iters < 1:
            raise ValueError(f"measure_iters must be >= 1, got "
                             f"{self.measure_iters}")
        if self.measure_warmup < 0:
            raise ValueError(f"measure_warmup must be >= 0, got "
                             f"{self.measure_warmup}")
        if self.compute_flops_per_s <= 0:
            raise ValueError(f"compute_flops_per_s must be positive, got "
                             f"{self.compute_flops_per_s}")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """One complete, serializable description of a training run."""

    runtime: str = "zero"
    arch: str = "granite-3-2b"
    reduced: bool = True
    batch: int = 8
    seq: int = 128
    optimizer: str = "adamw"
    lr: float = 3e-4
    seed: int = 0
    aux_weight: float = 0.01
    schedule: ScheduleConfig = dataclasses.field(default_factory=ScheduleConfig)
    execution: ExecutionConfig = dataclasses.field(
        default_factory=ExecutionConfig)
    measure: MeasureConfig = dataclasses.field(default_factory=MeasureConfig)
    compression: CompressionConfig = dataclasses.field(
        default_factory=CompressionConfig)
    fleet: Optional[FleetConfig] = None
    pipeline: Optional[PipelineConfig] = None

    def __post_init__(self):
        if self.runtime not in RUNTIME_REGIMES:
            raise ValueError(f"unknown runtime {self.runtime!r}; choose "
                             f"from {sorted(RUNTIME_REGIMES)}")
        if self.optimizer not in ("adamw", "sgd"):
            raise ValueError(f"optimizer must be 'adamw' or 'sgd', got "
                             f"{self.optimizer!r}")
        if self.batch < 1 or self.seq < 1:
            raise ValueError(f"batch/seq must be >= 1, got "
                             f"{self.batch}/{self.seq}")
        regime = self.regime
        if self.execution.regime is not None and \
                self.execution.regime != regime:
            raise ValueError(
                f"execution.regime {self.execution.regime!r} contradicts "
                f"runtime {self.runtime!r} (which is {regime!r}); leave "
                f"regime unset to derive it")
        # cross-block consistency: fail at construction, not at step 1
        if regime != "ps-async":
            if self.execution.staleness is not None:
                raise ValueError(
                    f"staleness={self.execution.staleness} is a bounded-"
                    f"staleness (ps-async) knob; runtime {self.runtime!r} "
                    f"is synchronous — use runtime='ps-async' or "
                    f"'dynamic-ps-async'")
            if self.execution.aggregate:
                raise ValueError("aggregate=True is a ps-async knob; "
                                 f"runtime {self.runtime!r} is synchronous")
        if regime in ("zero", "local", "pipeline") and \
                self.schedule.topology is not None:
            raise ValueError(f"runtime {self.runtime!r} plans against a "
                             f"scalar network, not a PS topology — drop "
                             f"schedule.topology or pick a ps-* runtime")
        if regime.startswith("ps") and self.schedule.network is not None:
            raise ValueError(f"runtime {self.runtime!r} plans against a PS "
                             f"topology, not a scalar network — drop "
                             f"schedule.network or pick a zero/dynamic "
                             f"runtime")
        if self.runtime in ("zero", "pipeline") and \
                self.schedule.network is not None \
                and self.schedule.network.shift_gbps is not None:
            raise ValueError("a bandwidth shift needs the run-time loop to "
                             "react to it — use runtime='dynamic' (the "
                             f"{self.runtime!r} runtime plans once at "
                             f"startup)")
        if self.runtime in ("ps", "ps-async") and \
                self.schedule.topology is not None and \
                self.schedule.topology.up_shift_factor is not None:
            raise ValueError("an uplink drift needs the run-time loop to "
                             "react to it — use runtime='dynamic-ps' or "
                             f"'dynamic-ps-async' (the {self.runtime!r} "
                             f"runtime plans once at startup)")
        if self.fleet is not None and self.runtime != "fleet-async":
            raise ValueError(f"the fleet block configures the elastic "
                             f"'fleet-async' runtime (got runtime "
                             f"{self.runtime!r})")
        if self.pipeline is not None and self.runtime != "pipeline":
            raise ValueError(f"the pipeline block configures the "
                             f"'pipeline' runtime (got runtime "
                             f"{self.runtime!r})")
        if self.runtime == "pipeline":
            if self.pipeline is None:
                object.__setattr__(self, "pipeline", PipelineConfig())
            if self.batch % self.pipeline.microbatches:
                raise ValueError(
                    f"batch={self.batch} is not divisible by "
                    f"pipeline.microbatches={self.pipeline.microbatches}")
        if self.runtime == "fleet-async":
            if self.execution.aggregate:
                raise ValueError("aggregate=True needs fixed full-fleet "
                                 "cohorts; the elastic fleet-async runtime "
                                 "cannot aggregate — drop aggregation or "
                                 "use runtime='ps-async'")
            if self.schedule.topology is not None and \
                    self.schedule.topology.up_shift_factor is not None:
                raise ValueError("fleet-async re-plans off measured drift "
                                 "and membership events, not a scripted "
                                 "uplink shift — use a fleet drift event "
                                 "instead of up_shift_factor")
        if self.compression.enabled and not regime.startswith("ps"):
            raise ValueError(
                f"compression rides the PS push path (segmented gradient "
                f"uploads); runtime {self.runtime!r} is a {regime!r} regime "
                f"— pick a ps-* runtime or set compression.scheme='none'")
        if self.schedule.drift_detect and self.runtime != "dynamic":
            raise ValueError("drift_detect re-schedules from observed step "
                             "times, which only the 'dynamic' runtime "
                             f"supports (got runtime {self.runtime!r})")
        if self.measure.cost_source == "measured" and \
                self.runtime not in ("dynamic", "dynamic-ps"):
            raise ValueError("cost_source='measured' times the compiled "
                             "per-layer applies, which the dynamic sync "
                             "runtimes do (runtime 'dynamic' or "
                             f"'dynamic-ps'; got {self.runtime!r})")

    # ------------------------------------------------------------------
    # derived views
    # ------------------------------------------------------------------

    @property
    def regime(self) -> str:
        """The execution regime the runtime name implies."""
        return RUNTIME_REGIMES[self.runtime]

    @property
    def is_dynamic(self) -> bool:
        return self.runtime in DYNAMIC_RUNTIMES

    def build_optimizer(self):
        from repro_torch.optim import adamw, sgd
        return adamw(self.lr) if self.optimizer == "adamw" \
            else sgd(self.lr, 0.9)

    # ------------------------------------------------------------------
    # JSON round-trip
    # ------------------------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, *, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, obj: dict) -> "RuntimeConfig":
        obj = dict(obj)

        def sub(key, typ):
            val = obj.get(key)
            if isinstance(val, dict):
                obj[key] = typ(**val)

        sched = obj.get("schedule")
        if isinstance(sched, dict):
            sched = dict(sched)
            for key, typ in (("network", NetworkConfig),
                             ("topology", TopologyConfig)):
                if isinstance(sched.get(key), dict):
                    sched[key] = typ(**sched[key])
            obj["schedule"] = ScheduleConfig(**sched)
        sub("execution", ExecutionConfig)
        sub("measure", MeasureConfig)
        sub("compression", CompressionConfig)
        sub("fleet", FleetConfig)    # nested event dicts handled by its
                                     # __post_init__
        sub("pipeline", PipelineConfig)
        unknown = set(obj) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown RuntimeConfig fields "
                             f"{sorted(unknown)}")
        return cls(**obj)

    @classmethod
    def from_json(cls, text: str) -> "RuntimeConfig":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "RuntimeConfig":
        with open(path) as f:
            return cls.from_json(f.read())
