"""Real-time profiling module (paper Section IV-A).

Produces the cost vectors ``pt, fc, bc, gt`` and the overhead ``Δt`` that
feed the schedulers, from one of three sources:

* **analytic** — per-layer FLOP/byte counts (from the model zoo's
  ``layer_profiles()`` or from ``compiled.cost_analysis()`` in the dry-run)
  pushed through a hardware model (`EdgeNetworkModel` for the paper's
  testbed, `TPUSystemModel` for the adaptation target);
* **measured** — wall-clock timing of jitted per-layer forward/VJP callables
  (the CPU-runtime analogue of mxnet.profiler), median of repeated runs;
* **recorded** — literal cost vectors (used by the Fig. 12 complexity
  benchmark on randomly generated profiles, as in the paper).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.costmodel import LayerCosts
from repro_torch.core.netmodel import EdgeNetworkModel, TPUSystemModel


@dataclasses.dataclass(frozen=True)
class LayerProfile:
    """Static per-layer workload description."""

    name: str
    param_bytes: float
    flops_fwd: float
    flops_bwd: float | None = None     # default: 2x forward (dL/dx + dL/dw)
    grad_bytes: float | None = None    # default: == param_bytes

    @property
    def bwd(self) -> float:
        return 2.0 * self.flops_fwd if self.flops_bwd is None else self.flops_bwd

    @property
    def gbytes(self) -> float:
        return self.param_bytes if self.grad_bytes is None else self.grad_bytes


def costs_from_profiles(profiles: Sequence[LayerProfile],
                        *,
                        net: EdgeNetworkModel | TPUSystemModel,
                        compute_flops_per_s: float | None = None) -> LayerCosts:
    """Analytic cost vectors from layer workloads + a hardware model.

    ``compute_flops_per_s`` overrides the compute rate (needed for the edge
    regime, where `EdgeNetworkModel` has no compute side — the paper's Xeon
    workers); for `TPUSystemModel` it defaults to peak*mfu.
    """
    pbytes = np.array([p.param_bytes for p in profiles], dtype=np.float64)
    gbytes = np.array([p.gbytes for p in profiles], dtype=np.float64)
    f_fwd = np.array([p.flops_fwd for p in profiles], dtype=np.float64)
    f_bwd = np.array([p.bwd for p in profiles], dtype=np.float64)

    pt = net.transfer_time(pbytes)
    gt = net.transfer_time(gbytes)
    if compute_flops_per_s is not None:
        fc = f_fwd / compute_flops_per_s
        bc = f_bwd / compute_flops_per_s
    elif isinstance(net, TPUSystemModel):
        fc = net.compute_time(f_fwd)
        bc = net.compute_time(f_bwd)
    else:
        raise ValueError("edge regime requires compute_flops_per_s")
    return LayerCosts(pt=pt, fc=fc, bc=bc, gt=gt, dt=net.dt)


# ---------------------------------------------------------------------------
# Measured profiling (CPU runtime)
# ---------------------------------------------------------------------------


def _cuda_devices(x, out: dict) -> None:
    """Collect the devices of every CUDA leaf of a tensor / tuple / list /
    dict structure (the walk ``jax.block_until_ready`` makes of a pytree)."""
    if isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    elif getattr(x, "is_cuda", False) is True:
        out[str(x.device)] = x.device


def _block(x):
    """Wait for every CUDA device that holds a leaf of ``x``."""
    devices: dict = {}
    _cuda_devices(x, devices)
    if devices:
        import torch
        for device in devices.values():
            torch.cuda.synchronize(device)
    return x


def time_callable(fn: Callable, *args, iters: int = 5, warmup: int = 2) -> float:
    """Median wall-clock seconds of ``fn(*args)`` (blocking on the result)."""
    for _ in range(warmup):
        _block(fn(*args))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args))
        samples.append(time.perf_counter() - t0)
    return float(np.median(samples))


def measure_layer_costs(fwd_fns: Sequence[Callable],
                        bwd_fns: Sequence[Callable],
                        fwd_args: Sequence[tuple],
                        bwd_args: Sequence[tuple],
                        *,
                        param_bytes: Sequence[float],
                        net: EdgeNetworkModel | TPUSystemModel,
                        iters: int = 5) -> LayerCosts:
    """Wall-clock fc/bc per layer; pt/gt analytic from bytes + network model.

    This mirrors the paper's deployment: compute costs are *profiled* on the
    worker, transmission costs follow the network condition.
    """
    fc = np.array([time_callable(f, *a, iters=iters)
                   for f, a in zip(fwd_fns, fwd_args)])
    bc = np.array([time_callable(f, *a, iters=iters)
                   for f, a in zip(bwd_fns, bwd_args)])
    pb = np.asarray(param_bytes, dtype=np.float64)
    return LayerCosts(pt=net.transfer_time(pb), fc=fc, bc=bc,
                      gt=net.transfer_time(pb), dt=net.dt)


class LayerTimingHook:
    """Per-(phase, layer) wall-clock accumulator for jitted per-layer applies.

    The run-time analogue of the paper's mxnet.profiler hook: the dynamic
    trainer wraps each sched layer's jitted forward / VJP callable with
    :meth:`timed`, every call records a blocking wall-clock sample, and
    :meth:`median` turns the samples into the ``fc`` / ``bc`` cost vectors
    (dropping the first ``warmup`` samples per key, which include compile
    time).  Phases are free-form strings; the trainer uses ``"fc"``/``"bc"``.
    """

    def __init__(self, warmup: int = 1):
        if warmup < 0:
            raise ValueError(f"warmup must be >= 0, got {warmup}")
        self.warmup = warmup
        self._samples: dict[tuple[str, int], list[float]] = {}

    def record(self, phase: str, layer: int, seconds: float) -> None:
        self._samples.setdefault((phase, layer), []).append(float(seconds))

    def timed(self, phase: str, layer: int, fn: Callable) -> Callable:
        """Wrap ``fn`` so each call blocks on its result and records."""
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = _block(fn(*args, **kwargs))
            self.record(phase, layer, time.perf_counter() - t0)
            return out
        return wrapped

    def num_samples(self, phase: str, layer: int) -> int:
        return len(self._samples.get((phase, layer), ()))

    def median(self, phase: str, num_layers: int) -> np.ndarray:
        """Per-layer median seconds for ``phase`` over layers 0..L-1."""
        out = np.zeros(num_layers, dtype=np.float64)
        for l in range(num_layers):
            samples = self._samples.get((phase, l), [])[self.warmup:]
            if not samples:
                raise ValueError(
                    f"no post-warmup samples for phase {phase!r} layer {l} "
                    f"(have {self.num_samples(phase, l)}, warmup "
                    f"{self.warmup}); call each timed fn >= warmup+1 times")
            out[l] = float(np.median(samples))
        return out

    def costs(self, *, param_bytes: Sequence[float],
              net: EdgeNetworkModel | TPUSystemModel,
              grad_bytes: Sequence[float] | None = None) -> LayerCosts:
        """Assemble ``LayerCosts``: measured fc/bc + analytic pt/gt/Δt."""
        pb = np.asarray(param_bytes, dtype=np.float64)
        gb = pb if grad_bytes is None else np.asarray(grad_bytes, np.float64)
        L = pb.shape[0]
        return LayerCosts(pt=net.transfer_time(pb), fc=self.median("fc", L),
                          bc=self.median("bc", L), gt=net.transfer_time(gb),
                          dt=net.dt)

    def reset(self) -> None:
        self._samples.clear()


class EwmaDriftDetector:
    """Detect run-time drift from *observed* step times (no scripted
    ``NetworkSchedule`` needed).

    Keeps an exponentially-weighted moving average of per-step wall time;
    when ``patience`` consecutive samples deviate from the baseline by more
    than ``threshold`` (relative), :meth:`update` returns ``True`` once and
    the baseline re-seeds from the drifted sample — so a persistent shift
    (the uplink degraded, a worker slowed down) fires exactly one trigger,
    while one-off stragglers (GC pause, preemption blip) are absorbed.

    The first ``warmup`` samples only seed the baseline (they include
    compile time and cache-cold effects) and can never trigger.
    """

    def __init__(self, *, alpha: float = 0.2, threshold: float = 0.3,
                 patience: int = 3, warmup: int = 2):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if threshold <= 0.0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        if warmup < 0:
            raise ValueError(f"warmup must be >= 0, got {warmup}")
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.warmup = warmup
        self.reset()

    @property
    def baseline(self) -> float | None:
        """Current EWMA of non-drifting step times (None before samples)."""
        return self._ewma

    @property
    def num_triggers(self) -> int:
        return self._triggers

    def update(self, seconds: float) -> bool:
        """Feed one observed step time; True ⇒ drift detected this step."""
        if seconds < 0:
            raise ValueError(f"step time must be >= 0, got {seconds}")
        self._seen += 1
        if self._seen <= self.warmup or self._ewma is None:
            # warmup seeds (and re-seeds after a reset) the baseline
            self._ewma = seconds if self._ewma is None else (
                self.alpha * seconds + (1 - self.alpha) * self._ewma)
            return False
        rel = abs(seconds - self._ewma) / max(self._ewma, 1e-12)
        if rel > self.threshold:
            self._streak += 1
            if self._streak >= self.patience:
                # persistent shift: trigger once, re-seed from the new regime
                self._ewma = seconds
                self._streak = 0
                self._triggers += 1
                return True
            return False                 # suspicious, but within patience
        self._streak = 0
        self._ewma = self.alpha * seconds + (1 - self.alpha) * self._ewma
        return False

    def state_dict(self) -> dict:
        """Checkpointable detector state (baseline, counters)."""
        return {"ewma": self._ewma, "seen": self._seen,
                "streak": self._streak, "triggers": self._triggers}

    def load_state_dict(self, state: dict) -> None:
        self._ewma = None if state["ewma"] is None else float(state["ewma"])
        self._seen = int(state["seen"])
        self._streak = int(state["streak"])
        self._triggers = int(state["triggers"])

    def reset(self) -> None:
        self._ewma: float | None = None
        self._seen = 0
        self._streak = 0
        self._triggers = 0


def random_costs(L: int, *, seed: int = 0, dt: float = 1e-2,
                 comm_scale: float = 1.0, comp_scale: float = 1.0) -> LayerCosts:
    """Randomly generated profiling results (paper Fig. 12 methodology)."""
    rng = np.random.default_rng(seed)
    return LayerCosts(
        pt=rng.uniform(0.1, 10.0, L) * 1e-3 * comm_scale,
        fc=rng.uniform(0.1, 10.0, L) * 1e-3 * comp_scale,
        bc=rng.uniform(0.2, 20.0, L) * 1e-3 * comp_scale,
        gt=rng.uniform(0.1, 10.0, L) * 1e-3 * comm_scale,
        dt=dt,
    )
