"""Micro-batch pipeline schedules as deterministic event streams.

Two classic schedules over S stages × M micro-batches:

* **gpipe** — fill/drain: every stage runs all M forwards in micro-batch
  order, then all M backwards in reverse order;
* **1f1b** — PipeDream-flush: stage s warms up with ``min(S-s-1, M)``
  forwards, then alternates one-forward-one-backward, then drains.

Both are emitted as *per-stage totally-ordered task streams*
(:class:`StageTask` tuples) — pure data, no wall clock — and both admit
the same analytic bubble fraction under uniform stage costs::

    bubble / total = (S - 1) / (M + S - 1)

:func:`simulate` replays a schedule against per-stage forward/backward
durations and per-boundary transfer times with an exact event-driven
sweep, so tests can assert the analytic accounting *equals* simulated
idle time and benches can price non-uniform stages and slow links.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

FORWARD = "F"
BACKWARD = "B"

SCHEDULES = ("gpipe", "1f1b")


@dataclasses.dataclass(frozen=True)
class StageTask:
    """One unit of stage work: micro-batch ``microbatch``'s F or B pass."""

    stage: int
    microbatch: int
    kind: str        # FORWARD | BACKWARD

    def __post_init__(self):
        if self.kind not in (FORWARD, BACKWARD):
            raise ValueError(f"kind must be 'F' or 'B', got {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class PipelineSchedule:
    """Per-stage ordered task streams for one optimizer step."""

    name: str
    num_stages: int
    num_microbatches: int
    streams: Tuple[Tuple[StageTask, ...], ...]   # streams[s] = stage s's order

    def __post_init__(self):
        if len(self.streams) != self.num_stages:
            raise ValueError("one stream per stage required")
        for s, stream in enumerate(self.streams):
            fs = [t.microbatch for t in stream if t.kind == FORWARD]
            bs = [t.microbatch for t in stream if t.kind == BACKWARD]
            if sorted(fs) != list(range(self.num_microbatches)) or \
                    sorted(bs) != list(range(self.num_microbatches)):
                raise ValueError(f"stage {s} stream must contain each "
                                 f"micro-batch exactly once per direction")


def gpipe_schedule(num_stages: int, num_microbatches: int) -> PipelineSchedule:
    """Fill/drain: all forwards, then all backwards in reverse order."""
    S, M = _check(num_stages, num_microbatches)
    streams = []
    for s in range(S):
        stream = [StageTask(s, m, FORWARD) for m in range(M)]
        stream += [StageTask(s, m, BACKWARD) for m in reversed(range(M))]
        streams.append(tuple(stream))
    return PipelineSchedule(name="gpipe", num_stages=S, num_microbatches=M,
                            streams=tuple(streams))


def one_f_one_b_schedule(num_stages: int,
                         num_microbatches: int) -> PipelineSchedule:
    """PipeDream-flush (1F1B): warmup, steady 1F1B alternation, drain.

    Stage s admits at most ``S - s`` in-flight micro-batches, so peak
    activation memory is O(S) instead of GPipe's O(M)."""
    S, M = _check(num_stages, num_microbatches)
    streams = []
    for s in range(S):
        warmup = min(S - s - 1, M)
        stream = [StageTask(s, m, FORWARD) for m in range(warmup)]
        for i in range(M - warmup):
            stream.append(StageTask(s, warmup + i, FORWARD))
            stream.append(StageTask(s, i, BACKWARD))
        for m in range(M - warmup, M):
            stream.append(StageTask(s, m, BACKWARD))
        streams.append(tuple(stream))
    return PipelineSchedule(name="1f1b", num_stages=S, num_microbatches=M,
                            streams=tuple(streams))


def make_schedule(name: str, num_stages: int,
                  num_microbatches: int) -> PipelineSchedule:
    if name == "gpipe":
        return gpipe_schedule(num_stages, num_microbatches)
    if name == "1f1b":
        return one_f_one_b_schedule(num_stages, num_microbatches)
    raise ValueError(f"unknown pipeline schedule {name!r}; "
                     f"choose from {list(SCHEDULES)}")


def _check(num_stages: int, num_microbatches: int) -> Tuple[int, int]:
    if num_stages < 1:
        raise ValueError(f"num_stages must be >= 1, got {num_stages}")
    if num_microbatches < 1:
        raise ValueError(
            f"num_microbatches must be >= 1, got {num_microbatches}")
    return int(num_stages), int(num_microbatches)


def analytic_bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """Idle share of stage-time under uniform costs: (S-1)/(M+S-1).

    Both gpipe and 1f1b pay exactly S-1 micro-batch slots of fill plus
    drain per direction; the fraction is of *total* stage time (busy +
    bubble), matching :attr:`PipelineTimeline.bubble_fraction`."""
    S, M = _check(num_stages, num_microbatches)
    return (S - 1) / (M + S - 1)


@dataclasses.dataclass(frozen=True)
class PipelineTimeline:
    """Exact replay of a schedule against stage/link costs."""

    makespan: float
    stage_busy: Tuple[float, ...]
    stage_idle: Tuple[float, ...]            # makespan - busy, per stage
    task_times: Dict[Tuple[int, int, str], Tuple[float, float]]

    @property
    def bubble_fraction(self) -> float:
        total = self.makespan * len(self.stage_busy)
        return 1.0 - sum(self.stage_busy) / total if total > 0 else 0.0


def simulate(sched: PipelineSchedule,
             fwd_times: Sequence[float],
             bwd_times: Sequence[float],
             *,
             fwd_transfer: Optional[Sequence[float]] = None,
             bwd_transfer: Optional[Sequence[float]] = None
             ) -> PipelineTimeline:
    """Event-driven replay: per-stage serial execution + boundary deps.

    ``fwd_times[s]`` / ``bwd_times[s]`` are per-micro-batch stage
    durations; ``fwd_transfer[b]`` / ``bwd_transfer[b]`` are the
    *effective* activation / activation-grad transfer times across
    boundary b (stage b → b+1), i.e. whatever the transfer planner says
    the receiving stage must wait beyond the producer finishing —
    DynaComm-segmented overlap shows up here as a smaller effective wait.

    F(s, m) needs F(s-1, m) + fwd_transfer[s-1]; B(s, m) needs
    B(s+1, m) + bwd_transfer[s] (last stage: its own F(s, m)).  Stages
    are serial in stream order.  Pure float arithmetic — deterministic.
    """
    S, M = sched.num_stages, sched.num_microbatches
    fwd = [float(x) for x in fwd_times]
    bwd = [float(x) for x in bwd_times]
    if len(fwd) != S or len(bwd) != S:
        raise ValueError("need one fwd/bwd duration per stage")
    fx = [0.0] * max(S - 1, 0) if fwd_transfer is None \
        else [float(x) for x in fwd_transfer]
    bx = [0.0] * max(S - 1, 0) if bwd_transfer is None \
        else [float(x) for x in bwd_transfer]
    if len(fx) != S - 1 or len(bx) != S - 1:
        raise ValueError("need one transfer time per boundary (S-1)")

    done: Dict[Tuple[int, int, str], Tuple[float, float]] = {}
    cursor = [0] * S          # next stream index per stage
    clock = [0.0] * S         # stage free time

    def ready(task: StageTask) -> Optional[float]:
        s, m = task.stage, task.microbatch
        if task.kind == FORWARD:
            if s == 0:
                return 0.0
            dep = done.get((s - 1, m, FORWARD))
            return None if dep is None else dep[1] + fx[s - 1]
        if s == S - 1:
            dep = done.get((s, m, FORWARD))
            return None if dep is None else dep[1]
        dep = done.get((s + 1, m, BACKWARD))
        return None if dep is None else dep[1] + bx[s]

    remaining = sum(len(st) for st in sched.streams)
    while remaining:
        progressed = False
        for s in range(S):
            while cursor[s] < len(sched.streams[s]):
                task = sched.streams[s][cursor[s]]
                at = ready(task)
                if at is None:
                    break
                start = max(clock[s], at)
                dur = fwd[s] if task.kind == FORWARD else bwd[s]
                end = start + dur
                done[(task.stage, task.microbatch, task.kind)] = (start, end)
                clock[s] = end
                cursor[s] += 1
                remaining -= 1
                progressed = True
        if not progressed:
            raise RuntimeError("pipeline schedule deadlocked (cyclic deps)")

    makespan = max(clock) if clock else 0.0
    busy = tuple(M * (fwd[s] + bwd[s]) for s in range(S))
    idle = tuple(makespan - b for b in busy)
    return PipelineTimeline(makespan=makespan, stage_busy=busy,
                            stage_idle=idle, task_times=done)
