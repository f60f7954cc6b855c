"""Readings of the port's own spans (``repro_torch.tracing``) in a traced
window.

The port names its spans ``repro_torch.<name>`` and enters them only
while a profiler records, so they appear in the traced run alone, and a
checkout of the port without them gives no interval: each reading is then
``None`` or nothing.  Spans of the window's thread are in ``Trace.spans``;
a span the autograd engine opens on a thread of its own
(``moe.backward``) only in ``Trace.host_ops``.  Device work is the
span's by launch, as ``Trace.device_time_under`` attributes it: a launch
from any thread inside the interval (the window's thread waits in
``torch.autograd.grad`` while the engine's thread launches the backward).
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

PREFIX = "repro_torch."
Intervals = List[Tuple[float, float]]


def window_spans(trace, name: str) -> Intervals:
    """The port's span ``name`` on the window's thread (µs)."""
    return trace.span_intervals(PREFIX + name)


def any_thread_spans(trace, name: str) -> Intervals:
    """The port's span ``name`` on any thread (µs)."""
    return sorted((s, e) for s, e, n in trace.host_ops if n == PREFIX + name)


def merged(intervals: Sequence[Tuple[float, float]]) -> Intervals:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def launched_s(trace, intervals: Sequence[Tuple[float, float]]) -> float:
    """Seconds of device work launched inside any of ``intervals``."""
    spans = merged(intervals)
    starts = [s for s, _ in spans]
    launched = set()
    for t, corr in trace.launches:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            launched.add(corr)
    return sum(e - s for s, e, _, corr in trace.device
               if corr in launched) / 1e6


def open_s(intervals: Sequence[Tuple[float, float]]) -> float:
    """Seconds during which any of ``intervals`` is open."""
    return sum(e - s for s, e in merged(intervals)) / 1e6


def idle_s(trace, intervals: Sequence[Tuple[float, float]]) -> float:
    """Seconds during which one of ``intervals`` is open and the card runs
    nothing: their length minus their overlap with the union of the
    device intervals."""
    spans = merged(intervals)
    busy = trace._union()
    overlap, j = 0.0, 0
    for s, e in spans:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            overlap += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return open_s(spans) - overlap / 1e6


def steps(record) -> Optional[int]:
    """The traced training steps, or ``None`` without a trace."""
    f = record.facts.get("traced")
    if record.trace is None or not f or not f.get("steps"):
        return None
    return f["steps"]


def device_ms_per_step(record, *names: str) -> Optional[float]:
    """Device ms a traced step launched inside the window thread's spans
    ``names``; ``None`` where the trace holds none of them."""
    n = steps(record)
    if n is None:
        return None
    t = record.trace
    if not any(window_spans(t, name) for name in names):
        return None
    return 1e3 * sum(t.device_time_under(PREFIX + name)
                     for name in names) / n
