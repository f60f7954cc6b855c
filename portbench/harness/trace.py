"""A traced window under ``torch.profiler`` and the readings taken from it.

The window is one ``record_function`` span (``WINDOW``) around the traced
work, which ends in a synchronisation, so every device operation it
launched lies inside it.  From the exported Chrome trace:

* device intervals: kernels, memcpys and memsets (``cat`` ``kernel``,
  ``gpu_memcpy``, ``gpu_memset``);
* host launches: the CUDA runtime / driver calls that enqueue device work
  (kernel, memcpy, memset and graph launches);
* spans: ``user_annotation`` events (``record_function``), on the host.

Busy time is the **union** of the device intervals inside the window, so
overlapping kernels count once; the idle share is ``1 - busy / window``.
A kernel is attributed to a span by its launch: the runtime call with the
kernel's ``correlation`` id lies inside the span's interval (spans are the
window thread's; the autograd engine launches a backward from a thread of
its own, so work it does while the span's thread waits is not the span's).
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

WINDOW = "portbench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH = re.compile(r"LaunchKernel|cuLaunch|Memcpy|Memset|GraphLaunch")
# cuBLAS / CUTLASS matrix products (SGEMM, GEMV and their xmma forms)
GEMM = re.compile(r"gemm|gemv|cutlass|xmma|cublas", re.IGNORECASE)


@dataclasses.dataclass
class Trace:
    window: Tuple[float, float]                    # µs, host clock
    device: List[Tuple[float, float, str, int]]    # (start, end, name, corr)
    launches: List[Tuple[float, int]]              # (ts, correlation)
    spans: Dict[str, List[Tuple[float, float]]]    # name -> [(start, end)]
    host_ops: List[Tuple[float, float, str]]       # every thread's ops

    # -- construction -------------------------------------------------

    @classmethod
    def from_chrome(cls, data: Dict) -> "Trace":
        events = [e for e in data.get("traceEvents", [])
                  if e.get("ph") == "X"]
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError(f"the trace has no {WINDOW!r} span")
        w = win[0]
        lo, hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        tid = w.get("tid")
        device, launches, host_ops = [], [], []
        spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        for e in events:
            cat = e.get("cat")
            ts = float(e["ts"])
            end = ts + float(e.get("dur", 0.0))
            corr = int(e.get("args", {}).get("correlation", -1))
            if cat in DEVICE_CATS:
                device.append((ts, end, e.get("name", ""), corr))
            elif cat in RUNTIME_CATS:
                if LAUNCH.search(e.get("name", "")):
                    launches.append((ts, corr))
            elif cat == "user_annotation":
                if e["name"] != WINDOW:
                    host_ops.append((ts, end, e["name"]))
                    if e.get("tid") == tid:
                        spans[e["name"]].append((ts, end))
            elif cat == "cpu_op":
                host_ops.append((ts, end, e.get("name", "")))
        device.sort()
        launches.sort()
        host_ops.sort()
        return cls(window=(lo, hi), device=device, launches=launches,
                   spans=dict(spans), host_ops=host_ops)

    # -- readings -----------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _union(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        out: List[List[float]] = []
        for s, e, _, _ in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._union()) / 1e6

    def device_time(self, pattern: re.Pattern) -> float:
        """Seconds of device operations whose name matches."""
        return sum(e - s for s, e, n, _ in self.device
                   if pattern.search(n)) / 1e6

    def count(self, pattern: re.Pattern) -> int:
        return sum(1 for _, _, n, _ in self.device if pattern.search(n))

    def launches_in(self, intervals: Sequence[Tuple[float, float]]) -> int:
        """Host launch calls made inside any of ``intervals`` (µs)."""
        ts = [t for t, _ in self.launches]
        return sum(bisect.bisect_right(ts, b) - bisect.bisect_left(ts, a)
                   for a, b in intervals)

    def device_time_under(self, span: str,
                          exclude: Optional[re.Pattern] = None) -> float:
        """Seconds of device work launched inside a ``span`` span,
        leaving out operations whose name matches ``exclude``."""
        intervals = sorted(self.spans.get(span, []))
        if not intervals:
            return 0.0
        starts = [a for a, _ in intervals]
        launched = {}
        for t, corr in self.launches:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= intervals[i][1]:
                launched[corr] = True
        total = 0.0
        for s, e, n, corr in self.device:
            if corr in launched and not (exclude and exclude.search(n)):
                total += e - s
        return total / 1e6

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for s, e, n, _ in self.device:
            by[n] += (e - s) / 1e6
        return [[n, t] for n, t in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle device time inside the window, summed by what the host
        was doing when each gap began: the op or span, on any thread,
        that began last among those running then."""
        lo, hi = self.window
        union = self._union()
        gaps, t = [], lo
        for a, b in union:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        starts = [s for s, _, _ in self.host_ops]
        by: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            label = "host outside any op"
            i = bisect.bisect_right(starts, a) - 1
            for j in range(i, max(i - 4000, -1), -1):
                s, e, n = self.host_ops[j]
                if e >= a:
                    label = n
                    break
            by[label] += (b - a) / 1e6
        return [[n, t] for n, t in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def span_intervals(self, span: str) -> List[Tuple[float, float]]:
        return sorted(self.spans.get(span, []))


def traced(fn: Callable[[], None], work_dir: Path, cuda: bool) -> Trace:
    """Run ``fn`` (which must end in a synchronisation) under the
    profiler inside the ``WINDOW`` span and read its trace."""
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            fn()
    path = Path(work_dir) / "trace.json"
    prof.export_chrome_trace(str(path))
    try:
        data = json.loads(path.read_text())
    finally:
        path.unlink(missing_ok=True)
    return Trace.from_chrome(data)
