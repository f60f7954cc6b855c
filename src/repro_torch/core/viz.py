"""ASCII timeline rendering of a scheduled iteration (Fig. 2/3 style).

``render_timeline`` draws the link lane and the compute lane of one phase
as a proportional text Gantt chart — the quickest way to *see* what a
decomposition decision does to the overlap structure.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.costmodel import LayerCosts, Segment, TopologyCosts
from repro_torch.core.simulator import (simulate_backward, simulate_forward,
                                  simulate_ps_iteration)


def _lane(events, t_end: float, width: int, fill: str) -> str:
    lane = [" "] * width
    for e in events:
        lo = int(round(e.start / t_end * (width - 1)))
        hi = max(lo + 1, int(round(e.end / t_end * (width - 1))))
        for i in range(lo, min(hi, width)):
            lane[i] = fill
        if hi - lo >= 3:
            label = f"{e.layers[0]}" if e.layers[0] == e.layers[1] \
                else f"{e.layers[0]}-{e.layers[1]}"
            for j, ch in enumerate(label[:hi - lo - 1]):
                lane[lo + j] = ch
    return "".join(lane)


def render_timeline(costs: LayerCosts, segments: Sequence[Segment], *,
                    phase: str = "forward", width: int = 78) -> str:
    if phase == "forward":
        events, t_end = simulate_forward(costs, segments)
        comm_kind, comp_kind = "pt", "fc"
    else:
        events, t_end = simulate_backward(costs, segments)
        comm_kind, comp_kind = "gt", "bc"
    comm = [e for e in events if e.kind == comm_kind]
    comp = [e for e in events if e.kind == comp_kind]
    lines = [
        f"{phase}: {len(segments)} transmission mini-procedure(s), "
        f"makespan {t_end:.4f}s",
        "link    |" + _lane(comm, t_end, width, "=") + "|",
        "compute |" + _lane(comp, t_end, width, "#") + "|",
    ]
    return "\n".join(lines)


def render_ps_timeline(topo: TopologyCosts, decisions, *,
                       width: int = 78) -> str:
    """Per-worker lanes of one PS iteration, on a shared time axis.

    Each worker gets a link lane (``=`` pulls / pushes, labelled with the
    1-indexed layer range of the segment) and a compute lane (``#``); all
    lanes are normalized to the topology *makespan* so straggling and
    barrier idle time are visible at a glance.  ``decisions`` follows
    :func:`repro_torch.core.simulator.simulate_ps_iteration` (one shared decision
    or one per worker)."""
    tl = simulate_ps_iteration(topo, decisions)
    span = tl.makespan
    lines = [f"PS iteration: {tl.num_workers} worker(s), makespan "
             f"{span:.4f}s (straggler: worker {tl.straggler})"]
    for w, wtl in enumerate(tl.workers):
        fwd, bwd = wtl.forward_events, wtl.backward_events
        # backward events happen after the forward phase on this worker
        shifted = [dataclasses.replace(e, start=e.start + wtl.forward_time,
                                       end=e.end + wtl.forward_time)
                   for e in bwd]
        comm = [e for e in list(fwd) + shifted if e.kind in ("pt", "gt")]
        comp = [e for e in list(fwd) + shifted if e.kind in ("fc", "bc")]
        wait = span - wtl.total
        lines.append(f"worker {w}: iter {wtl.total:.4f}s, barrier wait "
                     f"{wait:.4f}s")
        lines.append("  link    |" + _lane(comm, span, width, "=") + "|")
        lines.append("  compute |" + _lane(comp, span, width, "#") + "|")
    return "\n".join(lines)
