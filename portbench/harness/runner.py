"""One run of one cell: the generator, the metrics, the check, the line.

A generator (``portbench/gen/<kind>.py``) sets the cell up, measures the
window, checks what the window produced against the reference and
returns an :class:`Outcome`.  This module turns it into the result: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, each from its reader; then ``device``, the trace's
``breakdown`` and, last, every compared number beside its limit.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from typing import Any, Dict, Optional, Tuple

from portbench.harness import checks, env
from portbench.harness.cell import Cell
from portbench.harness.trace import Trace


@dataclasses.dataclass
class Outcome:
    e2e: Dict[str, float]            # end-to-end metric -> value
    numbers: Dict[str, float]        # compared number -> value
    attempted: int
    failed: int
    peak_bytes: int
    facts: Dict[str, Any]            # what the per-layer readers read
    trace: Optional[Trace] = None
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Record:
    """What a per-layer metric's ``read(record)`` sees."""

    cell: Cell
    peaks: Optional[Dict[str, Any]]  # the card's published peaks
    trace: Optional[Trace]
    facts: Dict[str, Any]


def _finite(x: float) -> Optional[float]:
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def result(cell: Cell, outcome: Outcome, device, traced: bool
           ) -> Dict[str, Any]:
    kind = env.device_record(device, cell.chips, outcome.peak_bytes)
    metrics: Dict[str, Dict[str, Any]] = {}
    if traced:
        record = Record(cell=cell, peaks=env.peaks(kind["kind"]),
                        trace=outcome.trace, facts=outcome.facts)
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": outcome.e2e[m["name"]],
                                  "unit": m["unit"]}
    ok, compared = checks.verdict(outcome.numbers, cell.limits)
    out: Dict[str, Any] = {
        "correct": bool(ok and outcome.failed == 0),
        "attempted": outcome.attempted, "failed": outcome.failed,
        "metrics": metrics, "device": kind}
    if traced and outcome.trace is not None:
        kind["busy_s"] = outcome.trace.busy_s
        kind["window_s"] = outcome.trace.window_s
        out["breakdown"] = {"device_ops": outcome.trace.device_ops(),
                            "idle_gaps": outcome.trace.idle_gaps()}
    out["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                     for k, v in compared.items()}
    return out


def emit(line: Dict[str, Any], notes: Dict[str, Any]) -> None:
    """The run's notes, then the compared numbers as the last lines on
    stderr; the result as the last line on stdout."""
    print(f"notes {json.dumps(notes)}", file=sys.stderr, flush=True)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t0: float, work_dir) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Set up, measure and check one run: the result line's dict and the
    run's notes (the checked losses, the leaves the gaps come from).  The
    process group the port made is destroyed before it returns."""
    import torch.distributed as dist
    try:
        outcome = cell.generator().run(cell, seed, seconds, traced, device,
                                       t0, work_dir)
        return result(cell, outcome, device, traced), outcome.notes
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
