"""The reader of the decode loop's graph replays on a trace and counters
made by hand: the replayed share of the traced decode steps, and nothing
where the port has no such counter (its parent) or the trace no decode
step."""

import sys

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench.harness import cell as cells, spans
from portbench.harness.runner import Record
from portbench.harness.trace import Trace

NAME = "serve.graph_replay_share"


def reader():
    return cells.load_module(cells.reader_path(cells.ROOT, NAME), NAME)


def decode_trace(steps):
    """``steps`` decode steps of 1 ms on the window's thread."""
    opened = [(1000.0 * i, 1000.0 * i + 900.0) for i in range(steps)]
    return Trace(window=(0.0, 1e6), device=[(0.0, 10.0, "gemm", 1)],
                 launches=[(0.0, 1)],
                 spans={spans.PREFIX + "serve.decode_step": opened},
                 host_ops=[])


def record(t):
    return Record(cell=None, peaks=None, trace=t, facts={})


def test_the_replay_share_reads_the_ports_counter(monkeypatch):
    from repro_torch import tracing
    r = reader()
    tracing.reset_counters()
    assert r.read(record(decode_trace(64))) is None        # no counter
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(64):
            tracing.count("serve.graph_replays", 1)
    try:
        assert r.read(record(decode_trace(64))) == pytest.approx(100.0)
        assert r.read(record(decode_trace(128))) == pytest.approx(50.0)
        assert r.read(record(decode_trace(0))) is None
        assert r.read(record(None)) is None
        # a port without the tracing module
        import repro_torch
        monkeypatch.delattr(repro_torch, "tracing")
        monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
        assert r.read(record(decode_trace(64))) is None
    finally:
        tracing.reset_counters()


def test_the_metric_is_declared_for_the_serving_cell():
    bench = cells.load_benchmark()
    (metric,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert metric["workloads"] == ["granite-3-2b.serve-decode"]
    assert reader().MOVES == metric["moves"] == "itl_ms_p95"
    cell = cells.resolve(bench, "granite-3-2b.serve-decode")
    assert NAME in cell.readers
