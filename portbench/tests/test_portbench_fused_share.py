"""The reader of the AdamW kernel's share of the buffer updates on
counters made by hand: the fused share of the counted buffers, and
nothing where the port has no such counters (its parent) or the run no
trace."""

import sys

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench.harness import cell as cells
from portbench.harness.runner import Record
from portbench.harness.trace import Trace

NAME = "optim.fused_share.train"
TRAINING = ["granite-3-2b.zero", "granite-moe-1b-a400m.zero",
            "granite-3-2b.dynamic-measured", "granite-4.0-h-small.zero-4k"]


def reader():
    return cells.load_module(cells.reader_path(cells.ROOT, NAME), NAME)


def record(traced=True):
    trace = Trace(window=(0.0, 1e4), device=[(0.0, 10.0, "adamw", 1)],
                  launches=[(0.0, 1)], spans={}, host_ops=[]) \
        if traced else None
    return Record(cell=None, peaks=None, trace=trace, facts={})


def test_the_fused_share_reads_the_ports_counters(monkeypatch):
    from repro_torch import tracing
    r = reader()
    tracing.reset_counters()
    assert r.read(record()) is None                    # no counters
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                tracing.count("optim.buffers", 41)
                tracing.count("optim.fused", 41)
        assert r.read(record()) == pytest.approx(100.0)
        assert r.read(record(traced=False)) is None
        with profile(activities=[ProfilerActivity.CPU]):
            tracing.count("optim.buffers", 82)
            tracing.count("optim.fused", 0)
        assert r.read(record()) == pytest.approx(50.0)
        # a port without the tracing module
        import repro_torch
        monkeypatch.delattr(repro_torch, "tracing")
        monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
        assert r.read(record()) is None
    finally:
        tracing.reset_counters()


def test_without_the_ports_counters_it_reads_nothing():
    """The parent's tracing module counts no buffers."""
    from repro_torch import tracing
    tracing.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("moe.assignments", 64)
    try:
        assert reader().read(record()) is None
    finally:
        tracing.reset_counters()


def test_the_metric_is_declared_for_the_training_cells():
    bench = cells.load_benchmark()
    (metric,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert metric["workloads"] == TRAINING
    assert metric["layer"] == "optim: the sharded AdamW update"
    assert (metric["unit"], metric["better"], metric["source"]) == \
        ("%", "higher", "program_counter")
    assert reader().MOVES == metric["moves"] == "train_tokens_per_s"
    for name in TRAINING:
        assert NAME in cells.resolve(bench, name).readers
    assert bench["per_layer"][-1] is metric
