"""The readers of the port's own spans and counters on a trace made by
hand: each reads what its docstring says, a ``moe.backward`` span on the
autograd engine's thread included, and a trace without the port's spans
(a port that has none) reads nothing."""

import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.harness import cell as cells, spans
from portbench.harness.runner import Record
from portbench.harness.trace import Trace

P = spans.PREFIX
TRAIN = ("zero.forward_ms.train", "zero.backward_ms.train",
         "zero.backward_idle_ms.train", "zero.exchange_ms.train",
         "optim.update_ms.train", "moe.route_ms.train",
         "moe.backward_ms.train")
OTHERS = ("runtime.replan_ms.train", "runtime.measure_idle_share.train",
          "serve.decode_host_ms", "serve.decode_device_ms")


def reader(name):
    return cells.load_module(cells.reader_path(cells.ROOT, name), name)


def train_trace():
    """Two steps in a 10 ms window (µs).  The window thread's spans: pull
    0–100 (a copy launched at 50: device 200–300), forward 100–1000 (a
    route 200–300 inside it: launch at 250, device 400–500; a GEMM
    launched at 600, device 600–900), backward 1000–3000 (launches at
    1100, device 1000–1400, and at 2600, device 2600–2800, the latter
    inside the autograd thread's ``moe.backward`` 2500–2900), push
    3000–3100 (launch at 3050, device 3050–3150), optimizer 3200–3400
    (launch at 3250, device 3300–3600); a launch outside every span at
    5000 (device 5000–5100)."""
    device = [(200.0, 300.0, "copy_chunks_kernel", 1),
              (400.0, 500.0, "scan", 2),
              (600.0, 900.0, "sm80_xmma_gemm", 3),
              (1000.0, 1400.0, "gemm_bwd", 4),
              (2600.0, 2800.0, "index_select_backward", 5),
              (3050.0, 3150.0, "reduce_scatter", 6),
              (3300.0, 3600.0, "adam", 7),
              (5000.0, 5100.0, "feed", 8)]
    launches = [(50.0, 1), (250.0, 2), (600.0, 3), (1100.0, 4),
                (2600.0, 5), (3050.0, 6), (3250.0, 7), (5000.0, 8)]
    window = {P + "zero.pull": [(0.0, 100.0)],
              P + "zero.forward": [(100.0, 1000.0)],
              P + "moe.route": [(200.0, 300.0)],
              P + "zero.backward": [(1000.0, 3000.0)],
              P + "zero.push": [(3000.0, 3100.0)],
              P + "zero.optimizer": [(3200.0, 3400.0)]}
    host_ops = sorted([(s, e, n) for n, v in window.items() for s, e in v]
                      + [(2500.0, 2900.0, P + "moe.backward"),
                         (2500.0, 2600.0, "aten::index_select_backward")])
    return Trace(window=(0.0, 1e4), device=device, launches=launches,
                 spans=window, host_ops=host_ops)


def record(t, facts=None):
    facts = {"traced": {"steps": 2}} if facts is None else facts
    return Record(cell=None, peaks=None, trace=t, facts=facts)


def test_the_zero_step_readers():
    r = record(train_trace())
    read = {name: reader(name).read(r) for name in TRAIN}
    assert read["zero.forward_ms.train"] == pytest.approx(0.4 / 2)
    assert read["zero.backward_ms.train"] == pytest.approx(0.6 / 2)
    # backward 1000–3000 is busy 1000–1400 and 2600–2800: 1.4 ms idle
    assert read["zero.backward_idle_ms.train"] == pytest.approx(1.4 / 2)
    assert read["zero.exchange_ms.train"] == pytest.approx(0.2 / 2)
    assert read["optim.update_ms.train"] == pytest.approx(0.3 / 2)
    assert read["moe.route_ms.train"] == pytest.approx(0.1 / 2)


def test_the_moe_backward_span_is_read_on_any_thread():
    """``moe.backward`` is not among the window thread's spans; the
    launch inside it is its work, the one before it is not."""
    t = train_trace()
    assert not t.span_intervals(P + "moe.backward")
    assert reader("moe.backward_ms.train").read(record(t)) \
        == pytest.approx(0.2 / 2)


def test_the_replan_and_measure_readers():
    """Two re-plans, 0–3000 and 5000–6000, the first holding a
    measurement 0–2000 with the card busy 500–1000 and 1500–2500."""
    t = Trace(window=(0.0, 1e4),
              device=[(500.0, 1000.0, "gemm", 1),
                      (1500.0, 2500.0, "gemm", 2)],
              launches=[(400.0, 1), (1400.0, 2)],
              spans={P + "runtime.replan": [(0.0, 3000.0),
                                            (5000.0, 6000.0)],
                     P + "runtime.measure": [(0.0, 2000.0)]},
              host_ops=[])
    assert reader("runtime.replan_ms.train").read(record(t)) \
        == pytest.approx(2.0)
    assert reader("runtime.measure_idle_share.train").read(record(t)) \
        == pytest.approx(100 * 1000 / 2000)


def test_the_decode_readers():
    """Three decode steps of 2, 3 and 10 ms on the host; the work
    launched inside them 1 + 2 ms, and a launch between them not."""
    t = Trace(window=(0.0, 1e5),
              device=[(0.0, 1000.0, "gemv", 1), (3000.0, 5000.0, "gemv", 2),
                      (20000.0, 20500.0, "hook", 3)],
              launches=[(100.0, 1), (2100.0, 2), (6000.0, 3)],
              spans={P + "serve.decode_step": [(0.0, 2000.0),
                                               (2000.0, 5000.0),
                                               (7000.0, 17000.0)]},
              host_ops=[])
    assert reader("serve.decode_host_ms").read(record(t)) \
        == pytest.approx(3.0)
    assert reader("serve.decode_device_ms").read(record(t)) \
        == pytest.approx(3.0 / 3)


@pytest.mark.parametrize("name", TRAIN + OTHERS)
def test_without_the_ports_spans_a_reader_reads_nothing(name):
    """The parent of the spans, or a cell that does not run them."""
    bare = Trace(window=(0.0, 1e4), device=[(0.0, 10.0, "gemm", 1)],
                 launches=[(0.0, 1)],
                 spans={"portbench.moe.apply": [(0.0, 100.0)]},
                 host_ops=[(0.0, 100.0, "portbench.moe.apply")])
    assert reader(name).read(record(bare)) is None
    assert reader(name).read(record(None, facts={})) is None


def test_the_kept_share_reads_the_ports_counters(monkeypatch):
    from repro_torch import tracing
    r = reader("moe.kept_share.train")
    tracing.reset_counters()
    assert r.read(record(train_trace())) is None
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("moe.assignments", 64)
        tracing.count("moe.kept", torch.tensor(48))
        tracing.count("moe.assignments", 64)
        tracing.count("moe.kept", torch.tensor(32))
    try:
        assert r.read(record(train_trace())) == pytest.approx(62.5)
        assert r.read(record(None, facts={})) is None
        # a port without the module (its parent)
        import repro_torch
        monkeypatch.delattr(repro_torch, "tracing")
        monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
        assert r.read(record(train_trace())) is None
    finally:
        tracing.reset_counters()


def test_spans_overlap_and_merge():
    t = Trace(window=(0.0, 100.0),
              device=[(10.0, 20.0, "a", 1), (15.0, 30.0, "b", 2),
                      (50.0, 60.0, "c", 3)],
              launches=[(5.0, 1), (12.0, 2), (55.0, 3)], spans={},
              host_ops=[])
    assert spans.merged([(0, 10), (5, 12), (20, 30)]) == [(0, 12), (20, 30)]
    assert spans.open_s([(0, 10), (5, 12)]) == pytest.approx(12e-6)
    assert spans.idle_s(t, [(0.0, 40.0), (45.0, 55.0)]) \
        == pytest.approx((40 - 20 + 10 - 5) / 1e6)
    assert spans.launched_s(t, [(0.0, 10.0), (8.0, 13.0)]) \
        == pytest.approx(25e-6)
