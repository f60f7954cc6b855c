"""The per-layer readers on a trace made by hand: each reads what its
docstring says, and a reader that finds nothing returns nothing."""

import pytest

from portbench.counts import flash_attention
from portbench.harness import cell as cells
from portbench.harness.runner import Record
from portbench.harness.trace import Trace, WINDOW

PEAKS = {"flops": 67e12, "bytes_per_s": 3.35e12}
CALL = {"b": 2, "h": 32, "hkv": 8, "t": 1024, "hd": 64, "causal": True,
        "window": 0}


def reader(name):
    return cells.load_module(cells.reader_path(cells.ROOT, name), name)


def trace():
    """A 1 s window (µs): flash 0–0.5 ms and 0.6–1.1 ms, a copy at 2 ms,
    a GEMM at 3 ms launched inside an MoE span, an elementwise kernel at
    4 ms launched inside it too; launches at 10, 20, 30, 40, 50 µs."""
    device = [(0.0, 500.0, "void flash_fwd_kernel<float, 64>", 1),
              (600.0, 1100.0, "void flash_fwd_kernel<float, 64>", 2),
              (2000.0, 2100.0, "copy_chunks_kernel", 3),
              (3000.0, 3400.0, "sm80_xmma_gemm_f32f32", 4),
              (4000.0, 4050.0, "vectorized_elementwise_kernel", 5)]
    return Trace(window=(0.0, 1e6), device=device,
                 launches=[(10.0, 1), (20.0, 2), (30.0, 3), (40.0, 4),
                           (50.0, 5)],
                 spans={"portbench.moe.apply": [(35.0, 60.0)]},
                 host_ops=[(0.0, 1e6, "aten::mm")])


def record(facts, t=None, peaks=PEAKS):
    return Record(cell=None, peaks=peaks, trace=t, facts=facts)


def test_the_trace_unions_and_attributes():
    t = trace()
    assert t.busy_s == pytest.approx((500 + 500 + 100 + 400 + 50) / 1e6)
    assert t.window_s == pytest.approx(1.0)
    assert t.count(flash_attention.KERNEL) == 2
    assert t.launches_in([(15.0, 45.0)]) == 3
    assert t.device_time_under("portbench.moe.apply") == pytest.approx(
        450 / 1e6)
    assert t.idle_gaps(1)[0][0] == "aten::mm"
    assert WINDOW


def test_the_rooflines_read_launches_against_their_bounds():
    t = trace()
    facts = {"traced": {"flash_calls": [CALL], "steps": 2,
                        "copy_bytes": 335e6, "copy_launches_expected": 1,
                        "copy_launches_in_trace": 1}}
    want = 100 * 2 * flash_attention.bound_s(CALL, PEAKS) / 1e-3
    assert reader("flash_attention_roofline.train").read(
        record(facts, t)) == pytest.approx(want)
    # 335 MB at 3.35 TB/s is 0.1 ms, the copy's traced time
    assert reader("bucket_pack_roofline.train").read(
        record(facts, t)) == pytest.approx(100.0)
    facts["traced"]["copy_launches_in_trace"] = 0
    assert reader("bucket_pack_roofline.train").read(record(facts, t)) \
        is None
    assert reader("flash_attention_roofline.train").read(
        record(facts, t, peaks=None)) is None


def test_the_step_readers():
    t = trace()
    facts = {"traced": {"steps": 2, "decode_steps": 3,
                        "decode_interval": [15.0, 45.0]},
             "window": {"seconds": 2.0,
                        "steps": [(1.0, False, 0.0), (1.2, False, 0.0),
                                  (5.0, True, 0.0)]},
             "model_flops": 67e12, "seconds": 2.0, "prefill_ms": 220.0,
             "prompt_tokens": 2000}
    assert reader("models.gemm_ms.train").read(record(facts, t)) \
        == pytest.approx(0.2)
    assert reader("moe.dispatch_ms.train").read(record(facts, t)) \
        == pytest.approx(0.025)
    assert reader("serve.host_launches_per_token").read(
        record(facts, t)) == pytest.approx(1.0)
    assert reader("runtime.replan_overhead_ms.train").read(
        record(facts, t)) == pytest.approx(3900.0)
    assert reader("train.mfu").read(record(facts)) == pytest.approx(50.0)
    assert reader("serve.mfu").read(record(facts)) == pytest.approx(50.0)
    assert reader("serve.prefill_ms_per_ktok").read(record(facts)) \
        == pytest.approx(110.0)
    assert reader("device.idle_share.train").read(record(facts, t)) \
        == pytest.approx(100 * (1 - 1550 / 1e6))
    quiet = {"window": {"seconds": 1.0, "steps": [(1.0, False, 0.0)]}}
    assert reader("runtime.replan_overhead_ms.train").read(
        record(quiet)) is None
    assert reader("moe.dispatch_ms.train").read(
        record(facts, Trace((0.0, 1.0), [], [], {}, []))) is None
