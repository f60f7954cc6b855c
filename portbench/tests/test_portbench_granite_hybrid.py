"""The granite 4.0-H family (``families/granite_hybrid.py``) on the CPU:
its leaves against the port's parameters, the counts by hand, the four
readers of its metrics on a trace made by hand, its cells resolved and
run at test size, the check failing a broken step and the reference on
half of each sequence, and a run of both cells without JAX."""

import json
import subprocess
import sys
import types

import pytest
import torch

from portbench import control, half_sequence as half_sequence_fault
from portbench.counts import granite_hybrid_flops, mamba2_ssd
from portbench.counts.model_flops import causal_pairs
from portbench.families import granite_hybrid as family
from portbench.harness import cell as cells, checks, weights
from portbench.harness.runner import Record
from portbench.harness.trace import Trace
from portbench.tests import helpers, test_portbench_hygiene as hygiene
from portbench.tests.test_portbench_faults import (half_batch, no_exchange,
                                                   unchanged_step)

ROOT = cells.ROOT
HYBRID = "granite-4.0-h-small.zero-4k"
PREFILL = "granite-3-2b.serve-prefill"
PEAKS = {"flops": 67e12, "bytes_per_s": 3.35e12}
P = "repro_torch."


def config(name):
    path = ROOT / "portbench" / ("configs" if name == "granite-4.0-h-small"
                                 else "tests/data") / f"{name}.json"
    return cells.as_run(json.loads(path.read_text()))


def test_leaves_are_the_ports_parameters():
    """Each sched layer's tree of names is the port's tree, and each
    name's drawn slice has the port's leaf's shape."""
    from repro_torch import tree
    from repro_torch.models import model
    cfg = config("granite-hybrid-tiny")
    arch = family.arch_for(cfg)
    drawn = weights.draw(cfg, 2 ** 31 + 5, "cpu")
    port = model.sched_layer_trees(model.param_shapes(arch))
    names = family.program_trees(cfg)
    assert len(port) == len(names) == cfg["num_hidden_layers"] + 2
    for mine, theirs in zip(names, port):
        slices = weights._map(mine, lambda leaf: weights.get(drawn, leaf))
        assert tree.structure(slices) == tree.structure(theirs)
        for x, y in zip(tree.leaves(slices), tree.leaves(theirs)):
            assert tuple(x.shape) == tuple(y.shape)
    used = {leaf[0] for t in names for leaf in weights.named_leaves(t)}
    assert used == set(drawn)


def test_the_full_size_file_draws_the_stages_parameters():
    cfg = config("granite-4.0-h-small")
    n = sum(torch.Size(shape).numel()
            for shape, _ in family.shapes(cfg).values())
    assert n == 2_320_321_152
    assert family.shapes(cfg)["A_log"] == ((9, 128), family.STDS["A_log"])
    assert family.shapes(cfg)["wq"][0] == (1, 4096, 4096)


def test_the_ssd_counts_by_hand():
    c = mamba2_ssd.call(config("granite-4.0-h-small"), 1, 4096)
    assert c == {"b": 1, "t": 4096, "h": 128, "p": 64, "n": 128, "g": 1,
                 "chunk": 256}
    # 16 chunks of 256^2 (128 + 8192) + 2 x 256 x 128 x 64 x 128
    assert mamba2_ssd.ops(**c) == 2 * 16 * (545_259_520 + 536_870_912)
    # x and y (4096 x 8192), dt (4096 x 128), B and C (4096 x 128)
    assert mamba2_ssd.nbytes(1, 4096, 128, 64, 128, 1) \
        == 4 * 4096 * (2 * 8192 + 128 + 256)
    # a T that is not whole chunks counts the chunks that cover it
    assert mamba2_ssd.ops(1, 300, 128, 64, 128, 1, 256) \
        == 2 * 2 * (545_259_520 + 536_870_912)
    assert mamba2_ssd.bound_s(c, PEAKS) == pytest.approx(
        34_628_173_824 / 67e12)


def test_the_training_flops_by_hand():
    cfg = config("granite-4.0-h-small")
    tokens = 4096
    mamba = 4096 * (8192 + 8448 + 128) + 8192 * 4096        # 102,236,160
    attention = 2 * 4096 * 4096 + 2 * 4096 * 1024           # 41,943,040
    every = 4096 * 72 + 3 * 4096 * 1536                     # router, shared
    products = 9 * mamba + attention + 10 * every + 100_352 * 4096
    assert products == 1_564_803_072
    experts = 6 * 10 * (tokens * 10 * 0.125) * 3 * 4096 * 768
    attn = 3 * 4 * 32 * 128 * causal_pairs(4096)
    ssd = 3 * 9 * 34_628_173_824
    want = 6 * tokens * products + experts + attn + ssd
    assert granite_hybrid_flops.train_step(cfg, 1, 4096, 0.125) \
        == pytest.approx(want, rel=1e-12)
    # without a traced kept share: the held share of every assignment
    assert granite_hybrid_flops.train_step(cfg, 1, 4096) \
        == pytest.approx(want - experts + experts * 8 / 72 / 0.125,
                         rel=1e-12)


def reader(name):
    return cells.load_module(cells.reader_path(ROOT, name), name)


def hybrid_trace():
    """Two steps.  Window thread: two mixers 0-1000 and 2000-3000, each
    holding a scan (200-700: launches at 250 and 300, device 300-500 and
    500-800; 2100-2600: launch at 2150, device 2200-2400), a launch at 900
    inside the first mixer (device 900-1000); the autograd thread's
    ``mamba.backward`` 4000-5000 (a launch at 4100, device 4100-4600); a
    launch outside every span at 6000."""
    device = [(300.0, 500.0, "a", 1), (500.0, 800.0, "b", 2),
              (900.0, 1000.0, "c", 3), (2200.0, 2400.0, "d", 4),
              (4100.0, 4600.0, "e", 5), (6000.0, 6100.0, "f", 6)]
    launches = [(250.0, 1), (300.0, 2), (900.0, 3), (2150.0, 4),
                (4100.0, 5), (6000.0, 6)]
    window = {P + "mamba.mixer": [(0.0, 1000.0), (2000.0, 3000.0)],
              P + "mamba.scan": [(200.0, 700.0), (2100.0, 2600.0)]}
    host_ops = sorted([(s, e, n) for n, v in window.items() for s, e in v]
                      + [(4000.0, 5000.0, P + "mamba.backward")])
    return Trace(window=(0.0, 1e4), device=device, launches=launches,
                 spans=window, host_ops=host_ops)


def record(t, facts=None):
    cell = types.SimpleNamespace(config=config("granite-4.0-h-small"),
                                 traffic={"batch": 1, "seq": 4096})
    facts = {"traced": {"steps": 2}} if facts is None else facts
    return Record(cell=cell, peaks=PEAKS, trace=t, facts=facts)


def test_the_mamba_readers():
    r = record(hybrid_trace())
    assert reader("mamba.mixer_ms.train").read(r) \
        == pytest.approx((0.2 + 0.3 + 0.1 + 0.2) / 2)
    assert reader("mamba.backward_ms.train").read(r) == pytest.approx(0.5 / 2)
    one = 34_628_173_824 / 67e12
    assert reader("mamba.scan_roofline.train").read(r) \
        == pytest.approx(100 * 2 * one / 0.7e-3)


def test_the_held_share_reads_the_ports_counters():
    from repro_torch import tracing
    from torch.profiler import ProfilerActivity, profile
    r = reader("moe.held_share.train")
    tracing.reset_counters()
    assert r.read(record(hybrid_trace())) is None
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("moe.routed", 400)
        tracing.count("moe.assignments", torch.tensor(50))
    try:
        assert r.read(record(hybrid_trace())) == pytest.approx(12.5)
        assert r.read(record(None, facts={})) is None
    finally:
        tracing.reset_counters()


@pytest.mark.parametrize("name", ["mamba.mixer_ms.train",
                                  "mamba.backward_ms.train",
                                  "mamba.scan_roofline.train"])
def test_without_the_ports_spans_a_mamba_reader_reads_nothing(name):
    bare = Trace(window=(0.0, 1e4), device=[(0.0, 10.0, "gemm", 1)],
                 launches=[(0.0, 1)], spans={}, host_ops=[])
    assert reader(name).read(record(bare)) is None
    assert reader(name).read(record(None, facts={})) is None


def test_both_cells_resolve_with_their_metrics():
    bench = cells.load_benchmark()
    h, p = cells.resolve(bench, HYBRID), cells.resolve(bench, PREFILL)
    assert (h.kind, h.traffic["seq"], h.traffic["batch"]) \
        == ("train", 4096, 1)
    assert {"mamba.mixer_ms.train", "mamba.scan_roofline.train",
            "mamba.backward_ms.train", "moe.held_share.train",
            "train.mfu", "moe.kept_share.train"} <= set(h.readers)
    assert {m["name"] for m in h.end_to_end} == {"train_tokens_per_s",
                                                 "setup_s"}
    assert (p.kind, p.traffic["prompt_lengths"]) == ("serve", [4088])
    assert {m["name"] for m in p.end_to_end} == {
        "serve_tokens_per_s", "itl_ms_p95", "setup_s"}
    assert "moe.dispatch_ms.train" in h.readers
    assert set(p.readers) == {"serve.prefill_ms_per_ktok",
                              "flash_attention_roofline.serve", "serve.mfu",
                              "device.idle_share.serve",
                              "serve.decode_device_ms",
                              "serve.decode_host_ms",
                              "serve.host_launches_per_token"}


@pytest.fixture
def tiny(tmp_path):
    return helpers.tiny_root(tmp_path)


@pytest.mark.parametrize("workload,traced", [(HYBRID, False), (HYBRID, True),
                                             (PREFILL, True)])
def test_a_sound_run_is_correct(tiny, workload, traced):
    line, _ = helpers.run(*tiny, workload, traced=traced)
    assert line["correct"] is True, line["checks"]


def half_sequence(monkeypatch):
    """The step trains on the first half of each sequence: the half batch
    of a batch of one sequence."""
    from repro_torch.dist import zero
    local = zero.ZeroTrainer._local_batch

    def first_half(self, batch):
        out = local(self, batch)
        return {k: v[:, :v.shape[1] // 2] for k, v in out.items()}
    monkeypatch.setattr(zero.ZeroTrainer, "_local_batch", first_half)


@pytest.mark.parametrize("fault", [unchanged_step, half_batch, no_exchange,
                                   half_sequence],
                         ids=lambda f: f.__name__)
def test_a_broken_hybrid_step_is_not_correct(tiny, monkeypatch, fault):
    fault(monkeypatch)
    line, _ = helpers.run(*tiny, HYBRID)
    assert line["correct"] is False, line["checks"]


def test_the_control_fails_the_hybrids_limits(tiny):
    bench, root = tiny
    cell = cells.resolve(bench, HYBRID, root)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2):
        numbers = control.readings(cell, seed, "tf32", torch.device("cpu"))
        assert any(numbers[k] > v for k, v in cell.limits.items()), numbers


def test_the_half_sequence_reference_fails_every_limit(tiny):
    """``half_sequence.py``'s reading at test size: the reference on the
    first half of each sequence fails each of the cell's limits."""
    bench, root = tiny
    cell = cells.resolve(bench, HYBRID, root)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2):
        numbers = half_sequence_fault.readings(cell, seed,
                                               torch.device("cpu"))
        ok, checked = checks.verdict(numbers, cell.limits)
        assert all(c["value"] > c["limit"] for c in checked.values()), \
            checked


def test_a_hybrid_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """Both new cells at test size, in a process of its own, with the
    test-size file of the new configuration entered there as this
    directory's conftest enters it."""
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from portbench.tests import helpers, test_portbench_hygiene as hygiene
helpers.TINY.setdefault("granite-4.0-h-small", "granite-hybrid-tiny")
bench, root = helpers.tiny_root({str(tmp_path)!r})
for w in ({HYBRID!r}, {PREFILL!r}):
    line, _ = helpers.run(bench, root, w, seconds=0.2)
    assert line["correct"], line
found = sorted(m for m in sys.modules
               if m.split(".")[0] in {sorted(hygiene.FORBIDDEN)!r})
print("FOUND", found)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout, out.stdout[-2000:]
