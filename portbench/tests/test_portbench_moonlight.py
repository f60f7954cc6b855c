"""The DeepSeek-V3 family (``families/deepseek_v3.py``) on the CPU: its
leaves against the port's parameters, the counts by hand, the three
readers of its metrics on a trace made by hand, its cells resolved and run
at test size, the check failing a broken step and the control, and a run
of both new cells without JAX."""

import json
import subprocess
import sys
import types

import pytest
import torch

from portbench import control
from portbench.counts import deepseek_v3_flops, flash_attention, mla_attention
from portbench.counts.model_flops import causal_pairs
from portbench.families import deepseek_v3 as family
from portbench.harness import cell as cells, weights
from portbench.harness.runner import Record
from portbench.harness.trace import Trace
from portbench.tests import helpers, test_portbench_hygiene as hygiene
from portbench.tests.test_portbench_faults import (half_batch, no_exchange,
                                                   unchanged_step)

# the test-size file of the new configuration, entered here as
# ``conftest.py`` enters the hybrid's
helpers.TINY.setdefault("moonlight-16b-a3b", "moonlight-tiny")


@pytest.fixture(autouse=True)
def _no_routing_record():
    """No test leaves the port's ``route`` recorded for the next (the
    family's ``arch_for`` records the program's first steps)."""
    yield
    family.record_routing(0)


ROOT = cells.ROOT
MOONLIGHT = "moonlight-16b-a3b.zero-2x4k"
LONG = "granite-3-2b.zero-4k"
PEAKS = {"flops": 67e12, "bytes_per_s": 3.35e12}
P = "repro_torch."


def config(name):
    path = ROOT / "portbench" / ("configs" if name == "moonlight-16b-a3b"
                                 else "tests/data") / f"{name}.json"
    return cells.as_run(json.loads(path.read_text()))


def test_leaves_are_the_ports_parameters():
    """Each sched layer's tree of names is the port's tree, and each
    name's drawn slice has the port's leaf's shape."""
    from repro_torch import tree
    from repro_torch.models import model
    cfg = config("moonlight-tiny")
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


def test_the_full_size_file_draws_one_ranks_parameters():
    cfg = config("moonlight-16b-a3b")
    shapes = family.shapes(cfg)
    assert sum(torch.Size(s).numel() for s, _ in shapes.values()) \
        == 2_777_412_736
    assert shapes["e_up"][0] == (26, 8, 2048, 1408)
    assert shapes["d_up"][0] == (1, 2048, 11264)
    assert shapes["router_bias"] == ((26, 64), family.STDS["router_bias"])
    assert shapes["head"][0] == (2048, 20480)


def test_the_mla_attention_count_by_hand():
    c = mla_attention.call(config("moonlight-16b-a3b"), 2, 4096)
    assert c == {"b": 2, "t": 4096, "h": 16, "dqk": 192, "dv": 128}
    pairs = 4096 * 4097 // 2                                # 8,390,656
    assert mla_attention.ops(**c) == 2 * 2 * 16 * pairs * 320
    # q and k: 16 heads of 192; v and o: 16 heads of 128; 2 x 4096 tokens
    assert mla_attention.nbytes(**c) == 4 * 8192 * (3072 + 3072 + 2048
                                                    + 2048)
    assert mla_attention.bound_s(c, PEAKS) == pytest.approx(
        171_840_634_880 / 67e12)


def test_the_training_flops_by_hand():
    """The model FLOPs of the 2 x 4096 step: MLA's projections 18.3
    TFLOP, attention 13.9, the shared experts 22.1, the held experts at
    the held share 8.3, the dense layer 3.4, the head 2.1, the routers
    0.17."""
    cfg = config("moonlight-16b-a3b")
    tokens = 8192
    mla = 2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048
    assert mla == deepseek_v3_flops.mla_products(cfg) == 13_762_560
    products = 27 * mla + 3 * 2048 * 11264 + 26 * (2048 * 64
                                                   + 3 * 2048 * 2816) \
        + 20480 * 2048
    experts = 6 * 26 * (tokens * 6 * 0.1) * 3 * 2048 * 1408
    attention = 3 * 27 * 2 * 2 * 16 * 320 * causal_pairs(4096)
    want = 6 * tokens * products + experts + attention
    assert deepseek_v3_flops.train_step(cfg, 2, 4096, 0.1) \
        == pytest.approx(want, rel=1e-12)
    assert deepseek_v3_flops.train_step(cfg, 2, 4096) == pytest.approx(
        want - experts + experts * 8 / 64 / 0.1, rel=1e-12)
    assert 67e12 < deepseek_v3_flops.train_step(cfg, 2, 4096) < 69e12


def reader(name):
    return cells.load_module(cells.reader_path(ROOT, name), name)


KERNEL = "void (anonymous namespace)::flash_fwd_kernel<float, 192, 128>"


def mla_trace():
    """Two steps.  Window thread: two ``mla.attention`` spans 0-1000 and
    2000-3000, holding launches at 100 (a GEMM, device 100-300), 400 (flash,
    device 400-800) and 2100 (flash, device 2200-2500); a flash launch
    outside every span at 6000 (device 6000-6500); the autograd thread's
    ``mla.backward`` 4000-5000 (a launch at 4100, device 4100-4600)."""
    device = [(100.0, 300.0, "sgemm", 1), (400.0, 800.0, KERNEL, 2),
              (2200.0, 2500.0, KERNEL, 3), (4100.0, 4600.0, "grad", 4),
              (6000.0, 6500.0, KERNEL, 5)]
    launches = [(100.0, 1), (400.0, 2), (2100.0, 3), (4100.0, 4),
                (6000.0, 5)]
    window = {P + "mla.attention": [(0.0, 1000.0), (2000.0, 3000.0)]}
    host_ops = sorted([(s, e, n) for n, v in window.items() for s, e in v]
                      + [(4000.0, 5000.0, P + "mla.backward")])
    return Trace(window=(0.0, 1e4), device=device, launches=launches,
                 spans=window, host_ops=host_ops)


def record(t, facts=None):
    cell = types.SimpleNamespace(config=config("moonlight-16b-a3b"),
                                 traffic={"batch": 2, "seq": 4096})
    facts = {"traced": {"steps": 2}} if facts is None else facts
    return Record(cell=cell, peaks=PEAKS, trace=t, facts=facts)


def test_the_mla_readers():
    r = record(mla_trace())
    assert reader("mla.attention_ms.train").read(r) \
        == pytest.approx((0.2 + 0.4 + 0.3) / 2)
    assert reader("mla.backward_ms.train").read(r) == pytest.approx(0.5 / 2)
    one = 171_840_634_880 / 67e12
    # the two flash launches inside the spans, not the one outside
    assert reader("mla.flash_roofline.train").read(r) \
        == pytest.approx(100 * 2 * one / 0.7e-3)
    assert flash_attention.KERNEL.search(KERNEL)


@pytest.mark.parametrize("name", ["mla.attention_ms.train",
                                  "mla.backward_ms.train",
                                  "mla.flash_roofline.train"])
def test_without_the_ports_spans_an_mla_reader_reads_nothing(name):
    bare = Trace(window=(0.0, 1e4), device=[(0.0, 10.0, KERNEL, 1)],
                 launches=[(0.0, 1)], spans={}, host_ops=[])
    assert reader(name).read(record(bare)) is None
    assert reader(name).read(record(None, facts={})) is None


def test_both_cells_resolve_with_their_metrics():
    bench = cells.load_benchmark()
    m, g = cells.resolve(bench, MOONLIGHT), cells.resolve(bench, LONG)
    assert (m.kind, m.traffic["batch"], m.traffic["seq"], m.chips) \
        == ("train", 2, 4096, 1)
    assert {"mla.attention_ms.train", "mla.backward_ms.train",
            "mla.flash_roofline.train", "train.mfu", "models.gemm_ms.train",
            "device.idle_share.train", "bucket_pack_roofline.train",
            "zero.forward_ms.train", "zero.backward_ms.train",
            "zero.backward_idle_ms.train", "zero.exchange_ms.train",
            "optim.update_ms.train", "optim.fused_share.train",
            "moe.route_ms.train", "moe.backward_ms.train",
            "moe.kept_share.train", "moe.held_share.train",
            "moe.dispatch_ms.train"} == set(m.readers)
    assert "flash_attention_roofline.train" not in m.readers
    a = cells.resolve(bench, "granite-3-2b.zero")
    assert set(g.readers) == set(a.readers)
    assert (g.traffic["batch"], g.traffic["seq"]) == (1, 4096)
    for c in (m, g):
        assert {x["name"] for x in c.end_to_end} == {"train_tokens_per_s",
                                                     "setup_s"}


@pytest.fixture
def tiny(tmp_path):
    return helpers.tiny_root(tmp_path)


@pytest.mark.parametrize("workload,traced", [(MOONLIGHT, False),
                                             (MOONLIGHT, True),
                                             (LONG, False)])
def test_a_sound_run_is_correct(tiny, workload, traced):
    line, _ = helpers.run(*tiny, workload, traced=traced)
    assert line["correct"] is True, line["checks"]
    if traced and workload == MOONLIGHT:
        assert "mla.attention_ms.train" in line["metrics"]


# a batch of one sequence (LONG) has no half to leave out
@pytest.mark.parametrize("workload,fault", [
    (MOONLIGHT, unchanged_step), (MOONLIGHT, half_batch),
    (MOONLIGHT, no_exchange), (LONG, unchanged_step), (LONG, no_exchange)],
    ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_step_is_not_correct(tiny, monkeypatch, workload, fault):
    fault(monkeypatch)
    line, _ = helpers.run(*tiny, workload)
    assert line["correct"] is False, line["checks"]


def test_the_control_fails_the_long_cells_limits(tiny):
    bench, root = tiny
    cell = cells.resolve(bench, LONG, root)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2):
        numbers = control.readings(cell, seed, "tf32", torch.device("cpu"))
        assert any(numbers[k] > v for k, v in cell.limits.items()), numbers


def test_the_control_stands_far_from_the_program_at_test_size(tiny):
    """At the cell's own size, with the routers' near-ties settled, every
    number of G but the 3-step loss tells float32 from TF32 (PERF.md,
    section 2).  At test size the comparison sees a lower precision too:
    the emulated TF32 control's median leaf's gradient gap is at least
    100x the program's, seed by seed."""
    bench, root = tiny
    cell = cells.resolve(bench, MOONLIGHT, root)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2):
        line, _ = helpers.run(bench, root, MOONLIGHT, seed=seed)
        program = line["checks"]["grad_gap_median"]["value"]
        numbers = control.readings(cell, seed, "tf32", torch.device("cpu"))
        assert numbers["grad_gap_median"] > 100 * program, (numbers,
                                                            program)


def test_a_moonlight_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """Both new cells at test size, in a process of its own, with the
    test-size files entered there as this module and ``conftest.py``
    enter them."""
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from portbench.tests import helpers, test_portbench_hygiene as hygiene
helpers.TINY.setdefault("granite-4.0-h-small", "granite-hybrid-tiny")
helpers.TINY.setdefault("moonlight-16b-a3b", "moonlight-tiny")
bench, root = helpers.tiny_root({str(tmp_path)!r})
for w in ({MOONLIGHT!r}, {LONG!r}):
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

