"""The harness on the CPU: cells resolve by name, metrics agree with the
cells that report them, names keep to their characters, traffic repeats
for a seed, the result line has its keys, a later cell is files alone,
and without a card the measuring path fails instead of using the CPU."""

import json
import math
import re
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.gen import serve, train
from portbench.harness import cell as cells, weights
from portbench.tests import helpers

ROOT = cells.ROOT
BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_resolves_to_its_files(workload):
    c = cells.resolve(BENCH, workload)
    assert c.kind in ("train", "serve")
    assert c.generator().run
    assert set(c.readers) == {m["name"] for m in c.per_layer}
    assert c.per_layer and any(m["name"] != "setup_s"
                               for m in c.end_to_end)
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    assert c.limits


def test_each_per_layer_metric_moves_what_all_its_cells_report():
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            e2e = {x["name"] for x in cells.resolve(BENCH, w).end_to_end}
            assert m["moves"] in e2e, (m["name"], w)


def test_names_units_and_lines_keep_to_their_characters():
    named = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    for e in named:
        assert NAME.match(e["name"]), e["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\t" not in m["layer"]
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
    names = [e["name"] for e in named]
    assert len(names) == len(set(names))
    for path in (ROOT / "portbench").rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        if "__pycache__" not in rel:
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_configuration_files_state_what_their_entries_name():
    for c in BENCH["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]
        assert f["precision"] == "float32, TF32 off"


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_a_configuration_keeps_departures_apart_and_names_its_family(entry):
    """``reduced`` holds cuts of scale, ``departs`` the keys on which the
    port's model departs from the source (never a width); the run takes
    ``departs`` over the file, and the family's modules are found by
    name."""
    from portbench import families, reference
    f = json.loads((ROOT / entry["file"]).read_text())
    departs = f.get("departs", {})
    assert not set(departs) & set(f["reduced"])
    assert not any(k.endswith(("_size", "_dim", "_rank", "_heads"))
                   or k.startswith("num_") for k in departs), departs
    run = cells.as_run(f)
    assert all(run[k] == v for k, v in departs.items())
    assert cells.resolve(BENCH, next(
        w["name"] for w in BENCH["workloads"]
        if w["config"] == entry["name"])).config == run
    families.of(run).arch_for(run)
    assert reference.of(run).loss and reference.of(run).head


@pytest.mark.parametrize("workload", CELLS)
def test_traffic_repeats_exactly_for_a_seed(workload):
    c = cells.resolve(BENCH, workload)
    cfg = json.loads((ROOT / "portbench" / "tests" / "data" /
                      f"{helpers.TINY[c.config['name']]}.json").read_text())
    seed = 2 ** 31 + 99
    if c.kind == "train":
        a, b = (train.Feed(cfg, c.traffic, seed, "cpu") for _ in range(2))
        for i in (0, 1, 7):
            x, y = a(i), b(i)
            assert torch.equal(x["tokens"], y["tokens"])
            assert torch.equal(x["labels"], y["labels"])
        assert not torch.equal(a(0)["tokens"], a(1)["tokens"])
        rows = a(0)["tokens"]
        assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
    else:
        for i in (0, 3):
            assert torch.equal(serve.prompts(cfg, seed, i, 2, 8, "cpu"),
                               serve.prompts(cfg, seed, i, 2, 8, "cpu"))
        lengths = [serve.cycle(c.traffic, s) for s in range(4)]
        assert all(sorted(x) == sorted(c.traffic["prompt_lengths"])
                   for x in lengths)
    w1, w2 = weights.draw(cfg, seed, "cpu"), weights.draw(cfg, seed, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(weights.draw(cfg, seed + 1, "cpu")["wq"],
                           w1["wq"])


@pytest.mark.parametrize("workload,traced", [
    ("granite-3-2b.zero", False), ("granite-3-2b.zero", True),
    ("granite-moe-1b-a400m.zero", True),
    ("granite-3-2b.serve-decode", False),
    ("granite-3-2b.serve-decode", True),
    ("granite-3-2b.dynamic-measured", False)])
def test_the_last_line_has_its_keys_and_the_run_is_correct(
        tmp_path, workload, traced):
    bench, root = helpers.tiny_root(tmp_path)
    line, notes = helpers.run(bench, root, workload, traced=traced)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] if traced else []
    assert list(line) == want + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    c = cells.resolve(bench, workload, root)
    if not traced:
        assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
        assert all(m["value"] > 0 for m in line["metrics"].values())
    else:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["checks"]) == set(c.limits)
    for k, v in line["checks"].items():
        assert math.isfinite(v["value"]) and v["value"] <= v["limit"], k
    json.dumps(line)


def test_a_later_cell_is_new_files_and_entries_alone(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell
    added by files and ``BENCHMARK.json`` entries only, then run."""
    bench, root = helpers.tiny_root(tmp_path)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "granite-tiny.json").read_text())
    cfg["name"] = "granite-tiny-added"
    (pb / "configs" / "granite-tiny-added.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "zero.json").read_text())
    traffic.update(batch=4, seq=8)
    (pb / "traffic" / "zero-b4.json").write_text(json.dumps(traffic))
    (pb / "metrics" / "test.steps_in_window.py").write_text(
        'MOVES = "train_tokens_per_s"\n\n\n'
        'def read(record):\n'
        '    return float(len(record.facts["window"]["steps"]))\n')
    shutil.copy(pb / "limits" / "granite-3-2b.zero.json",
                pb / "limits" / "granite-tiny-added.zero-b4.json")
    bench["configs"].append({"name": "granite-tiny-added", "source": "x",
                             "file": "portbench/configs/"
                                     "granite-tiny-added.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "granite-tiny-added.zero-b4",
                               "config": "granite-tiny-added",
                               "traffic": "zero-b4", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("granite-tiny-added.zero-b4")
    bench["per_layer"].append({
        "name": "test.steps_in_window", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "test", "moves":
        "train_tokens_per_s", "workloads": ["granite-tiny-added.zero-b4"]})
    line, _ = helpers.run(bench, root, "granite-tiny-added.zero-b4",
                          traced=True)
    assert line["correct"]
    assert line["metrics"]["test.steps_in_window"]["value"] >= 1


def test_without_a_card_the_run_fails_and_prints_no_result(tmp_path):
    assert not torch.cuda.is_available()
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "granite-3-2b.zero", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 3, out.stderr[-2000:]
    assert out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


def test_a_directory_of_the_benchmark_alone_is_refused(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "granite-3-2b.zero", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
