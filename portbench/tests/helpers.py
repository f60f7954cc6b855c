"""A checkout-shaped directory for the CPU tests: the real metric readers
and limits, the test-size configurations (``data/``) under the real
configurations' names, and the real traffic mixes at test sizes."""

from __future__ import annotations

import copy
import json
import shutil
import time
from pathlib import Path

import torch

from portbench.harness import cell as cells

BENCH = Path(__file__).resolve().parents[1]
DATA = Path(__file__).resolve().parent / "data"
TINY = {"granite-3-2b": "granite-tiny",
        "granite-moe-1b-a400m": "granite-moe-tiny"}
TRAIN_SIZE = {"seq": 16}
SERVE_SIZE = {"prompt_lengths": [8, 16, 32, 16], "new_tokens": 6,
              "traced_prompt": 16, "batch": 2, "sample_requests": 3}


def tiny_root(tmp: Path, sizes=None):
    """(benchmark dict, root) of a test-size copy of the benchmark;
    ``sizes`` maps a configuration to another test-size file of ``data/``
    and a traffic mix to changes of its test size."""
    sizes = sizes or {}
    root = Path(tmp)
    (root / "portbench").mkdir(parents=True, exist_ok=True)
    for d in ("metrics", "limits"):
        shutil.copytree(BENCH / d, root / "portbench" / d,
                        dirs_exist_ok=True)
    (root / "portbench" / "configs").mkdir(exist_ok=True)
    (root / "portbench" / "traffic").mkdir(exist_ok=True)
    bench = copy.deepcopy(cells.load_benchmark())
    for c in bench["configs"]:
        name = sizes.get(c["name"], TINY[c["name"]])
        shutil.copy(DATA / f"{name}.json",
                    root / "portbench" / "configs" / f"{name}.json")
        c["file"] = f"portbench/configs/{name}.json"
    for path in (BENCH / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(TRAIN_SIZE if t["kind"] == "train" else SERVE_SIZE)
        t.update(sizes.get(path.stem, {}))
        (root / "portbench" / "traffic" / path.name).write_text(
            json.dumps(t))
    return bench, root


def run(bench, root, workload: str, seed: int = 2 ** 31 + 7,
        seconds: float = 0.5, traced: bool = False):
    """One CPU run of ``workload``: (result line, notes)."""
    from portbench.harness import runner
    cell = cells.resolve(bench, workload, root)
    work = Path(root) / "work"
    work.mkdir(exist_ok=True)
    return runner.run_cell(cell, seed, seconds, traced, torch.device("cpu"),
                           time.perf_counter(), work)
