"""Resolve a cell of ``BENCHMARK.json`` to its files, by name alone.

A cell names a configuration and a traffic mix; ``BENCHMARK.json`` lists
the metrics.  Each is found on disk by its name:

* the configuration: the ``file`` its ``configs`` entry gives, run as
  :func:`as_run` reads it, and its family's modules
  (``portbench/families/<family>.py``, ``portbench/reference/<family>.py``);
* the traffic mix: ``portbench/traffic/<traffic>.json``, whose ``kind``
  picks the generator ``portbench/gen/<kind>.py``;
* a per-layer metric: ``portbench/metrics/<metric>.py``, a module with
  ``MOVES`` (the end-to-end metric it moves) and ``read(record)``;
* the cell's limits: ``portbench/limits/<cell>.json``.

So a later cell, configuration, traffic mix or metric is new files and
new ``BENCHMARK.json`` entries, never an edit of a file that is there.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[2]      # the checkout's root
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: Dict[str, Any]          # the configuration as run
    traffic: Dict[str, Any]         # the traffic file's contents
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    readers: Dict[str, ModuleType]  # per-layer metric name -> its reader
    limits: Dict[str, float]        # compared number -> its limit
    root: Path

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def generator(self) -> ModuleType:
        """``portbench/gen/<kind>.py``."""
        return importlib.import_module(f"portbench.gen.{self.kind}")


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def as_run(file: Dict[str, Any]) -> Dict[str, Any]:
    """The configuration as the port runs it: the file's keys (the
    source's values, cut where ``reduced`` says) with ``departs`` over
    them, the keys on which the port's model departs from the source."""
    return {**file, **file.get("departs", {})}


def _by_name(entries, name: str, what: str) -> Dict[str, Any]:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r}: {len(found)} entries in "
                       f"BENCHMARK.json")
    return found[0]


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file ``path`` (its name may hold dots) as ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader_path(root: Path, metric: str) -> Path:
    return Path(root) / "portbench" / "metrics" / f"{metric}.py"


def reports(metric: Dict[str, Any], cell: str, e2e_names) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list, or, without the key, every cell that reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def resolve(bench: Dict[str, Any], workload: str,
            root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``bench`` with its files loaded."""
    root = Path(root)
    w = _by_name(bench["workloads"], workload, "workload")
    c = _by_name(bench["configs"], w["config"], "config")
    config = as_run(json.loads((root / c["file"]).read_text()))
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if reports(m, workload, e2e_names)]
    readers = {}
    for m in per_layer:
        module = load_module(reader_path(root, m["name"]),
                             "portbench_metric_" + re.sub(r"\W", "_",
                                                          m["name"]))
        if module.MOVES != m["moves"]:
            raise ValueError(f"metric {m['name']}: its reader moves "
                             f"{module.MOVES!r}, BENCHMARK.json says "
                             f"{m['moves']!r}")
        readers[m["name"]] = module
    limits = json.loads(
        (root / "portbench" / "limits" / f"{workload}.json").read_text())
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer,
                readers=readers, limits=limits["limits"], root=root)
