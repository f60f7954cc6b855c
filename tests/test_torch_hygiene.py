"""The port stands alone: no JAX and nothing of ``repro`` in it.

``repro_torch``, ``chip_smoke.py`` (with the helper it imports,
``tests/helpers/torch_examples.py``) and the port's examples
(``examples/torch_*.py``) may import ``torch`` and numpy, but never
``jax``, no module of the reference package (which ``repro_torch`` itself
matches as a prefix, so the checks compare module names exactly) and
nothing of ``benchmarks`` (which imports the reference).
"""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def _examples():
    """The port's examples: ``examples/torch_<name>.py``."""
    folder = os.path.join(ROOT, "examples")
    return sorted(os.path.join(folder, f) for f in os.listdir(folder)
                  if f.startswith("torch_") and f.endswith(".py"))


def _sources():
    for base, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    # chip_smoke.py's phase examples runs and masks them with this helper
    yield os.path.join(ROOT, "tests", "helpers", "torch_examples.py")
    yield from _examples()


def test_ast_scan_finds_no_jax_or_reference_import():
    found = []
    for path in _sources():
        with open(path) as fh:
            mod = ast.parse(fh.read(), path)
        for node in ast.walk(mod):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            found += [(path, n) for n in names if _forbidden(n)]
    assert not found
    assert _forbidden("repro.core") and not _forbidden("repro_torch.core")
    assert _forbidden("benchmarks.edge_setup")


def test_every_reference_example_has_a_port_counterpart():
    names = {os.path.basename(p)[len("torch_"):] for p in _examples()}
    folder = os.path.join(ROOT, "examples")
    reference = {f for f in os.listdir(folder)
                 if f.endswith(".py") and not f.startswith("torch_")}
    assert names == reference and len(names) == 9


def test_the_examples_load_no_jax_reference_or_benchmarks():
    """Each example imported by path (its module-level imports), and the
    two host-only ones run: nothing forbidden lands in ``sys.modules``."""
    code = ("import importlib.util, io, contextlib, sys\n"
            "for path in sys.argv[1:]:\n"
            "    spec = importlib.util.spec_from_file_location('ex', path)\n"
            "    mod = importlib.util.module_from_spec(spec)\n"
            "    spec.loader.exec_module(mod)\n"
            "    if path.endswith(('quickstart.py', 'cnn_study.py')):\n"
            "        sys.argv = [path]\n"
            "        with contextlib.redirect_stdout(io.StringIO()):\n"
            "            mod.main()\n"
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code, *_examples()],
                         env=env, check=True, capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.stdout.strip() == "[]"


def test_no_communication_function_is_imported_by_name():
    """``repro_torch.analysis.trace`` records collectives by wrapping the
    attributes of ``torch.distributed``: a call through a name bound at
    import (``from torch.distributed import all_reduce``) or through
    ``distributed_c10d`` would escape it."""
    from repro_torch.analysis.trace import OTHER_CALLS, RECORDED
    comm = set(RECORDED) | set(OTHER_CALLS)
    found = []
    for path in _sources():
        with open(path) as fh:
            mod = ast.parse(fh.read(), path)
        for node in ast.walk(mod):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("torch.distributed"):
                found += [(path, node.module, a.name) for a in node.names
                          if a.name in comm or "c10d" in node.module
                          or a.name == "distributed_c10d"]
            elif isinstance(node, ast.Import):
                found += [(path, a.name, None) for a in node.names
                          if "distributed_c10d" in a.name]
    assert not found
    assert {"all_gather_into_tensor", "reduce_scatter_tensor",
            "all_reduce", "broadcast"} <= comm


def test_importing_the_entry_points_loads_no_jax_or_reference():
    code = ("import sys, repro_torch.runtime, repro_torch.launch.train, "
            "repro_torch.dist, repro_torch.kernels, repro_torch.ps, "
            "repro_torch.compress, repro_torch.kernels.compress, "
            "repro_torch.fleet, repro_torch.fleet.trainer, "
            "repro_torch.models.cnn, repro_torch.data, "
            "repro_torch.pipeline, repro_torch.pipeline.trainer, "
            "repro_torch.analysis, repro_torch.analysis.cli, "
            "repro_torch.analysis.runtime_verify, repro_torch.train, "
            "repro_torch.models.scanned, repro_torch.dist.sharding, "
            "repro_torch.launch.specs, repro_torch.launch.mesh, "
            "repro_torch.launch.fake, repro_torch.launch.zero_dryrun, "
            "repro_torch.launch.dryrun; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"


def test_chip_smoke_refuses_to_run_without_a_card():
    """No CUDA card: a non-zero exit and no result line."""
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _docstrings(mod):
    """The docstring nodes of a module and of its classes and functions."""
    out = set()
    for node in ast.walk(mod):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body and \
                isinstance(node.body[0], ast.Expr) and \
                isinstance(node.body[0].value, ast.Constant):
            out.add(id(node.body[0].value))
    return out


def test_no_port_module_names_an_xla_flag():
    """The reference's dry runs forge devices through ``XLA_FLAGS``; the
    port's run on fake tensors and must neither set nor read it: no
    string in the port's code (docstrings aside) names it."""
    found = []
    for path in _sources():
        with open(path) as fh:
            mod = ast.parse(fh.read(), path)
        docs = _docstrings(mod)
        for node in ast.walk(mod):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    "XLA_FLAGS" in node.value and id(node) not in docs:
                found.append((path, node.lineno))
    assert not found


def test_only_the_tracing_module_reaches_the_profiler():
    """Every span of the port goes through ``repro_torch.tracing``, which
    enters ``record_function`` only while a profiler records: no other
    module names ``record_function``, ``torch.profiler``,
    ``torch.autograd.profiler`` or the profiler's flag, so no span that
    costs its ~12 µs with the profiler off can reach the hot path."""
    names = {"record_function", "_profiler_enabled"}
    modules = ("torch.profiler", "torch.autograd.profiler")
    found = []
    for base, _, files in os.walk(PORT):
        for f in files:
            path = os.path.join(base, f)
            if not f.endswith(".py") or \
                    path == os.path.join(PORT, "tracing.py"):
                continue
            with open(path) as fh:
                mod = ast.parse(fh.read(), path)
            for node in ast.walk(mod):
                if isinstance(node, ast.Import):
                    found += [(path, a.name) for a in node.names
                              if a.name.startswith(modules)]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    if node.module.startswith(modules) or \
                            node.module in ("torch", "torch.autograd") and \
                            any(a.name == "profiler" for a in node.names):
                        found.append((path, node.module))
                elif isinstance(node, ast.Attribute) and (
                        node.attr in names or node.attr == "profiler" and
                        ast.unparse(node.value) in ("torch",
                                                    "torch.autograd")):
                    found.append((path, node.attr))
                elif isinstance(node, ast.Name) and node.id in names:
                    found.append((path, node.id))
    assert not found
    with open(os.path.join(PORT, "tracing.py")) as fh:
        assert "_profiler_enabled" in fh.read()


def _parsed(path):
    with open(path) as fh:
        return ast.parse(fh.read(), path)


def _imported(mod):
    for node in ast.walk(mod):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_the_per_sched_layer_program_is_reached_through_the_model():
    """The per-sched-layer program lives in ``models/model.py``: the
    measurement pass imports nothing of ``repro_torch.dist``, the pipeline
    nothing of ``repro_torch.dist.zero``, and no module but
    ``dist/zero.py`` touches an underscore member of ``ZeroTrainer`` on
    any object but its own ``self``."""
    measure = _parsed(os.path.join(PORT, "runtime", "measure.py"))
    assert not [m for m in _imported(measure)
                if m.startswith("repro_torch.dist")]
    pipeline = _parsed(os.path.join(PORT, "pipeline", "trainer.py"))
    assert not [m for m in _imported(pipeline)
                if m.startswith("repro_torch.dist.zero")]

    zero_path = os.path.join(PORT, "dist", "zero.py")
    cls = next(n for n in _parsed(zero_path).body
               if isinstance(n, ast.ClassDef) and n.name == "ZeroTrainer")
    private = {n.name for n in cls.body if isinstance(n, ast.FunctionDef)}
    private |= {t.attr for n in ast.walk(cls) if isinstance(n, ast.Assign)
                for t in n.targets if isinstance(t, ast.Attribute)}
    private = {p for p in private
               if p.startswith("_") and not p.endswith("__")}
    assert {"_kinds", "_local_batch", "_gather"} <= private
    found = []
    for path in _sources():
        if path == zero_path or not path.startswith(PORT + os.sep):
            continue
        for node in ast.walk(_parsed(path)):
            if isinstance(node, ast.Attribute) and node.attr in private \
                    and ast.unparse(node.value) not in ("self", "cls"):
                found.append((os.path.relpath(path, ROOT), node.lineno,
                              ast.unparse(node)))
    assert not found
