"""Nothing the benchmark runs imports JAX or the JAX package, and its
reference imports nothing of the port.

Top-level module names are compared whole: ``repro_torch`` begins with
``repro`` and is the system under test.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
JAX_BENCHES = "".join(["bench", "marks"])     # the JAX package's benches


def sources():
    return sorted(p for p in BENCH.rglob("*.py")
                  if "__pycache__" not in p.parts)


def imported(path: Path):
    """Top-level names of every absolute import in ``path``, and every
    string handed to ``import_module``."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args and isinstance(
                    node.args[0], ast.Constant):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", sources(),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    found = set(imported(path)) & FORBIDDEN
    assert not found, f"{path} imports {sorted(found)}"


@pytest.mark.parametrize(
    "path", [p for p in sources() if "reference" in p.parts],
    ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    found = {n for n in imported(path) if n.startswith("repro")}
    assert not found, f"{path} imports {sorted(found)}"


@pytest.mark.parametrize("path", sources(),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_reads_the_jax_package_benchmarks(path):
    strings = [n.value for n in ast.walk(ast.parse(path.read_text()))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    assert not any(s == JAX_BENCHES or JAX_BENCHES + "/" in s
                   for s in strings), path


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole test-size run, in a process of its own (this one's
    conftest loads the JAX package's test shim)."""
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from portbench.tests import helpers
bench, root = helpers.tiny_root({str(tmp_path)!r})
for w in ("granite-3-2b.zero", "granite-3-2b.serve-decode"):
    line, _ = helpers.run(bench, root, w, seconds=0.2)
    assert line["correct"], line
found = sorted(m for m in sys.modules
               if m.split(".")[0] in {sorted(FORBIDDEN)!r})
print("FOUND", found)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout, out.stdout[-2000:]
