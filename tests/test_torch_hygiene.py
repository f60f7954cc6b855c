"""The port stands alone: no JAX and nothing of ``repro`` in it.

``repro_torch`` and ``chip_smoke.py`` may import ``torch`` and numpy, but
never ``jax`` and no module of the reference package (which ``repro_torch``
itself matches as a prefix, so the checks compare module names exactly).
"""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _sources():
    for base, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)
    yield os.path.join(ROOT, "chip_smoke.py")


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


def test_importing_the_entry_points_loads_no_jax_or_reference():
    code = ("import sys, repro_torch.runtime, repro_torch.launch.train, "
            "repro_torch.dist, repro_torch.kernels; "
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
