"""The run's environment: cache directories, the card, its peaks, and the
modules a result may not come with.

Every build and kernel cache sits at a fixed path inside the checkout
(``build/portbench/``, which git ignores), so only the first run of a
checkout builds: the port's nvcc outputs (``REPRO_TORCH_BUILD_DIR``),
Triton's cache and PyTorch's extension directory.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from portbench.harness.cell import ROOT

# top-level module names (compared whole) no run may hold once its window
# has closed: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# published dense peaks of the card the cells compute on, float32 outside
# the tensor cores (the configurations run float32 with TF32 off) and HBM
# bytes/s (NVIDIA's H100 SXM data sheet, at its 700 W limit)
PEAKS = {"H100": {"flops": 67e12, "bytes_per_s": 3.35e12,
                  "what": "H100 SXM: fp32 67 TFLOP/s (no tensor cores), "
                          "HBM3 3.35 TB/s, at 700 W"}}


class NoCard(RuntimeError):
    """The run needs more CUDA cards than this machine shows."""


def cache_dirs(root: Path = ROOT) -> Dict[str, Path]:
    """Fix every cache inside the checkout; returns the directories."""
    base = Path(root) / "build" / "portbench"
    dirs = {"REPRO_TORCH_BUILD_DIR": base / "kernels",
            "TRITON_CACHE_DIR": base / "triton",
            "TORCH_EXTENSIONS_DIR": base / "torch_extensions",
            "work": base / "work"}
    for key, path in dirs.items():
        path.mkdir(parents=True, exist_ok=True)
        if key != "work":
            os.environ[key] = str(path)
    os.environ["USE_FLAX"] = "0"         # no library may load JAX for us
    return dirs


def require_cards(n: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: the benchmark "
                     "measures the card and has no CPU fallback")
    have = torch.cuda.device_count()
    if have < n:
        raise NoCard(f"the cell needs {n} card(s), this machine shows {have}")


def strict_float32() -> None:
    """float32 as the configurations state it: no TF32 anywhere."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def forbidden_loaded() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def peaks(kind: str) -> Optional[Dict[str, Any]]:
    for key, value in PEAKS.items():
        if key in kind:
            return value
    return None


def power_limit() -> Optional[str]:
    """``nvidia-smi``'s power limit of card 0 (waited for), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def device_record(device, count: int, peak_bytes: int) -> Dict[str, Any]:
    """The result's ``device`` field."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": peak_bytes}
    kind = torch.cuda.get_device_name(device)
    rec = {"platform": "gpu", "kind": kind, "count": count,
           "memory_peak_bytes": int(peak_bytes),
           "power_limit": power_limit()}
    peak = peaks(kind)
    if peak is not None:
        rec["peak"] = peak["what"]
    return rec
