"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file has a plain C interface, so each compiles in
seconds into its own shared library (no PyTorch headers).  The first call
to :func:`library` builds all of them at once, one ``nvcc`` process per
source, into ``build/repro_torch/<hash>/`` at the root of the checkout (the
hash covers the sources and the flags, so an edited source rebuilds).  Set
``REPRO_TORCH_BUILD_DIR`` to build elsewhere.  Nothing is built when a
module is imported: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("bucket_pack", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_INFO: Dict[str, object] = {}     # seconds, directory, nvcc logs


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels of repro_torch are built at first "
                       "use")


def _build_root() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / f"{name}.cu").read_bytes())
    return h.hexdigest()[:16]


def _build_all() -> Dict[str, ctypes.CDLL]:
    out = _build_root() / _source_hash()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out / f".lib{name}.{os.getpid()}.so"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    logs = {}
    for name, (proc, tmp, lib) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{logs[name]}")
        os.replace(tmp, lib)          # atomic: concurrent builders agree
    BUILD_INFO.update(seconds=time.perf_counter() - t0, directory=str(out),
                      built=sorted(procs), logs=logs)
    return {name: ctypes.CDLL(str(out / f"lib{name}.so")) for name in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built on first use)."""
    with _LOCK:
        if not _LIBS:
            _LIBS.update(_build_all())
    return _LIBS[name]


def check(status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
