"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel directory mirrors the reference's ``kernels/<name>/``:
``ops.py`` holds the wrapper (device dispatch, validation, launch count)
and ``ref.py`` the plain version; the CUDA sources live in ``csrc/`` and
are built at first use by :mod:`repro_torch.kernels._build`.

* ``bucket_pack`` — ragged segment copy: builds every collective operand
  of the ZeRO step (pack) and splits every gathered bucket (unpack).
* ``flash_attention`` — causal / windowed / softcapped attention forward.
"""

from typing import Dict

from repro_torch.kernels.bucket_pack import ops as _bucket_ops
from repro_torch.kernels.flash_attention import ops as _flash_ops

_COUNTERS = (_bucket_ops.LAUNCHES, _flash_ops.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    out: Dict[str, int] = {}
    for counter in _COUNTERS:
        out.update(counter)
    return out


def reset_launch_counts() -> None:
    for counter in _COUNTERS:
        for name in counter:
            counter[name] = 0


__all__ = ["launch_counts", "reset_launch_counts"]
