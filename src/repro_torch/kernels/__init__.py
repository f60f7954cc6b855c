"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel directory mirrors the reference's ``kernels/<name>/``:
``ops.py`` holds the wrapper (device dispatch, validation, launch count)
and ``ref.py`` the plain version; the CUDA sources live in ``csrc/`` and
are built at first use by :mod:`repro_torch.kernels._build`.

* ``bucket_pack`` — ragged segment copy: builds every collective operand
  of the ZeRO step (pack) and splits every gathered bucket (unpack).
* ``flash_attention`` — causal / windowed / softcapped attention forward.
* ``compress`` — int8 quantize / dequantize and top-k sparsify / densify:
  the compressed gradient push of the ``ps`` runtime.
* ``rglru_scan`` — the RG-LRU linear recurrence of recurrentgemma's
  recurrent blocks, forward (or reverse) and its fused backward.
* ``moe_positions`` — each MoE assignment's position inside its expert, and
  the dispatch slot and keep flag after it (no TPU kernel: XLA fuses the
  reference's one-hot cumulative sum).
* ``adamw`` — AdamW's update of one flat buffer in one pass (no TPU kernel:
  XLA fuses the reference's elementwise update).
"""

from typing import Dict

from repro_torch.kernels.adamw import ops as _adamw_ops
from repro_torch.kernels.bucket_pack import ops as _bucket_ops
from repro_torch.kernels.compress import ops as _compress_ops
from repro_torch.kernels.flash_attention import ops as _flash_ops
from repro_torch.kernels.moe_positions import ops as _moe_ops
from repro_torch.kernels.rglru_scan import ops as _rglru_ops

_COUNTERS = (_bucket_ops.LAUNCHES, _flash_ops.LAUNCHES,
             _compress_ops.LAUNCHES, _rglru_ops.LAUNCHES, _moe_ops.LAUNCHES,
             _adamw_ops.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    out: Dict[str, int] = {}
    for counter in _COUNTERS:
        out.update(counter)
    return out


def reset_launch_counts() -> None:
    """Every count of ``launch_counts()`` and flash's count of the template
    of a narrower v to 0."""
    for counter in _COUNTERS + (_flash_ops.NARROW_V_LAUNCHES,):
        for name in counter:
            counter[name] = 0


__all__ = ["launch_counts", "reset_launch_counts"]
