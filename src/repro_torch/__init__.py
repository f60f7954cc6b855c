"""PyTorch / CUDA port of ``repro`` (DynaComm-scheduled distributed training).

Mirrors the reference package's relative paths; imports ``torch`` and
numpy, never JAX and nothing of the reference.  Entry points run on the
first CUDA device unless the caller passes ``device="cpu"``, where every
kernel wrapper takes its plain PyTorch version.
"""
