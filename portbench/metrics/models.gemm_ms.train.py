"""Device ms a traced training step spends in matrix products (cuBLAS /
CUTLASS kernels: the dense path's and the experts' float32 GEMMs)."""

from portbench.harness.trace import GEMM

MOVES = "train_tokens_per_s"


def read(record):
    t, f = record.trace, record.facts.get("traced")
    if t is None or not f:
        return None
    seconds = t.device_time(GEMM)
    return 1e3 * seconds / f["steps"] if seconds > 0 else None
