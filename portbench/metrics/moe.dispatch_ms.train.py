"""Device ms a traced training step spends in the MoE layer outside its
matrix products: routing (softmax, sort, one-hot position scan), dispatch
(``index_add`` into the expert buffer), the experts' activation, combine
(``index_select``, weighting) and the aux loss.  It counts the device work
launched inside the ``portbench.moe.apply`` spans the harness puts around
the port's ``apply_moe`` in the traced run (the forward and the
recompute); the backward, which the autograd engine launches from a
thread of its own, is not in it."""

from portbench.harness.trace import GEMM

MOVES = "train_tokens_per_s"
SPAN = "portbench.moe.apply"


def read(record):
    t, f = record.trace, record.facts.get("traced")
    if t is None or not f or not t.span_intervals(SPAN):
        return None
    seconds = t.device_time_under(SPAN, exclude=GEMM)
    return 1e3 * seconds / f["steps"] if seconds > 0 else None
