"""The share of the traced steps' AdamW buffer updates that the port's
one-pass CUDA kernel ran, in %: the port's counters ``optim.fused`` over
``optim.buffers`` (``repro_torch.tracing.counters()``), which
``optim/optimizers.py::adamw`` adds to only while the profiler records,
once a buffer that has a gradient.  A port without the counters reads
nothing."""

MOVES = "train_tokens_per_s"


def read(record):
    if record.trace is None:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    c = tracing.counters()
    if not c.get("optim.buffers"):
        return None
    return 100.0 * c.get("optim.fused", 0) / c["optim.buffers"]
