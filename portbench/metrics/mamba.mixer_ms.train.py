"""Device ms a traced training step launched inside the port's
``mamba.mixer`` spans (``models/ssm.py::apply_mamba2``: the projections,
the conv, the SSD scan, the gated norm), in the forward and in the
recompute of every Mamba-2 layer."""

from portbench.harness import spans

MOVES = "train_tokens_per_s"


def read(record):
    return spans.device_ms_per_step(record, "mamba.mixer")
