"""Device ms a traced training step launched inside the port's
``moe.route`` spans (``models/moe.py::route``: the top-k sort, the
one-hot and the position scan), in the forward and in the recompute."""

from portbench.harness import spans

MOVES = "train_tokens_per_s"


def read(record):
    return spans.device_ms_per_step(record, "moe.route")
