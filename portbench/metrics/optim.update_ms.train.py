"""Device ms a traced training step launched inside the port's
``zero.optimizer`` span: the sharded AdamW update of every layer's
shard."""

from portbench.harness import spans

MOVES = "train_tokens_per_s"


def read(record):
    return spans.device_ms_per_step(record, "zero.optimizer")
