"""Device ms a traced training step launched inside the port's
``zero.forward`` span: ``ZeroTrainer.step``'s no-grad forward (embedding,
blocks, final norm, head and loss)."""

from portbench.harness import spans

MOVES = "train_tokens_per_s"


def read(record):
    return spans.device_ms_per_step(record, "zero.forward")
