"""Device ms a traced training step launched inside the port's
``zero.pull`` and ``zero.push`` spans: DynaComm's transmission segments,
the bucket copies (pack, unpack) and the collectives of each forward
pull, ZeRO-3's re-pulls and each backward push with its mean."""

from portbench.harness import spans

MOVES = "train_tokens_per_s"


def read(record):
    return spans.device_ms_per_step(record, "zero.pull", "zero.push")
