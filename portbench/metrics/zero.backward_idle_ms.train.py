"""Device-idle ms a traced training step while a ``zero.backward`` span
of the port is open: the spans' length minus their overlap with the
union of the card's kernel, memcpy and memset intervals."""

from portbench.harness import spans

MOVES = "train_tokens_per_s"


def read(record):
    n = spans.steps(record)
    if n is None:
        return None
    opened = spans.window_spans(record.trace, "zero.backward")
    if not opened:
        return None
    return 1e3 * spans.idle_s(record.trace, opened) / n
