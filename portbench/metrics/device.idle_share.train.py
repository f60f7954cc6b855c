"""The card's idle share of the traced training units: 1 - (union of
its kernel, memcpy and memset intervals) / the traced window, in %."""

MOVES = "train_tokens_per_s"


def read(record):
    t = record.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
