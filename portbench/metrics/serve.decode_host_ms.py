"""Host ms to enqueue one decode step of the traced batch: the median
length of the port's ``serve.decode_step`` spans
(``serve/decode.py::batched_generate``: the step's forward and the next
token's choice, the step hook left out)."""

import statistics

from portbench.harness import spans

MOVES = "itl_ms_p95"


def read(record):
    if record.trace is None:
        return None
    opened = spans.window_spans(record.trace, "serve.decode_step")
    if not opened:
        return None
    return 1e3 * statistics.median((e - s) / 1e6 for s, e in opened)
