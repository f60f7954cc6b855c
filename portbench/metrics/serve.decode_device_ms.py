"""Device ms of one decode step of the traced batch: the work launched
inside the port's ``serve.decode_step`` spans, over the spans (one a
decode step, each serving a token to every request of the batch)."""

from portbench.harness import spans

MOVES = "itl_ms_p95"


def read(record):
    if record.trace is None:
        return None
    t = record.trace
    opened = spans.window_spans(t, "serve.decode_step")
    if not opened:
        return None
    return 1e3 * t.device_time_under(spans.PREFIX + "serve.decode_step") \
        / len(opened)
