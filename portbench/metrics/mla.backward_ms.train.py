"""Device ms a traced training step launched inside the port's
``mla.backward`` spans: a latent-attention mixer's backward, from the
gradient of its output to the gradient of its input.  The autograd
engine opens them on its own thread, so they are read from every
thread's host spans, and the work launched inside them by time is
theirs."""

from portbench.harness import spans

MOVES = "train_tokens_per_s"


def read(record):
    n = spans.steps(record)
    if n is None:
        return None
    opened = spans.any_thread_spans(record.trace, "mla.backward")
    if not opened:
        return None
    return 1e3 * spans.launched_s(record.trace, opened) / n
