"""The card's idle share while the port's ``runtime.measure`` spans are
open (``runtime/measure.py::measure_layer_times``: each layer's forward
and VJP timed by CUDA events, with a synchronisation a layer and
phase), in %."""

from portbench.harness import spans

MOVES = "train_tokens_per_s"


def read(record):
    if record.trace is None:
        return None
    opened = spans.window_spans(record.trace, "runtime.measure")
    if not opened:
        return None
    return 100.0 * spans.idle_s(record.trace, opened) / spans.open_s(opened)
