"""The share of the traced batch's decode steps that replayed a captured
CUDA graph, in %: the port's counter ``serve.graph_replays``
(``repro_torch.tracing.counters()``), which ``serve/graphs.py`` adds to
once a replayed step while the profiler records, over the window
thread's ``serve.decode_step`` spans (one a decode step).  A port
without the counter, or a batch that replayed nothing, reads nothing."""

from portbench.harness import spans

MOVES = "itl_ms_p95"


def read(record):
    if record.trace is None:
        return None
    opened = spans.window_spans(record.trace, "serve.decode_step")
    if not opened:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    replays = tracing.counters().get("serve.graph_replays")
    if replays is None:
        return None
    return 100.0 * replays / len(opened)
