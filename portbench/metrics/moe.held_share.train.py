"""The share of the router's assignments that go to the experts this
device holds, in the traced steps, in %: the port's counters
``moe.assignments`` over ``moe.routed`` (``models/moe.py::route``, only
while the profiler records: the forward and the recompute).  A port
without the counters reads nothing."""

MOVES = "train_tokens_per_s"


def read(record):
    if record.trace is None:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    c = tracing.counters()
    if not c.get("moe.routed"):
        return None
    return 100.0 * c["moe.assignments"] / c["moe.routed"]
