"""The useful share of the MoE's routed assignments in the traced steps,
in %: the port's counters ``moe.kept`` over ``moe.assignments``
(``repro_torch.tracing.counters()``), which ``models/moe.py::route``
adds to only while the profiler records, so they cover the traced
window alone (the forward and the recompute).  A port without the
counters reads nothing."""

MOVES = "train_tokens_per_s"


def read(record):
    if record.trace is None:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    c = tracing.counters()
    if not c.get("moe.assignments"):
        return None
    return 100.0 * c["moe.kept"] / c["moe.assignments"]
