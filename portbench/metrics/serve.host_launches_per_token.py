"""Host calls that enqueue device work (kernel, memcpy, memset and graph
launches) per decode step of the traced batch: those made between the
mark after the prefill and the mark after the last decode step, over the
decode steps.  A step serves one token to every request of the batch."""

MOVES = "itl_ms_p95"


def read(record):
    t, f = record.trace, record.facts.get("traced")
    if t is None or not f or f["decode_interval"] is None:
        return None
    n = t.launches_in([tuple(f["decode_interval"])])
    return n / f["decode_steps"] if n else None
