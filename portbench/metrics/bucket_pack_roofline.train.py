"""``copy_chunks_kernel``'s share of its roofline in the traced training
units: the bytes the plan's bucket copies move (``counts/bucket_pack.py``)
over HBM's rate, against the kernel's traced device time, in %.  Read
only where the trace holds every copy the plan launches."""

from portbench.counts import bucket_pack

MOVES = "train_tokens_per_s"


def read(record):
    t, f = record.trace, record.facts.get("traced")
    if t is None or not f or record.peaks is None:
        return None
    if f["copy_launches_in_trace"] != f["copy_launches_expected"]:
        return None
    seconds = t.device_time(bucket_pack.KERNEL)
    if seconds <= 0:
        return None
    return 100.0 * f["copy_bytes"] / record.peaks["bytes_per_s"] / seconds
