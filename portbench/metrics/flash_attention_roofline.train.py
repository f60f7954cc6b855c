"""``flash_fwd_kernel``'s share of its roofline in the traced training
units: the bound of each launch the trace holds (``counts/
flash_attention.py`` at the cell's one training shape) over the kernel's
traced device time, in %."""

from portbench.counts import flash_attention

MOVES = "train_tokens_per_s"


def read(record):
    t, calls = record.trace, record.facts.get("traced", {}).get(
        "flash_calls")
    if t is None or not calls or record.peaks is None:
        return None
    seconds = t.device_time(flash_attention.KERNEL)
    if seconds <= 0:
        return None
    n = t.count(flash_attention.KERNEL)
    return 100.0 * n * flash_attention.bound_s(calls[0], record.peaks) \
        / seconds
