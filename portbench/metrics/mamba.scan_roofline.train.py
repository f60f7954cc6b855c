"""The Mamba-2 SSD scan's share of its roofline in the traced training
units, in %: the bound of one call at the cell's shape
(``counts/mamba2_ssd.py``) times the port's ``mamba.scan`` spans in the
trace (forward and recompute of each Mamba-2 layer), over the device time
launched inside them."""

from portbench.counts import mamba2_ssd
from portbench.harness import spans

MOVES = "train_tokens_per_s"


def read(record):
    t = record.trace
    if t is None or record.peaks is None:
        return None
    calls = spans.window_spans(t, "mamba.scan")
    seconds = t.device_time_under(spans.PREFIX + "mamba.scan")
    if not calls or seconds <= 0:
        return None
    traffic = record.cell.traffic
    one = mamba2_ssd.call(record.cell.config, traffic["batch"],
                          traffic["seq"])
    return 100.0 * len(calls) * mamba2_ssd.bound_s(one, record.peaks) \
        / seconds
