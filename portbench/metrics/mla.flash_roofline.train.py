"""The flash kernel's share of its roofline under latent attention, in
the traced training units, in %: the bound of one call at the cell's
shape (``counts/mla_attention.py``: Q K^T over the q / k head dim, P V
over v's) times the ``flash_fwd_kernel`` launches made inside the port's
``mla.attention`` spans, over those launches' device time."""

import bisect

from portbench.counts import flash_attention, mla_attention
from portbench.harness import spans

MOVES = "train_tokens_per_s"


def read(record):
    t = record.trace
    if t is None or record.peaks is None:
        return None
    opened = spans.merged(spans.window_spans(t, "mla.attention"))
    if not opened:
        return None
    starts = [s for s, _ in opened]
    launched = set()
    for ts, corr in t.launches:
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= opened[i][1]:
            launched.add(corr)
    kernels = [e - s for s, e, name, corr in t.device
               if corr in launched and flash_attention.KERNEL.search(name)]
    if not kernels or sum(kernels) <= 0:
        return None
    traffic = record.cell.traffic
    one = mla_attention.call(record.cell.config, traffic["batch"],
                             traffic["seq"])
    return 100.0 * len(kernels) * mla_attention.bound_s(one, record.peaks) \
        / (sum(kernels) / 1e6)
