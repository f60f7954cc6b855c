"""``copy_chunks_kernel`` (the port's ``csrc/bucket_pack.cu``): the bytes
one ZeRO step's bucket copies move.

A pull packs a bucket's shards (read and write ``shard`` each) and
unpacks the gathered buffer into the layers' full flats (read and write
``A x shard``); a push packs the layers' gradient leaves into one operand
(read ``total``, write ``padded``: the padding is zeros written, nothing
read).  Every layer is pulled once and pushed once a step, whatever the
plan, so the count depends on the plan only through what it names.
"""

from __future__ import annotations

import re
from typing import Sequence

KERNEL = re.compile(r"copy_chunks_kernel")


def step_bytes(specs: Sequence, plan, itemsize: int = 4) -> int:
    """``specs``: per sched layer ``(total, padded, axis_size)``; ``plan``:
    ``(forward buckets, backward buckets)`` of sched-layer ids."""
    forward, backward = plan
    n = 0
    for bucket in forward:
        for l in bucket:
            total, padded, axis = specs[l]
            shard = padded // axis
            n += 2 * shard + 2 * axis * shard
    for bucket in backward:
        for l in bucket:
            total, padded, _ = specs[l]
            n += total + padded
    return itemsize * n


def launches(plan) -> int:
    """Copy launches a step: a pack and an unpack a pull, a pack a push."""
    forward, backward = plan
    return 2 * len(forward) + len(backward)
