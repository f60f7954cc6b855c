"""Device ms a traced training step launched inside the port's
``mla.attention`` spans (``models/attention.py::mla``: the q and latent
projections, the norm, rope, the decompression through ``W_kvb``, flash
and the output projection), in the forward and in the recompute of every
latent-attention layer."""

from portbench.harness import spans

MOVES = "train_tokens_per_s"


def read(record):
    return spans.device_ms_per_step(record, "mla.attention")
