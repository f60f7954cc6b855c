"""Prefill ms per 1,000 prompt tokens over the untraced window: each
batch's prefill from CUDA events (start to the mark after the prefill),
summed, over the prompt tokens served."""

MOVES = "serve_tokens_per_s"


def read(record):
    f = record.facts
    if not f["prompt_tokens"]:
        return None
    return 1e3 * f["prefill_ms"] / f["prompt_tokens"]
