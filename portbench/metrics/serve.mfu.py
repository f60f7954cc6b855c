"""Serving's share of the card's float32 peak: the model FLOPs of the
untraced window's batches (``counts/model_flops.py``: prefills and the
decode steps that serve a token) over its host-clock seconds, in %."""

MOVES = "serve_tokens_per_s"


def read(record):
    if record.peaks is None:
        return None
    f = record.facts
    return 100.0 * f["model_flops"] / f["seconds"] / record.peaks["flops"]
