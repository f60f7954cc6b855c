"""The training step's share of the card's float32 peak: the model FLOPs
of the untraced window's steps (``counts/model_flops.py``) over that
window's host-clock seconds, in %."""

MOVES = "train_tokens_per_s"


def read(record):
    if record.peaks is None:
        return None
    f = record.facts
    return 100.0 * f["model_flops"] / f["window"]["seconds"] \
        / record.peaks["flops"]
