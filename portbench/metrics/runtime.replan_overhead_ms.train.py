"""What a re-plan costs a step, by the harness's clock: for each window
step in which the runtime's event list grew (a re-measurement, the DP and
the plan swap), its ms minus the median ms of the steps in which it did
not; the mean over the untraced window."""

import statistics

MOVES = "train_tokens_per_s"


def read(record):
    steps = record.facts["window"]["steps"]
    grew = [s for s, g, _ in steps if g]
    quiet = [s for s, g, _ in steps if not g]
    if not grew or not quiet:
        return None
    base = statistics.median(quiet)
    return 1e3 * statistics.fmean(s - base for s in grew)
