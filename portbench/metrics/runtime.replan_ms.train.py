"""Host ms of a re-plan in the traced epoch: the mean length of the
port's ``runtime.replan`` spans (``DynamicTrainer._maybe_reschedule`` at
an epoch boundary: the costs, with the measurement pass where one is
due, the DP's decision and the plan swap)."""

from portbench.harness import spans

MOVES = "train_tokens_per_s"


def read(record):
    if record.trace is None:
        return None
    opened = spans.window_spans(record.trace, "runtime.replan")
    if not opened:
        return None
    return 1e3 * spans.open_s(opened) / len(opened)
