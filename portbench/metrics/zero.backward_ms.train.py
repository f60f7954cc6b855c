"""Device ms a traced training step launched inside the port's
``zero.backward`` spans: one a backward bucket of ``ZeroTrainer.step``,
around its layers' recompute and VJP.  The autograd engine launches the
backward from a thread of its own while the span's thread waits in
``torch.autograd.grad``, so its launches fall inside the span by time."""

from portbench.harness import spans

MOVES = "train_tokens_per_s"


def read(record):
    return spans.device_ms_per_step(record, "zero.backward")
