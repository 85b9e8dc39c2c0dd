"""step_span_ms.train: host milliseconds a step in the program's
``vimo.train.step`` span, around ``TFAMTrainer.train_step`` (launches of the
forward, backward and optimizer; it waits on the card only when its queue
is full)."""

from perfbench.spans import ms_per


def read(ctx):
    return ms_per(ctx, ["vimo.train.step"], "host_s", "steps")
