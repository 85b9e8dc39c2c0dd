"""fetch_wait_ms.train: host milliseconds a step in the program's
``vimo.train.loss_fetch`` (``float(loss)``, which waits for the step on the
card) and ``vimo.train.metric`` (the metric update) spans."""

from perfbench.spans import ms_per


def read(ctx):
    return ms_per(ctx, ["vimo.train.loss_fetch", "vimo.train.metric"], "host_s", "steps")
