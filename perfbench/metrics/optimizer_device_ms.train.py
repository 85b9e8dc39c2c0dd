"""optimizer_device_ms.train: device milliseconds a step of the kernels,
copies and sets launched inside the program's ``vimo.train.optimizer`` span
(AdamW's step and the schedule's)."""

from perfbench.spans import ms_per


def read(ctx):
    return ms_per(ctx, ["vimo.train.optimizer"], "device_s", "steps")
