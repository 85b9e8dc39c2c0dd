"""idle_share.train: the share of the traced window in which the device ran
nothing (no kernel, copy or set), from the profiler's device intervals."""

from perfbench.readers import idle_share as read  # noqa: F401
