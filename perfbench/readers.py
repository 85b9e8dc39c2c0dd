"""What the metrics' readers share. A reader that finds nothing to read
returns None, and the metric is left out of the line."""

from __future__ import annotations

import math

from perfbench import flops


def p95(values: list[float]) -> float | None:
    """The 95th percentile by nearest rank over all the values."""
    if not values:
        return None
    ranked = sorted(values)
    return ranked[max(math.ceil(0.95 * len(ranked)) - 1, 0)]


def latencies_with_failures(ctx) -> list[float]:
    """Every request of the window: a failed one counts as taking the
    whole window."""
    s = ctx.stats
    return s.get("latencies_s", []) + [s["seconds"]] * s["failed"]


def idle_share(ctx) -> float | None:
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(ctx, model_flops: float, dtype: str) -> float | None:
    seconds = ctx.stats["seconds"]
    if not model_flops or seconds <= 0:
        return None
    return 100.0 * model_flops / seconds / flops.peak_flops(dtype)
