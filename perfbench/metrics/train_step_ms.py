"""train_step_ms: the window's milliseconds over every optimizer step it
completed (host clock, ending in a device sync)."""


def read(ctx):
    s = ctx.stats
    return 1e3 * s["seconds"] / s["steps"] if s["steps"] else None
