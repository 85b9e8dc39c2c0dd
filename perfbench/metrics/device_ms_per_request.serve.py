"""device_ms_per_request.serve: the device's busy milliseconds in the traced
window over the requests answered in it."""


def read(ctx):
    if ctx.trace is None or not ctx.stats["units"]:
        return None
    return 1e3 * ctx.trace.busy_s / ctx.stats["units"]
