"""mfu.serve: the model FLOPs of the requests the traced window served (each
tower's forward on the frames it embedded, and TFAM's at each request's
lengths, as the driver counts them) over the window's seconds, against the
dense peak of the serving precision."""

from perfbench.readers import mfu


def read(ctx):
    return mfu(ctx, ctx.stats.get("flops"), ctx.config["serving"]["dtype"])
