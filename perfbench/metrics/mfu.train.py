"""mfu.train: the training steps' model FLOPs (3 times the forward, from each
clip's valid lengths) over the traced window's seconds, against the dense
peak of the training precision (TF32's for float32)."""

from perfbench.readers import mfu


def read(ctx):
    return mfu(ctx, ctx.stats.get("flops"), ctx.config["training"]["dtype"])
