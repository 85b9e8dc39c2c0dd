"""tower_attn_roofline.serve: the least time of the towers' attention in the
traced window (every block's self-attention over each frame's tokens and the
attention-pooling head's one query, from the frames each tower embedded, at
the serving precision) over the device time launched inside the program's
``vimo.tower.attn`` and ``vimo.tower.head`` spans (the head's span holds its
projections and MLP too)."""

from perfbench import flops
from perfbench.spans import total


def read(ctx):
    device_s = total(ctx, ["vimo.tower.attn", "vimo.tower.head"], "device_s")
    s = ctx.stats
    if device_s is None or not s.get("tower_attn_flops"):
        return None
    least = flops.least_time(s["tower_attn_flops"], s["tower_attn_bytes"],
                             ctx.config["serving"]["dtype"])
    return 100.0 * least / device_s
