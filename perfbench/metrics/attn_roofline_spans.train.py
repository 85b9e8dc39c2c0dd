"""attn_roofline_spans.train: the least time of the traced steps' attention
calls (as ``attn_roofline.train`` counts it, from each clip's valid lengths)
over the device time launched inside the program's ``vimo.attn.fwd`` and
``vimo.attn.bwd`` spans: attention found by span, not by kernel name."""

from perfbench import flops
from perfbench.spans import total


def read(ctx):
    device_s = total(ctx, ["vimo.attn.fwd", "vimo.attn.bwd"], "device_s")
    s = ctx.stats
    if device_s is None or not s.get("attn_flops"):
        return None
    least = flops.least_time(s["attn_flops"], s["attn_bytes"], ctx.config["training"]["dtype"])
    return 100.0 * least / device_s
