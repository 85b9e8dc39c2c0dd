"""attn_roofline.train: the least time of the traced steps' attention calls
(the larger of their FLOPs over the peak and their bytes over HBM
bandwidth, from each clip's valid lengths) over the device time of the
attention kernels, by the names below."""

from perfbench import flops

# every kernel of ops/kernels/flash_attention.py (csrc/flash_attention_*.cu)
KERNELS = ("fwd_tf32_kernel", "dkv_tf32_kernel", "dq_tf32_kernel", "dq_tf32_wide_kernel",
           "fwd_wgmma_kernel", "dqkv_wgmma_kernel", "dq_wgmma_kernel", "dkv_wgmma_kernel",
           "fwd_pair_wgmma_kernel", "dkv_pair_wgmma_kernel", "dq_pair_wgmma_kernel",
           "dq_reduce_kernel", "keep_bits_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = ctx.trace.kernel_time(KERNELS)
    s = ctx.stats
    if device_s <= 0 or not s.get("attn_flops"):
        return None
    least = flops.least_time(s["attn_flops"], s["attn_bytes"], ctx.config["training"]["dtype"])
    return 100.0 * least / device_s
