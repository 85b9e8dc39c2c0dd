"""Work and byte counts, and the chip's published peaks (``peaks.json``).

FLOPs are true matmul FLOPs, 2 a multiply-add, counted from the valid
(unpadded) lengths of the work handed in; a training step is 3 times its
forward. Attention is 4 H Tq Tk D forward and 10 H Tq Tk D backward per
batch row, whichever kernels run it; its bytes count each input once and
each output once."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def peak_flops(dtype: str) -> float:
    """The dense peak a configuration's precision is held to: bf16's, or
    TF32's for float32 (no float32 product the checks admit runs faster)."""
    return PEAKS["bf16_flops_per_s" if dtype == "bfloat16" else "tf32_flops_per_s"]


def transformer_flops(t: int, d: int, ff: int, layers: int, cross: bool) -> float:
    """Matmul FLOPs of one forward over a t-token sequence (per batch
    element): q/k/v/out projections, attention score+value matmuls, FFN."""
    proj = 4 * 2 * t * d * d
    attn = 2 * 2 * t * t * d
    ffn = 2 * 2 * t * d * ff
    per_layer = proj + attn + ffn
    if cross:
        per_layer += proj + attn
    return layers * per_layer


def vit_flops_per_frame(cfg: dict) -> float:
    """A CLIP ViT's forward on one frame: patch embedding, the blocks over
    patches + CLS, and the projection."""
    e, p = cfg["hidden_size"], cfg["patch_size"]
    n = (cfg["image_size"] // p) ** 2
    return (2 * n * 3 * p * p * e
            + transformer_flops(n + 1, e, cfg["intermediate_size"], cfg["num_layers"], False)
            + 2 * e * cfg["projection_dim"])


VIT_B16 = {"image_size": 224, "patch_size": 16, "hidden_size": 768, "num_layers": 12,
           "intermediate_size": 3072, "projection_dim": 512}
VIT_B16_GFLOP_PER_FRAME = vit_flops_per_frame(VIT_B16) / 1e9  # 35.1


def tfam_forward_flops(tr: int, tm: int, cfg: dict, classes: int) -> float:
    """TFAM's cross-attention forward on one clip of tr RGB and tm motion
    frames: per layer self-attention over tr, cross-attention of tr
    queries to tm keys, the FFN; then the head."""
    d, ff = cfg["d_model"], cfg["dim_feedforward"]
    self_attn = 8 * tr * d * d + 4 * tr * tr * d
    cross = 4 * tr * d * d + 4 * tm * d * d + 4 * tr * tm * d
    ffn = 4 * tr * d * ff
    head = 2 * d * (d // 2) + 2 * (d // 2) * classes
    return cfg["num_layers"] * (self_attn + cross + ffn) + head


def attention_flops(heads: int, tq: int, tk: int, head_dim: int, backward: bool) -> float:
    return (10 if backward else 4) * heads * tq * tk * head_dim


def attention_bytes(heads: int, tq: int, tk: int, head_dim: int, itemsize: int,
                    backward: bool) -> float:
    """Forward: q, k, v in; out and lse (float32) out. Backward: q, k, v,
    out, dout, lse and delta in; dq, dk, dv out."""
    q, kv = heads * tq * head_dim * itemsize, heads * tk * head_dim * itemsize
    rows = heads * tq * 4
    if backward:
        return (q + 2 * kv + 2 * q + 2 * rows) + (q + 2 * kv)
    return (q + 2 * kv) + (q + rows)


def tfam_train_attention(lens_rgb, lens_motion, cfg: dict, itemsize: int):
    """(FLOPs, bytes) of every attention call of one training step (both
    sites of every layer, forward and backward), from each clip's valid
    lengths."""
    h = cfg["nhead"]
    dh = cfg["d_model"] // h
    flops = nbytes = 0.0
    for tr, tm in zip(lens_rgb, lens_motion):
        for tk in (tr, tm):
            for bwd in (False, True):
                flops += attention_flops(h, tr, tk, dh, bwd)
                nbytes += attention_bytes(h, tr, tk, dh, itemsize, bwd)
    return cfg["num_layers"] * flops, cfg["num_layers"] * nbytes


def least_time(flops: float, nbytes: float, dtype: str) -> float:
    """Seconds the chip needs at least: the larger of FLOPs over the peak
    and bytes over HBM bandwidth."""
    return max(flops / peak_flops(dtype), nbytes / PEAKS["hbm_bytes_per_s"])
