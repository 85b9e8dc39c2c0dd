"""Work and byte counts of a SigLIP tower (``reference/siglip.py``), as
``flops.py`` counts them: true matmul FLOPs, 2 a multiply-add, of the valid
frames handed in; attention at 4 H Tq Tk D forward.

A frame's forward: the patch embedding, the blocks over every patch token,
then the attention-pooling head (the probe's q projection, the tokens' k and
v projections, one query's attention over every token, the out projection
and the head's MLP). So400m/14 reads ~670 GFLOP a frame at 384 px and ~220
at 224 px."""

from __future__ import annotations

from perfbench import flops


def tokens(cfg: dict) -> int:
    return (cfg["image_size"] // cfg["patch_size"]) ** 2


def head_flops(cfg: dict) -> float:
    e, f, n = cfg["hidden_size"], cfg["intermediate_size"], tokens(cfg)
    return (2 * e * e + 2 * n * e * 2 * e + flops.attention_flops(1, 1, n, e, False)
            + 2 * e * e + 4 * e * f)


def tower_flops_per_frame(cfg: dict) -> float:
    e, p, n = cfg["hidden_size"], cfg["patch_size"], tokens(cfg)
    return (2 * n * 3 * p * p * e
            + flops.transformer_flops(n, e, cfg["intermediate_size"], cfg["num_layers"], False)
            + head_flops(cfg))


def tower_attention(cfg: dict, frames: int, itemsize: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the attention calls of ``frames`` frames: each
    block's self-attention over every token and the head's one query."""
    h, n = cfg["num_heads"], tokens(cfg)
    d = cfg["hidden_size"] // h
    f = cfg["num_layers"] * flops.attention_flops(h, n, n, d, False) \
        + flops.attention_flops(h, 1, n, d, False)
    b = cfg["num_layers"] * flops.attention_bytes(h, n, n, d, itemsize, False) \
        + flops.attention_bytes(h, 1, n, d, itemsize, False)
    return frames * f, frames * b
