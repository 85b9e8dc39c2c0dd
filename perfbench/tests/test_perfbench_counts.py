"""The yardstick's counts: ViT-B/16 at 35.1 GFLOP a frame, and the
attention's FLOPs and bytes at a known shape, the same whichever kernels
(K2, or K3 + K4 past 512 keys) run them."""

import pytest

from perfbench import flops


def test_vit_b16_frame():
    assert flops.VIT_B16_GFLOP_PER_FRAME == pytest.approx(35.1, abs=0.05)
    # 12 layers at 197 tokens plus the patch embedding and the projection
    body = 12 * (8 * 197 * 768**2 + 4 * 197**2 * 768 + 4 * 197 * 768 * 3072)
    assert flops.VIT_B16_GFLOP_PER_FRAME * 1e9 == pytest.approx(
        body + 2 * 196 * 768 * 768 + 2 * 768 * 512)


@pytest.mark.parametrize("tk", [512, 513, 2048])
def test_attention_counts_follow_the_work_not_the_kernel(tk):
    h, tq, d = 8, 640, 64
    assert flops.attention_flops(h, tq, tk, d, False) == 4 * h * tq * tk * d
    assert flops.attention_flops(h, tq, tk, d, True) == 10 * h * tq * tk * d
    fwd = flops.attention_bytes(h, tq, tk, d, 4, False)
    assert fwd == 4 * h * d * (tq + 2 * tk) + 4 * h * d * tq + 4 * h * tq
    bwd = flops.attention_bytes(h, tq, tk, d, 4, True)
    assert bwd == 4 * h * d * (3 * tq + 2 * tk) + 8 * h * tq + 4 * h * d * (tq + 2 * tk)


def test_training_step_counts_both_sites_both_ways():
    cfg = {"nhead": 8, "d_model": 512, "num_layers": 4, "dim_feedforward": 2048}
    f, b = flops.tfam_train_attention([600], [599], cfg, 4)
    one = lambda tk, bwd: flops.attention_flops(8, 600, tk, 64, bwd)
    assert f == 4 * (one(600, False) + one(600, True) + one(599, False) + one(599, True))
    assert b > 0
    fwd = flops.tfam_forward_flops(600, 599, cfg, 12)
    assert fwd > flops.transformer_flops(600, 512, 2048, 4, cross=False)


def test_least_time_takes_the_larger_bound():
    assert flops.least_time(495e12, 0.0, "float32") == pytest.approx(1.0)
    assert flops.least_time(0.0, 3.35e12, "bfloat16") == pytest.approx(1.0)
    assert flops.least_time(989e12, 1.0, "bfloat16") == pytest.approx(1.0)
