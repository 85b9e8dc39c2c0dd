"""The SigLIP cell's parts at a small size on the CPU: the So400m/14 counts,
the plain tower against ``transformers``, the driver's window (its FLOPs
from the predictor's frame counters, which it holds to the frames it sent)
and the two readers that read it."""

import numpy as np
import pytest
import torch

from perfbench import flops, flops_siglip, harness, registry, spans, weights
from perfbench.reference import siglip as ref_siglip
from perfbench.tests import small

CELL = "ak.serve.clip.so400m"
SO400M = {"image_size": 384, "patch_size": 14, "hidden_size": 1152, "num_layers": 27,
          "num_heads": 16, "intermediate_size": 4304}


def test_so400m_counts():
    gemm = 27 * (8 * 729 * 1152**2 + 4 * 729 * 1152 * 4304)
    attn = 27 * 4 * 729**2 * 1152
    head_kv = 2 * 729 * 1152 * 2304
    assert (gemm, attn, head_kv) == pytest.approx((599e9, 66.1e9, 3.87e9), rel=2e-3)
    teacher = flops_siglip.tower_flops_per_frame(SO400M)
    assert teacher / 1e9 == pytest.approx(670, rel=3e-3)
    assert teacher > gemm + attn + head_kv
    student = flops_siglip.tower_flops_per_frame({**SO400M, "image_size": 224})
    assert student / 1e9 == pytest.approx(220, rel=5e-3)
    f, b = flops_siglip.tower_attention(SO400M, 3, 2)
    assert f == 3 * (27 * flops.attention_flops(16, 729, 729, 72, False)
                     + flops.attention_flops(16, 1, 729, 72, False))
    assert b == 3 * (27 * flops.attention_bytes(16, 729, 729, 72, 2, False)
                     + flops.attention_bytes(16, 1, 729, 72, 2, False))


def test_plain_tower_equals_transformers():
    transformers = pytest.importorskip("transformers")
    spec = {"image_size": 28, "patch_size": 14, "hidden_size": 64, "num_layers": 2,
            "num_heads": 4, "intermediate_size": 96, "layer_norm_eps": 1e-6}
    params = weights.make_params(ref_siglip.param_shapes(spec), weights.generator(9, 1, "cpu"))
    hf = transformers.SiglipVisionModel(transformers.SiglipVisionConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=96,
        image_size=28, patch_size=14, layer_norm_eps=1e-6,
        hidden_act="gelu_pytorch_tanh")).eval()
    hf.vision_model.load_state_dict(params, strict=False)
    missing = set(hf.vision_model.state_dict()) - set(params)
    assert missing <= {"embeddings.position_ids"}
    pixels = torch.randn(3, 28, 28, 3)
    with torch.no_grad():
        want = hf(pixel_values=pixels.permute(0, 3, 1, 2)).pooler_output
    got = ref_siglip.tower(params, spec, pixels)
    # float32 both: summation order alone
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def tiny_config() -> dict:
    """The cell's configuration at small widths (the CPU tests' size)."""
    c = small.config(small.bench(), "vimoclip-ak-siglip-so400m")
    tower = {"image_size": 28, "hidden_size": 64, "num_layers": 2, "num_heads": 4,
             "intermediate_size": 96}
    c["teacher"].update(tower)
    c["student"].update(tower)
    c["tfam"].update(d_model=64, nhead=4, dim_feedforward=128)
    return c


def _driver():
    c, t = tiny_config(), small.traffic("serve.clip.so400m")
    drv = registry.driver(t["driver"]).Driver(c, t, 2**31 + 21, "cpu")
    drv.setup()
    return drv, c


def test_the_window_counts_what_it_served():
    drv, c = _driver()
    stats = drv.window(0.5, traced=False)
    sent = drv.sent
    assert sent and stats["attempted"] == len(sent)
    frames = sum(sent)
    per = flops_siglip.tower_flops_per_frame
    tfam = sum(flops.tfam_forward_flops(n, n - 1, c["tfam"], c["num_classes"]) for n in sent)
    assert stats["flops"] == pytest.approx(frames * per(c["teacher"])
                                           + (frames - len(sent)) * per(c["student"]) + tfam)
    f_t, b_t = flops_siglip.tower_attention(c["teacher"], frames, 2)
    f_s, b_s = flops_siglip.tower_attention(c["student"], frames - len(sent), 2)
    assert (stats["tower_attn_flops"], stats["tower_attn_bytes"]) == (f_t + f_s, b_t + b_s)


def test_a_counter_that_misses_frames_fails_the_window(monkeypatch):
    from vimoclip_tpu_torch.serving import ViMoCLIPPredictor

    drv, _ = _driver()
    count = ViMoCLIPPredictor._count
    monkeypatch.setattr(ViMoCLIPPredictor, "_count",
                        lambda self, **k: count(self, **{**k, "student_frames": 0}))
    with pytest.raises(RuntimeError, match="student_frames"):
        drv.window(0.3, traced=False)


def test_a_small_traced_run_is_correct_and_reads_its_share():
    b = small.bench()
    # the cell's limit is set for the published widths: held to the bf16
    # reading's own scale at width 64 here (1.6e-4 seen), every answer there
    line = harness.run_cell(b, registry.workload(b, CELL), 2**31 + 23, 1.0, True, "cpu",
                            config=tiny_config(), traffic=small.traffic("serve.clip.so400m"),
                            limits={})
    assert line["correct"], line["checks"]
    assert line["numbers"]["logit_cos_dist"] < 1e-3
    # a CPU run has no device time: the roofline share is left out
    assert 0 < line["metrics"]["mfu.serve"]["value"] < 100
    assert "tower_attn_roofline.serve" not in line["metrics"]


def _read(name, stats, dtype="bfloat16", traced=True):
    ctx = harness.Context(CELL, {"serving": {"dtype": dtype}}, {}, stats, 0.0,
                          object() if traced else None)
    return registry.metric_reader(name)(ctx)


def test_mfu_is_the_windows_flops_over_its_seconds_at_the_peak():
    assert _read("mfu.serve", {"flops": 989e12, "seconds": 2.0}) == pytest.approx(50.0)
    assert _read("mfu.serve", {"flops": 0.0, "seconds": 2.0}) is None


def test_the_roofline_reads_the_towers_spans(monkeypatch):
    stats = {"tower_attn_flops": 989e12 * 0.25, "tower_attn_bytes": 1.0}
    table = {"vimo.tower.attn": {"count": 3, "host_s": 1.0, "device_s": 0.4},
             "vimo.tower.head": {"count": 1, "host_s": 1.0, "device_s": 0.1}}
    monkeypatch.setattr(spans, "of_run", lambda ctx: table)
    assert _read("tower_attn_roofline.serve", stats) == pytest.approx(50.0)
    # a program without the spans (the parent's) reads nothing
    monkeypatch.setattr(spans, "of_run", lambda ctx: {"vimo.serve.embed": table[
        "vimo.tower.attn"]})
    assert _read("tower_attn_roofline.serve", stats) is None
    monkeypatch.setattr(spans, "of_run", lambda ctx: table)
    assert _read("tower_attn_roofline.serve", {"tower_attn_flops": 0.0}) is None


def test_the_squash_resize_keeps_every_row_and_column():
    frames = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 36, 60, 3),
                                                                dtype=np.uint8))
    x = ref_siglip.preprocess(frames, 28)
    assert x.shape == (2, 28, 28, 3)
    # a constant frame stays constant: each output pixel's weights sum to 1
    flat = ref_siglip.preprocess(torch.full((1, 36, 60, 3), 200, dtype=torch.uint8), 28)
    torch.testing.assert_close(flat, torch.full_like(flat, (200 - 127.5) / 127.5))
