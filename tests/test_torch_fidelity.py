"""The port's fidelity probe (``vimoclip_tpu_torch/fidelity.py``) against
``vimoclip_tpu/fidelity.py`` on the CPU: the cosines it reports, the
sampled frames, the abort below the threshold, and the extraction CLI's
shard-aware, decode-tolerant probe."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimoclip_tpu import fidelity as jf
from vimoclip_tpu.data.video_reader import write_video
from vimoclip_tpu.models.clip_vit import ClipVisionConfig as JConfig
from vimoclip_tpu.models.clip_vit import ClipVisionEncoder as JEncoder
from vimoclip_tpu_torch import fidelity
from vimoclip_tpu_torch.cli import extract_embeddings
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig
from vimoclip_tpu_torch.models.convert import clip_vision_state_from_jax

torch.set_num_threads(1)

GEOM = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
            num_heads=4, intermediate_size=128, projection_dim=32)
CFG, JCFG = ClipVisionConfig(**GEOM), JConfig(**GEOM)
# per-frame cosines of float32 towers: the two stacks sum in other orders
COS_TOL = 1e-4


@pytest.fixture(scope="module")
def params():
    return jax.jit(JEncoder(JCFG).init)(jax.random.key(0),
                                        jnp.zeros((1, 32, 32, 3), jnp.float32))["params"]


@pytest.fixture(scope="module")
def state(params):
    return clip_vision_state_from_jax(params, CFG, prefix="")


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (4, 40, 48, 3), dtype=np.uint8)


@pytest.mark.parametrize("approx", [dict(matmul_quant="int8"), dict(token_merge_r=2),
                                    dict(matmul_quant="int8", token_merge_r=2)],
                         ids=["int8", "tome2", "int8+tome2"])
def test_probe_matches_jax(params, state, frames, approx):
    ref = jf.encoder_fidelity_probe(params, dataclasses.replace(JCFG, **approx), frames,
                                    half_precision=False)
    got = fidelity.encoder_fidelity_probe(state, dataclasses.replace(CFG, **approx), frames,
                                          half_precision=False, device="cpu")
    assert got["config"] == ref["config"] and got["n_frames"] == ref["n_frames"] == 4
    assert abs(got["cosine_min"] - ref["cosine_min"]) <= COS_TOL
    assert abs(got["cosine_mean"] - ref["cosine_mean"]) <= COS_TOL
    assert got["cosine_min"] < 1.0 and got["cosine_mean"] >= got["cosine_min"]
    if approx == dict(matmul_quant="int8"):
        assert got["cosine_min"] > 0.99


def test_probe_requires_an_approximation(state, frames):
    with pytest.raises(ValueError, match="no approximation"):
        fidelity.encoder_fidelity_probe(state, CFG, frames, device="cpu")


def test_probe_defaults_to_the_card(state, frames):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fidelity.encoder_fidelity_probe(
            state, dataclasses.replace(CFG, matmul_quant="int8"), frames)


def test_check_aborts_below_threshold(state, frames, tmp_path):
    video = str(tmp_path / "probe.mp4")
    write_video(video, frames)
    qcfg = dataclasses.replace(CFG, matmul_quant="int8")
    report = fidelity.check_encoder_fidelity(state, qcfg, video, 3, threshold=0.5,
                                             half_precision=False, device="cpu")
    assert report["cosine_min"] > 0.5 and report["n_frames"] == 3
    with pytest.raises(fidelity.FidelityError, match="below --fidelity-threshold"):
        fidelity.check_encoder_fidelity(state, qcfg, video, 3, threshold=1.0,
                                        half_precision=False, device="cpu")


def test_sample_video_frames_match_jax(tmp_path):
    video = str(tmp_path / "clip.mp4")
    write_video(video, np.random.default_rng(1).integers(0, 256, (11, 32, 32, 3),
                                                         dtype=np.uint8))
    for n in (4, 50):
        got, ref = fidelity.sample_video_frames(video, n), jf.sample_video_frames(video, n)
        np.testing.assert_array_equal(got, ref)
    assert fidelity.sample_video_frames(video, 50).shape[0] == 11


def test_sample_motion_probe_frames_match_jax(tmp_path):
    """The student's probe frames: BT.601 absdiffs of sampled consecutive
    pairs, equal to JAX's bit for bit."""
    video = str(tmp_path / "clip.mp4")
    write_video(video, np.random.default_rng(2).integers(0, 256, (9, 32, 32, 3),
                                                         dtype=np.uint8))
    got = fidelity.sample_motion_probe_frames(video, 4, device="cpu")
    assert got.shape == (4, 32, 32, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jf.sample_motion_probe_frames(video, 4))
    short = str(tmp_path / "short.mp4")
    write_video(short, np.zeros((1, 32, 32, 3), dtype=np.uint8))
    with pytest.raises(ValueError, match="2 frames"):
        fidelity.sample_motion_probe_frames(short, 4, device="cpu")


def _hf_checkpoint(path, seed):
    from transformers import CLIPVisionConfig as HFConfig
    from transformers import CLIPVisionModelWithProjection

    torch.manual_seed(seed)
    hf = CLIPVisionModelWithProjection(HFConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, image_size=32, patch_size=8, projection_dim=16))
    torch.save(hf.state_dict(), path)
    return str(path)


def test_extract_cli_probe_is_shard_aware_and_decode_tolerant(tmp_path, capfd):
    """As ``tests/test_fidelity.py`` pins for JAX: the probe samples this
    shard's videos and skips an unreadable one with a warning; a shard with
    no readable video raises; the probe runs before any HDF5 is written."""
    rng = np.random.default_rng(6)
    root = tmp_path / "videos"
    root.mkdir()
    # v0 is annotated but missing; with 2 shards, shard 0 sees (v0, v2)
    for name in ("v1.mp4", "v2.mp4"):
        write_video(str(root / name), rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8))
    (tmp_path / "train.txt").write_text("v0.mp4 0\nv1.mp4 0\nv2.mp4 0\n")
    (tmp_path / "classes.csv").write_text("id,name\n0,run\n")
    ckpt = _hf_checkpoint(tmp_path / "clip.pt", 3)
    base = ["--data-root", str(root), "--class-file", str(tmp_path / "classes.csv"),
            "--clip-weights", ckpt, "--batch-size", "8", "--split", "train", "--float32",
            "--quantize", "int8", "--verify-fidelity", "3", "--device", "cpu"]
    out = tmp_path / "shard0.h5"
    extract_embeddings.main(base + ["--annotation-file", str(tmp_path / "train.txt"),
                                    "--fidelity-threshold", "0.5", "--num-shards", "2",
                                    "--shard-index", "0", "--output", str(out)])
    assert out.exists()
    log = capfd.readouterr().err
    assert "fidelity probe: cannot read" in log and "v0.mp4" in log
    assert "fidelity probe (teacher ViT, int8, 3 frames from" in log and "v2.mp4" in log

    bad = tmp_path / "bad.h5"
    with pytest.raises(fidelity.FidelityError):
        extract_embeddings.main(base + ["--annotation-file", str(tmp_path / "train.txt"),
                                        "--fidelity-threshold", "1.0", "--output", str(bad)])
    assert not bad.exists()

    (tmp_path / "missing.txt").write_text("missing_a.mp4 0\nmissing_b.mp4 0\n")
    with pytest.raises(RuntimeError, match="no readable video"):
        extract_embeddings.main(base + ["--annotation-file", str(tmp_path / "missing.txt"),
                                        "--output", str(tmp_path / "never.h5")])
    assert not (tmp_path / "never.h5").exists()
