"""The port's serving cascade against the JAX predictor on the CPU, and the
port's ``cli.predict`` on reference-format ``.pth`` files."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vimoclip_tpu.config import TFAMModelConfig as JTFAMConfig
from vimoclip_tpu.data.video_reader import write_video
from vimoclip_tpu.models import TFAM as JTFAM
from vimoclip_tpu.models.clip_convert import clip_vision_params_from_openai
from vimoclip_tpu.models.clip_vit import ClipVisionConfig as JVision
from vimoclip_tpu.models.clip_vit import ClipVisionEncoder as JEncoder
from vimoclip_tpu.models.torch_compat import tfam_params_from_torch
from vimoclip_tpu.serving import ViMoCLIPPredictor as JPredictor
from vimoclip_tpu_torch.cli import predict as cli
from vimoclip_tpu_torch.config import TFAMModelConfig
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig
from vimoclip_tpu_torch.models.convert import (
    clip_vision_state_from_jax,
    tfam_state_from_jax,
)
from vimoclip_tpu_torch.ops.kernels.flash_attention import flash_attention
from vimoclip_tpu_torch.serving import ViMoCLIPPredictor

torch.set_num_threads(1)

VGEOM = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=1,
             num_heads=2, intermediate_size=64, projection_dim=16)
TGEOM = dict(d_model=16, nhead=2, num_layers=1, dim_feedforward=32,
             dropout=0.0, mlp_dropout=0.0, attention_impl="flash")
C = 7


@pytest.fixture(scope="module")
def weights():
    enc = JEncoder(JVision(**VGEOM))
    tp = enc.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    sp = enc.init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)))["params"]
    fp = JTFAM(config=JTFAMConfig(**TGEOM), num_classes=C).init(
        jax.random.key(2), jnp.zeros((1, 4, 16)), jnp.zeros((1, 3, 16)),
        jnp.ones((1, 4), bool), jnp.ones((1, 3), bool))["params"]
    return tp, sp, fp


def _jax_predictor(weights, **kw):
    tp, sp, fp = weights
    return JPredictor(
        teacher_params=tp, teacher_config=JVision(**VGEOM), student_params=sp,
        student_config=JVision(**VGEOM), tfam_params=fp,
        tfam_config=JTFAMConfig(**TGEOM), num_classes=C, frame_batch=8,
        length_bucket=8, half_precision=False, **kw)


def _port_predictor(weights, **kw):
    tp, sp, fp = weights
    cfg = ClipVisionConfig(**VGEOM)
    return ViMoCLIPPredictor(
        teacher_state=clip_vision_state_from_jax(tp, cfg, prefix=""),
        teacher_config=cfg,
        student_state=clip_vision_state_from_jax(sp, cfg, prefix=""),
        student_config=cfg, tfam_state=tfam_state_from_jax(fp, 1),
        tfam_config=TFAMModelConfig(**TGEOM), num_classes=C, frame_batch=8,
        length_bucket=8, half_precision=False, device="cpu", **kw)


def _videos():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (t, 36, 48, 3), dtype=np.uint8) for t in (13, 20, 9)]


@pytest.mark.parametrize("batch_invariant", [True, False])
def test_predict_videos_matches_jax(weights, batch_invariant):
    videos = _videos()
    ref = _jax_predictor(weights, batch_invariant=batch_invariant).predict_videos(videos)
    port = _port_predictor(weights, batch_invariant=batch_invariant)
    before = dict(flash_attention.launches)
    got = port.predict_videos(videos, top_k=3)
    assert flash_attention.launches == before  # CPU: the plain version
    for g, r in zip(got, ref):
        assert g.video_id == r.video_id
        np.testing.assert_allclose(g.probabilities, r.probabilities, atol=1e-4, rtol=0)
        assert len(g.top_classes) == 3


def test_embed_video_matches_jax_across_windows(weights):
    frames = _videos()[1]  # 20 frames through 8-frame windows
    rgb_r, mot_r = _jax_predictor(weights).embed_video(frames)
    rgb, mot = _port_predictor(weights).embed_video(frames)
    assert rgb.shape == (20, 16) and mot.shape == (19, 16)
    np.testing.assert_allclose(rgb, rgb_r, atol=1e-4, rtol=0)
    np.testing.assert_allclose(mot, mot_r, atol=1e-4, rtol=0)
    # a tensor input takes the same path
    rgb_t, mot_t = _port_predictor(weights).embed_video(torch.from_numpy(frames))
    np.testing.assert_array_equal(rgb_t, rgb)
    np.testing.assert_array_equal(mot_t, mot)


def test_predict_embeddings_matches_jax(weights):
    rng = np.random.default_rng(5)
    rgb = rng.standard_normal((11, 16)).astype(np.float32)
    mot = rng.standard_normal((10, 16)).astype(np.float32)
    ref = _jax_predictor(weights).predict_embeddings(rgb, mot, "v")
    got = _port_predictor(weights).predict_embeddings(rgb, mot, "v")
    np.testing.assert_allclose(got.probabilities, ref.probabilities, atol=1e-4, rtol=0)


def test_predict_with_motion_video_matches_jax(weights, tmp_path):
    rng = np.random.default_rng(7)
    rgb_path, mot_path = str(tmp_path / "rgb.mp4"), str(tmp_path / "mot.mp4")
    write_video(rgb_path, rng.integers(0, 256, (11, 36, 48, 3), dtype=np.uint8))
    write_video(mot_path, rng.integers(0, 256, (10, 36, 48, 3), dtype=np.uint8))
    ref = _jax_predictor(weights).predict(rgb_path, motion_video_path=mot_path)
    got = _port_predictor(weights).predict(rgb_path, motion_video_path=mot_path)
    np.testing.assert_allclose(got.probabilities, ref.probabilities, atol=1e-4, rtol=0)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ViMoCLIPPredictor({}, ClipVisionConfig(**VGEOM), {},
                          ClipVisionConfig(**VGEOM), {}, device="cuda")


def test_cli_help(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--teacher-weights", "--student-torch-checkpoint",
                 "--tfam-torch-checkpoint", "--tfam-config", "--device"):
        assert flag in out


@pytest.mark.parametrize("flag", [
    ["--tfam-checkpoint-dir", "x"], ["--student-checkpoint-dir", "x"],
    ["--quantize", "int8"], ["--token-merge", "4"], ["--verify-fidelity", "2"],
    ["--data-parallel", "2"],
])
def test_cli_refuses_later_slices(flag, capsys):
    base = ["v.mp4", "--teacher-weights", "t", "--tfam-config", "c",
            "--student-torch-checkpoint", "s", "--tfam-torch-checkpoint", "f"]
    with pytest.raises(SystemExit) as e:
        cli.main(base + flag)
    assert e.value.code == 2
    assert ("vimo-convert" in capsys.readouterr().err) == ("dir" in flag[0])


def test_cli_tiny_run_matches_jax(weights, tmp_path):
    tp, sp, fp = weights
    cfg = ClipVisionConfig(**VGEOM)
    teacher = {f"visual.{k}": torch.from_numpy(np.array(v))
               for k, v in clip_vision_state_from_jax(tp, cfg, prefix="").items()}
    student = {f"module.visual_encoder.{k}": torch.from_numpy(np.array(v))
               for k, v in clip_vision_state_from_jax(sp, cfg, prefix="").items()}
    tfam = {f"module.{k}": torch.from_numpy(np.array(v))
            for k, v in tfam_state_from_jax(fp, 1).items()}
    paths = {n: str(tmp_path / f"{n}.pth") for n in ("teacher", "student", "tfam")}
    torch.save(teacher, paths["teacher"])
    torch.save(student, paths["student"])
    torch.save({"state_dict": tfam}, paths["tfam"])
    classes = tmp_path / "classes.csv"
    classes.write_text("id,name\n0,eat\n1,swim\n")
    config = tmp_path / "cfg.yaml"
    config.write_text(yaml.safe_dump({
        "training": {"device": "tpu"},
        "data": {"num_classes": C, "length_bucket": 8, "max_seq_len": 64,
                 "class_names_dir": str(classes)},
        "model": TGEOM,
    }))
    video = str(tmp_path / "clip.mp4")
    write_video(video, np.random.default_rng(0).integers(0, 256, (13, 36, 48, 3),
                                                         dtype=np.uint8))
    out = tmp_path / "pred.json"
    cli.main([video, "--teacher-weights", paths["teacher"],
              "--student-torch-checkpoint", paths["student"],
              "--tfam-torch-checkpoint", paths["tfam"], "--tfam-config", str(config),
              "--device", "cpu", "--float32", "--frame-batch", "8",
              "--top-k", str(C), "--output", str(out)])
    record = json.loads(out.read_text())[0]
    assert record["video"] == video
    got = {p["class_id"]: p["probability"] for p in record["predictions"]}
    names = {p["class_id"]: p["class_name"] for p in record["predictions"]}
    assert names[0] == "eat" and names[1] == "swim"

    # checkpoints carry no head count: the loaders infer max(1, hidden // 64)
    jvision = JVision(**(VGEOM | {"num_heads": 1}))
    jpred = JPredictor(
        teacher_params=clip_vision_params_from_openai(
            {k: v.numpy() for k, v in teacher.items()}, jvision),
        teacher_config=jvision,
        student_params=clip_vision_params_from_openai(
            {k.replace("module.visual_encoder.", "visual."): v.numpy()
             for k, v in student.items()}, jvision),
        student_config=jvision,
        tfam_params=tfam_params_from_torch(
            {k: v.numpy() for k, v in tfam.items()}, num_layers=1, d_model=16),
        tfam_config=JTFAMConfig(**TGEOM), num_classes=C, frame_batch=8,
        length_bucket=8, max_seq_len=64, half_precision=False)
    ref = jpred.predict(video)
    for c in range(C):  # JSON rounds to 4 decimals
        assert abs(got[c] - float(ref.probabilities[c])) <= 1e-4
