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
from vimoclip_tpu_torch.data.video_reader import read_video
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


def _two_resolutions():
    """Clips of 3, 8, 13 and 20 frames at 36x48 and of 5 and 11 at 40x32,
    interleaved: through 8-frame windows the first group's edges fall inside
    windows (3, 11) and on one (24); the second's at 5."""
    rng = np.random.default_rng(3)
    shape = {3: (36, 48), 5: (40, 32), 8: (36, 48), 13: (36, 48), 11: (40, 32),
             20: (36, 48)}
    return [rng.integers(0, 256, (t, *shape[t], 3), dtype=np.uint8)
            for t in (3, 5, 8, 13, 11, 20)]


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_pooled_windows_equal_the_joined_stack(weights, kind):
    """Each resolution group is read in place: its embeddings are bit for bit
    those of the group joined along time, only the windows across a clip
    edge are gathered (the first group's [0, 8) and [8, 16), the second's
    [0, 8)), and each clip's result is its own within the CPU's round-off."""
    videos = _two_resolutions()
    port = _port_predictor(weights)
    given = videos if kind == "numpy" else [torch.from_numpy(v) for v in videos]
    pooled = port._embed_videos_pooled(given)
    # the student runs each group's differences, the one across a clip edge
    # included: 44 - 1 and 16 - 1
    assert port.stats() == {"windows": 6 + 2, "gathered_windows": 3, "gathered_frames": 24,
                            "teacher_frames": 60, "student_frames": 43 + 15}
    for group in ([0, 2, 3, 5], [1, 4]):
        rgb_all, mot_all = port.embed_video(np.concatenate([videos[i] for i in group]))
        ofs = 0
        for i in group:
            n = len(videos[i])
            np.testing.assert_array_equal(pooled[i][0], rgb_all[ofs : ofs + n])
            np.testing.assert_array_equal(pooled[i][1], mot_all[ofs : ofs + n - 1])
            ofs += n
    preds = port.predict_videos(given)
    for v, (rgb, mot), pred in zip(videos, pooled, preds):
        own_rgb, own_mot = port.embed_video(v)
        np.testing.assert_allclose(rgb, own_rgb, atol=1e-4, rtol=0)
        np.testing.assert_allclose(mot, own_mot, atol=1e-4, rtol=0)
        own = port.predict_embeddings(own_rgb, own_mot)
        np.testing.assert_allclose(pred.probabilities, own.probabilities, atol=1e-4, rtol=0)


def test_one_clip_request_uploads_views_of_the_clip(weights, monkeypatch):
    """A one-clip request copies none of its frames on the host before the
    upload: every window handed to ``upload`` is a view of the caller's clip."""
    import vimoclip_tpu_torch.serving as serving

    clip = _videos()[1]  # 20 frames: windows of 8, 8 and 4
    handed = []
    real_upload = serving.upload

    def spy(window, device):
        assert np.shares_memory(window, clip)
        handed.append(len(window))
        return real_upload(window, device)

    monkeypatch.setattr(serving, "upload", spy)
    port = _port_predictor(weights)
    (pred,) = port.predict_videos([clip])
    assert handed == [8, 8, 4]
    assert port.stats() == {"windows": 3, "gathered_windows": 0, "gathered_frames": 0,
                            "teacher_frames": 20, "student_frames": 19}
    monkeypatch.undo()
    want = port.predict_embeddings(*port.embed_video(clip.copy()))
    np.testing.assert_array_equal(pred.probabilities, want.probabilities)


def test_predict_is_the_one_clip_form_of_predict_videos(weights, tmp_path):
    """``predict(path)`` is ``predict_videos`` on the file's frames: the same
    probabilities bit for bit, and the same windows and frames counted."""
    path = str(tmp_path / "clip.mp4")
    write_video(path, _videos()[1])  # 20 frames: windows of 8, 8 and 4
    by_file, by_frames = _port_predictor(weights), _port_predictor(weights)
    got = by_file.predict(path, top_k=3)
    (want,) = by_frames.predict_videos([read_video(path)], [path], top_k=3)
    assert got.video_id == want.video_id == path
    assert got.top_classes == want.top_classes
    np.testing.assert_array_equal(got.probabilities, want.probabilities)
    assert by_file.stats() == by_frames.stats() == {
        "windows": 3, "gathered_windows": 0, "gathered_frames": 0,
        "teacher_frames": 20, "student_frames": 19}


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
    ["--data-parallel", "2"],
])
def test_cli_refuses_later_slices(flag, capsys, weights, tmp_path):
    """Orbax directories stay refused. ``--data-parallel 2`` runs since
    slice 7a: two CPU replicas of each tower answer as one does, and a frame
    batch that does not split over the replicas is refused."""
    if flag[0] == "--data-parallel":
        paths, config, video, _, _ = _reference_files(weights, tmp_path)
        one = _cli_probabilities(paths, config, video, tmp_path)
        assert _cli_probabilities(paths, config, video, tmp_path, flag) == one
        with pytest.raises(ValueError, match="frame_batch 8 not divisible by data axis 3"):
            _cli_probabilities(paths, config, video, tmp_path, ["--data-parallel", "3"])
        return
    base = ["v.mp4", "--teacher-weights", "t", "--tfam-config", "c",
            "--student-torch-checkpoint", "s", "--tfam-torch-checkpoint", "f"]
    with pytest.raises(SystemExit) as e:
        cli.main(base + flag)
    assert e.value.code == 2
    assert ("vimo-convert" in capsys.readouterr().err) == ("dir" in flag[0])


def _reference_files(weights, tmp_path, geom=VGEOM):
    """The three stages' weights as reference-format ``.pth`` files, a
    stage-2 YAML and a 13-frame clip; returns the paths, the YAML, the clip
    and the JAX predictor's parameters read back from the files."""
    tp, sp, fp = weights
    cfg = ClipVisionConfig(**geom)
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
    # checkpoints carry no head count: the loaders infer max(1, hidden // 64)
    jvision = JVision(**(geom | {"num_heads": 1}))
    jparams = dict(
        teacher_params=clip_vision_params_from_openai(
            {k: v.numpy() for k, v in teacher.items()}, jvision),
        student_params=clip_vision_params_from_openai(
            {k.replace("module.visual_encoder.", "visual."): v.numpy()
             for k, v in student.items()}, jvision),
        tfam_params=tfam_params_from_torch(
            {k: v.numpy() for k, v in tfam.items()}, num_layers=1, d_model=16))
    return paths, str(config), video, jvision, jparams


def _cli_probabilities(paths, config, video, tmp_path, extra=()):
    out = tmp_path / "pred.json"
    cli.main([video, "--teacher-weights", paths["teacher"],
              "--student-torch-checkpoint", paths["student"],
              "--tfam-torch-checkpoint", paths["tfam"], "--tfam-config", config,
              "--device", "cpu", "--float32", "--frame-batch", "8",
              "--top-k", str(C), "--output", str(out), *extra])
    record = json.loads(out.read_text())[0]
    assert record["video"] == video
    names = {p["class_id"]: p["class_name"] for p in record["predictions"]}
    assert names[0] == "eat" and names[1] == "swim"
    return {p["class_id"]: p["probability"] for p in record["predictions"]}


def _capture_predictors(monkeypatch):
    """The predictors ``cli.predict.build_predictor`` builds from here on
    (``cli.predict.main`` and ``cli.serve.main`` both call it)."""
    built = []
    build = cli.build_predictor

    def capture(*args, **kwargs):
        built.append(build(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(cli, "build_predictor", capture)
    return built


def _jax_probabilities(jvision, jparams, video, teacher=None, student=None):
    return JPredictor(
        teacher_config=teacher or jvision, student_config=student or jvision,
        tfam_config=JTFAMConfig(**TGEOM), num_classes=C, frame_batch=8,
        length_bucket=8, max_seq_len=64, half_precision=False,
        **jparams).predict(video).probabilities


def test_cli_tiny_run_matches_jax(weights, tmp_path):
    paths, config, video, jvision, jparams = _reference_files(weights, tmp_path)
    got = _cli_probabilities(paths, config, video, tmp_path)
    ref = _jax_probabilities(jvision, jparams, video)
    for c in range(C):  # JSON rounds to 4 decimals
        assert abs(got[c] - float(ref[c])) <= 1e-4


@pytest.fixture(scope="module")
def deep_weights():
    """Towers of 2 layers: 17 tokens, 4 merged after the first block under
    --token-merge 4."""
    enc = JEncoder(JVision(**(VGEOM | {"num_layers": 2})))
    init = jax.jit(enc.init)
    tp = init(jax.random.key(3), jnp.zeros((1, 32, 32, 3)))["params"]
    sp = init(jax.random.key(4), jnp.zeros((1, 32, 32, 3)))["params"]
    fp = JTFAM(config=JTFAMConfig(**TGEOM), num_classes=C).init(
        jax.random.key(5), jnp.zeros((1, 4, 16)), jnp.zeros((1, 3, 16)),
        jnp.ones((1, 4), bool), jnp.ones((1, 3), bool))["params"]
    return tp, sp, fp


@pytest.mark.parametrize("flag", [["--quantize", "int8"], ["--token-merge", "4"],
                                  ["--quantize", "int8", "--verify-fidelity", "3"]],
                         ids=["quantize", "token-merge", "verify-fidelity"])
def test_cli_accelerator_flags_match_jax(deep_weights, tmp_path, monkeypatch, flag):
    """Each opt-in flag of ``cli.predict`` against the JAX predictor with the
    configs JAX's ``build_predictor`` makes from it: int8 in both towers,
    ToMe in the teacher only. The predictor the CLI built answers within
    1e-6 of JAX's, a hundredth of what the flag itself moves the answer
    (JAX with the flag against JAX without it), so a flag that did nothing
    or reached one tower only would fail; the JSON is that answer rounded to
    4 decimals. Under --verify-fidelity the run stops with FidelityError at
    threshold 1.0, as JAX's probe does on the same frames."""
    import dataclasses

    from vimoclip_tpu.fidelity import FidelityError as JFidelityError
    from vimoclip_tpu.fidelity import check_encoder_fidelity as jax_check
    from vimoclip_tpu_torch.fidelity import FidelityError

    geom = VGEOM | {"num_layers": 2}
    paths, config, video, jvision, jparams = _reference_files(deep_weights, tmp_path, geom)
    built = _capture_predictors(monkeypatch)
    got = _cli_probabilities(paths, config, video, tmp_path, flag)
    quant = "int8" if "--quantize" in flag else None
    merge = 4 if "--token-merge" in flag else 0
    (pred,) = built
    assert (pred.teacher.config.matmul_quant, pred.teacher.config.token_merge_r) == (quant, merge)
    assert (pred.student.config.matmul_quant, pred.student.config.token_merge_r) == (quant, 0)
    teacher = dataclasses.replace(jvision, matmul_quant=quant, token_merge_r=merge)
    student = dataclasses.replace(jvision, matmul_quant=quant)
    ref = _jax_probabilities(jvision, jparams, video, teacher, student)
    exact = _jax_probabilities(jvision, jparams, video)
    full = pred.predict(video).probabilities
    assert np.abs(ref - exact).max() >= 100 * 1e-6  # the flag's effect
    np.testing.assert_allclose(full, ref, atol=1e-6, rtol=0)
    for c in range(C):
        assert abs(got[c] - float(full[c])) <= 5e-5 + 1e-7  # JSON rounds to 4 decimals
    if "--verify-fidelity" in flag:
        with pytest.raises(FidelityError):
            _cli_probabilities(paths, config, video, tmp_path,
                               flag + ["--fidelity-threshold", "1.0"])
        # JAX's probe refuses the same teacher on the same frames
        with pytest.raises(JFidelityError):
            jax_check(jparams["teacher_params"], teacher, video, 3, 1.0,
                      half_precision=False)
