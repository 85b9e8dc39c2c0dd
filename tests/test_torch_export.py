"""The port's motion-embedding exporter and video reader against the JAX
package's on the CPU: the same HDF5 from the same videos and weights,
resume, crash-truncated retry, reference-written groups, stem collisions,
the memory guard, and the ``export_motion_embeddings`` CLI."""

import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimoclip_tpu.data import video_reader as jvr
from vimoclip_tpu.export import MotionEmbeddingExporter as JExporter
from vimoclip_tpu.models.clip_vit import ClipVisionConfig as JConfig
from vimoclip_tpu.models.student import StudentModel as JStudent
from vimoclip_tpu_torch.cli import export_motion_embeddings
from vimoclip_tpu_torch.data import video_reader as tvr
from vimoclip_tpu_torch.export import (
    LowMemoryError,
    MotionEmbeddingExporter,
    find_motion_videos,
    memory_guard,
)
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig
from vimoclip_tpu_torch.models.convert import student_state_from_jax, to_tensors

from test_torch_extraction import assert_int8_frames

torch.set_num_threads(1)

GEOM = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=1,
            num_heads=2, intermediate_size=64, projection_dim=16)
CFG = ClipVisionConfig(**GEOM)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("motion_videos")
    rng = np.random.default_rng(0)
    (root / "nested").mkdir()
    for name, t, hw in [("x.mp4", 7, (36, 64)), ("y.mp4", 12, (36, 64)),
                        ("nested/z.mp4", 5, (32, 32))]:
        jvr.write_video(str(root / name), rng.integers(0, 256, (t, *hw, 3), dtype=np.uint8))
    return str(root)


@pytest.fixture(scope="module")
def params():
    model = JStudent(vision_config=JConfig(**GEOM), num_classes=3)
    return jax.tree.map(np.asarray, model.init(
        jax.random.key(0), jnp.zeros((1, 2, 32, 32, 3), jnp.uint8))["params"])


def _ours(params, **kw):
    return MotionEmbeddingExporter(student_state_from_jax(params, CFG), CFG,
                                   half_precision=False, device="cpu", **kw)


def _read(path):
    with h5py.File(path, "r") as f:
        return {k: (dict(g.attrs), g["embeddings"][:] if "embeddings" in g else None,
                    g["embeddings"].compression if "embeddings" in g else None)
                for k, g in f.items()}


@pytest.mark.parametrize("resize, compression", [(None, "lzf"), ((32, 32), "gzip")],
                         ids=["resize-on-device", "resize-32x32"])
def test_export_matches_jax_exporter(videos, params, tmp_path, resize, compression):
    paths = find_motion_videos(videos)
    outs = {}
    for name, exp in (("ours", _ours(params, chunk_size=5, compression=compression)),
                      ("jax", JExporter(params, JConfig(**GEOM), chunk_size=5,
                                        half_precision=False, compression=compression))):
        outs[name] = str(tmp_path / f"{name}.h5")
        counts = exp.export(paths, outs[name], resize_to=resize)
        assert counts == {"processed": 3, "skipped": 0, "errors": 0}
    ours, theirs = _read(outs["ours"]), _read(outs["jax"])
    assert sorted(ours) == sorted(theirs) == ["x", "y", "z"]
    for vid in theirs:
        assert ours[vid][0] == theirs[vid][0]  # complete, total_frames
        assert ours[vid][2] == theirs[vid][2] == compression
        np.testing.assert_allclose(ours[vid][1], theirs[vid][1], atol=1e-4, rtol=0)


def test_export_resume_and_errors(videos, params, tmp_path):
    out = str(tmp_path / "motion.h5")
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"garbage")
    exp = _ours(params, chunk_size=5)
    counts = exp.export(find_motion_videos(videos) + [str(bad)], out)
    assert counts == {"processed": 3, "skipped": 0, "errors": 1}
    with h5py.File(out, "r") as f:
        assert "error" in f["bad"].attrs and not f["bad"].attrs["complete"]
    # resume: the good videos are skipped, the bad one retried (and failing)
    counts = exp.export(find_motion_videos(videos) + [str(bad)], out)
    assert counts == {"processed": 0, "skipped": 3, "errors": 1}
    assert exp.export(find_motion_videos(videos), out, overwrite=True)["processed"] == 3


def test_export_retries_crash_truncated_and_trusts_reference_groups(videos, params, tmp_path):
    """A group with embeddings and no attrs (a crash between a chunk and the
    finish) is retried; a reference-written group (total_frames, no
    'complete') is kept."""
    paths = find_motion_videos(videos)
    out = str(tmp_path / "crash.h5")
    with h5py.File(out, "w") as f:
        f.create_group("x").create_dataset("embeddings", data=np.zeros((2, 16), np.float32),
                                           maxshape=(None, 16))
        g = f.create_group("y")
        g.create_dataset("embeddings", data=np.zeros((7, 16), np.float32))
        g.attrs["total_frames"] = 7
    counts = _ours(params, chunk_size=4).export(paths, out)
    assert counts == {"processed": 2, "skipped": 1, "errors": 0}
    with h5py.File(out, "r") as f:
        assert f["x"].attrs["complete"] and f["x"]["embeddings"].shape == (7, 16)
        np.testing.assert_array_equal(f["y"]["embeddings"][:], 0.0)


def test_export_rejects_colliding_stems(params, tmp_path):
    rng = np.random.default_rng(4)
    paths = []
    for sub in ("a", "b"):
        (tmp_path / sub).mkdir()
        paths.append(str(tmp_path / sub / "clip001.mp4"))
        tvr.write_video(paths[-1], rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8))
    exp = _ours(params, chunk_size=4)
    with pytest.raises(ValueError, match="duplicate video id"):
        exp.export(paths, str(tmp_path / "out.h5"))
    out = exp.export([paths[0], paths[0]], str(tmp_path / "out2.h5"))  # not a collision
    assert out == {"processed": 1, "skipped": 1, "errors": 0}


def test_memory_guard_records_low_ram(videos, params, tmp_path):
    memory_guard(0.0)
    with pytest.raises(LowMemoryError):
        memory_guard(float("inf"))
    exp = _ours(params, chunk_size=4, min_free_gb=float("inf"))
    out = str(tmp_path / "low.h5")
    assert exp.export(find_motion_videos(videos), out)["errors"] == 3
    with h5py.File(out, "r") as f:
        assert "skipped_low_ram" in f["x"].attrs and not f["x"].attrs["complete"]


def test_embed_chunk_pads_the_tail_to_one_shape(params):
    exp = _ours(params, chunk_size=8)
    frames = np.random.default_rng(1).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    full = exp._embed_chunk(frames)
    tail = exp._embed_chunk(frames[:3])
    assert full.shape == (8, 16) and tail.shape == (3, 16) and tail.dtype == np.float32
    np.testing.assert_array_equal(tail, full[:3])


def test_video_reader_matches_jax(videos, tmp_path):
    path = os.path.join(videos, "y.mp4")
    assert tvr.video_frame_count(path) == jvr.video_frame_count(path) == 12
    np.testing.assert_array_equal(tvr.read_video(path), jvr.read_video(path))
    np.testing.assert_array_equal(tvr.read_video_window(path, 4, 5),
                                  jvr.read_video_window(path, 4, 5))
    np.testing.assert_array_equal(tvr.read_video_window(path, 10, 5),
                                  jvr.read_video_window(path, 10, 5))
    with pytest.raises(IOError):
        tvr.read_video_window(path, 40, 5)
    for chunk in (5, 4, 12, 20):
        ours = list(tvr.iter_video_chunks(path, chunk))
        theirs = list(jvr.iter_video_chunks(path, chunk))
        assert [c.shape for c in ours] == [c.shape for c in theirs]
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    gray = np.random.default_rng(2).integers(0, 256, (3, 32, 32), dtype=np.uint8)
    for name, writer in (("ours", tvr.write_video), ("jax", jvr.write_video)):
        writer(str(tmp_path / f"{name}.mp4"), gray)
    np.testing.assert_array_equal(tvr.read_video(str(tmp_path / "ours.mp4")),
                                  jvr.read_video(str(tmp_path / "jax.mp4")))


def test_cli_exports_from_a_torch_checkpoint_and_a_run_directory(videos, params, tmp_path):
    state = to_tensors(student_state_from_jax(params, CFG))
    torch.save({f"module.{k}": v for k, v in state.items()}, tmp_path / "student_best.pth")
    (tmp_path / "run" / "best").mkdir(parents=True)
    torch.save(state, tmp_path / "run" / "best" / "best_model.pth")
    common = ["--videos-dir", videos, "--chunk-size", "4", "--float32", "--device", "cpu"]
    export_motion_embeddings.main(common + ["--torch-checkpoint",
                                            str(tmp_path / "student_best.pth"),
                                            "--output", str(tmp_path / "a.h5")])
    export_motion_embeddings.main(common + ["--checkpoint-dir", str(tmp_path / "run"),
                                            "--output", str(tmp_path / "b.h5"),
                                            "--compression", "none"])
    a, b = _read(str(tmp_path / "a.h5")), _read(str(tmp_path / "b.h5"))
    assert sorted(a) == sorted(b) == ["x", "y", "z"]
    for vid in a:
        assert a[vid][2] == "lzf" and b[vid][2] is None
        np.testing.assert_array_equal(a[vid][1], b[vid][1])
    (tmp_path / "orbax").mkdir()
    with pytest.raises(SystemExit):
        export_motion_embeddings.main(common + ["--output", "x.h5",
                                                "--checkpoint-dir", str(tmp_path / "orbax")])


@pytest.fixture(scope="module")
def deep_student(tmp_path_factory):
    """A reference-format ``student_best.pth`` of 2 layers at hidden 64 (the
    JAX loader infers hidden // 64 heads, so narrower towers are not shared):
    17 tokens, 4 merged after the first block under --token-merge 4."""
    geom = GEOM | dict(hidden_size=64, num_layers=2, num_heads=1, intermediate_size=128)
    model = JStudent(vision_config=JConfig(**geom), num_classes=3)
    params = jax.jit(model.init)(jax.random.key(1),
                                 jnp.zeros((1, 2, 32, 32, 3), jnp.uint8))["params"]
    path = tmp_path_factory.mktemp("deep_student") / "student_best.pth"
    torch.save(to_tensors(student_state_from_jax(params, ClipVisionConfig(**geom))), path)
    return str(path)


@pytest.mark.parametrize("extra", [["--quantize", "int8"], ["--token-merge", "4"],
                                   ["--quantize", "int8", "--verify-fidelity", "3"]],
                         ids=["quantize", "token-merge", "verify-fidelity"])
def test_cli_accelerator_flags_match_jax(videos, deep_student, tmp_path, extra):
    """Each opt-in flag of ``export_motion_embeddings`` against the JAX CLI on
    the same videos and checkpoint. Merged float32 embeddings agree within
    1e-4; int8 ones frame by frame as ``assert_int8_frames`` holds them
    (within a thousandth of int8's own effect, but for at most one frame
    whose quantiser input sat at a rounding boundary). Under
    --verify-fidelity both stop with FidelityError at threshold 1.0 before
    writing anything."""
    from vimoclip_tpu.cli.export_motion_embeddings import main as jax_cli
    from vimoclip_tpu.fidelity import FidelityError as JFidelityError
    from vimoclip_tpu_torch.fidelity import FidelityError

    base = ["--videos-dir", videos, "--chunk-size", "4", "--float32",
            "--torch-checkpoint", deep_student]
    common = base + extra
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "jax.h5")
    export_motion_embeddings.main(common + ["--output", ours, "--device", "cpu"])
    jax_cli(common + ["--output", theirs])
    exact = str(tmp_path / "exact.h5")
    export_motion_embeddings.main(base + ["--output", exact, "--device", "cpu"])
    a, b, e = _read(ours), _read(theirs), _read(exact)
    assert sorted(a) == sorted(b) == ["x", "y", "z"]
    for vid in b:
        assert a[vid][0] == b[vid][0] and a[vid][1].shape == b[vid][1].shape
        if "--quantize" not in extra:
            np.testing.assert_allclose(a[vid][1], b[vid][1], atol=1e-4, rtol=0)
    if "--quantize" in extra:
        assert_int8_frames(*({vid: g[1] for vid, g in f.items()} for f in (a, b, e)))
    assert not np.allclose(a["x"][1], e["x"][1], atol=1e-4)
    if "--verify-fidelity" in extra:
        strict = common + ["--fidelity-threshold", "1.0"]
        with pytest.raises(FidelityError):
            export_motion_embeddings.main(strict + ["--output", str(tmp_path / "o.h5"),
                                                    "--device", "cpu"])
        with pytest.raises(JFidelityError):
            jax_cli(strict + ["--output", str(tmp_path / "j.h5")])
        assert not (tmp_path / "o.h5").exists() and not (tmp_path / "j.h5").exists()
