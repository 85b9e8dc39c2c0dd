"""The port's stage-1 trainer against the JAX package's on the CPU: one
train step (with and without the global-norm clip, BCE and CE) from the
same weights, gradient accumulation, mid-epoch resume, preemption, the
construction checks, the segment dataset on the same fixture files, and the
``train_student`` CLI end to end."""

import json
import os
import signal
import shutil

import jax
import numpy as np
import pytest
import torch

from vimoclip_tpu.data import EmbeddingWriter
from vimoclip_tpu.data.segment_dataset import SegmentDataset as JSegmentDataset
from vimoclip_tpu.data.segment_dataset import collate_segments as jax_collate
from vimoclip_tpu.data.video_reader import write_video
from vimoclip_tpu.models.clip_vit import ClipVisionConfig as JConfig
from vimoclip_tpu.parallel import MeshConfig, create_mesh
from vimoclip_tpu.train.student_trainer import StudentTrainer as JStudentTrainer
from vimoclip_tpu_torch.cli import train_student
from vimoclip_tpu_torch.data.segment_dataset import (
    SegmentDataset,
    build_segment_index,
    collate_segments,
)
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig
from vimoclip_tpu_torch.models.convert import student_state_from_jax, to_tensors
from vimoclip_tpu_torch.models.student import StudentModel
from vimoclip_tpu_torch.train.student_trainer import StudentTrainer

torch.set_num_threads(1)

GEOM = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=1,
            num_heads=2, intermediate_size=64, projection_dim=16)
CFG = ClipVisionConfig(**GEOM)
C, P = 5, GEOM["projection_dim"]


def _items(n, seed=0, t=6, hw=(32, 32)):
    """Synthetic segments: teacher (t, P), t - 1 uint8 motion frames."""
    rng = np.random.default_rng(seed)
    return [{"video_id": f"s{i:02d}",
             "rgb_emb": rng.standard_normal((t, P)).astype(np.float32),
             "motion_frames": rng.integers(0, 256, (t - 1, *hw, 3), dtype=np.uint8),
             "labels": np.eye(C, dtype=np.float32)[rng.integers(C)]} for i in range(n)]


def _trainer(tmp_path, train, val=None, name="ck", **kw):
    args = dict(checkpoint_dir=str(tmp_path / name), vision_config=CFG, num_classes=C,
                lr=3e-3, batch_size=4, num_workers=1, epochs=2, half_precision=False,
                device="cpu", seed=49)
    return StudentTrainer(train, train if val is None else val, **(args | kw))


@pytest.fixture
def corpus(tmp_path):
    """Teacher HDF5 and motion videos in the AK (flat) and MN (nested
    ``trimmed_videos/``, 36x48 frames resized to 32x32) layouts."""
    rng = np.random.default_rng(0)
    out = {}
    for layout, nested in (("ak", None), ("mn", "trimmed_videos")):
        vdir = tmp_path / f"motion_{layout}"
        vdir.mkdir()
        h5 = str(tmp_path / f"teacher_{layout}.h5")
        with EmbeddingWriter(h5, num_classes=C, embed_dim=P, nested_prefix=nested) as w:
            for i in range(4):
                t = int(rng.integers(8, 14))
                hw = (32, 32) if layout == "ak" else (36, 48)
                write_video(str(vdir / f"v{i}.mp4"),
                            rng.integers(0, 256, (t - 1, *hw, 3), dtype=np.uint8))
                w.write_video(f"v{i}.mp4", rng.normal(size=(t, P)).astype(np.float32),
                              labels=np.eye(C, dtype=np.float32)[rng.integers(C)])
        out[layout] = (h5, str(vdir), nested)
    return out


@pytest.mark.parametrize("class_loss, grad_clip", [("bce", None), ("bce", 0.05),
                                                   ("ce", None)],
                         ids=["bce", "bce-clip", "ce"])
def test_train_step_matches_jax(tmp_path, class_loss, grad_clip):
    """One float32 step from identical weights on one batch: losses and the
    updated parameters against JAX's jitted ``_train_step``, within 1e-5
    relative. Left out of the parameter comparison: the key-projection
    biases, whose gradient is zero in exact arithmetic (each package's
    rounding noise there becomes a different +-lr Adam step)."""
    items = _items(8)
    jt = JStudentTrainer(items, items, checkpoint_dir=str(tmp_path / "jax"),
                         vision_config=JConfig(**GEOM), num_classes=C, lr=1e-3,
                         batch_size=4, num_workers=1, epochs=1, half_precision=False,
                         class_loss=class_loss, grad_clip=grad_clip,
                         mesh=create_mesh(MeshConfig(1, 1)))
    params = jax.tree.map(np.asarray, jt.state.params)
    ours = _trainer(tmp_path, items, lr=1e-3, class_loss=class_loss, grad_clip=grad_clip)
    ours.model.load_state_dict(to_tensors(student_state_from_jax(params, CFG)), strict=True)

    batch = {k: v for k, v in collate_segments(items[:4]).items() if k != "video_id"}
    state, total, d_loss, c_loss, logits = jt._train_step(jt.state, batch)
    vals, got_logits = ours.train_step(batch)
    np.testing.assert_allclose(vals.numpy(), [float(total), float(d_loss), float(c_loss)],
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits), atol=1e-5, rtol=0)
    if grad_clip is not None:  # the clip acted: the gradients' norm is now grad_clip
        norm = torch.sqrt(sum((p.grad ** 2).sum() for p in ours.model.parameters()))
        assert norm.item() == pytest.approx(grad_clip, rel=1e-5)
    want = student_state_from_jax(jax.tree.map(np.asarray, state.params), CFG)
    got = ours.model.state_dict()
    h = GEOM["hidden_size"]
    for key, value in want.items():
        a = got[key].numpy()
        if key.endswith("in_proj_bias"):
            keep = np.r_[0:h, 2 * h:3 * h]
            a, value = a[keep], value[keep]
        scale = max(np.abs(value).max(), 1e-3)
        assert np.abs(a - value).max() <= 1e-5 * scale, key


def test_grad_accum_equals_full_batch(tmp_path):
    """Two equal microbatches, gradients summed then averaged, one Adam
    step: the update of one step on the whole batch, up to float32 sums in
    another order."""
    items = _items(8)
    a = _trainer(tmp_path, items, name="a")
    b = _trainer(tmp_path, items, name="b", grad_accum=2)
    b.model.load_state_dict(a.model.state_dict())
    batch = collate_segments(items[:4])
    va, la = a.train_step(batch)
    vb, lb = b.train_step(batch)
    torch.testing.assert_close(va, vb, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(la, lb, atol=1e-6, rtol=0)
    for (key, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=0, msg=key)
    with pytest.raises(ValueError, match="grad_accum"):
        _trainer(tmp_path, items, name="c", grad_accum=3)


def test_mid_epoch_resume_is_bit_identical(tmp_path):
    """A run resumed from a mid-epoch checkpoint redraws the same batches
    and ends bit for bit where the uninterrupted run ends."""
    items = _items(12)
    full = _trainer(tmp_path, items, name="a", checkpoint_every_steps=1)
    best_full = full.train()
    assert full.state.step == 6
    # what an interrupted run leaves: step_4 = epoch 1, batch 1
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    for name in ("step_5", "step_6"):
        shutil.rmtree(tmp_path / "b" / name)
    with open(tmp_path / "b" / "step_4" / "extra.json") as f:
        assert json.load(f)["batch_in_epoch"] == 1
    resumed = _trainer(tmp_path, items, name="b", checkpoint_every_steps=1, resume=True)
    assert resumed.train() == best_full
    assert resumed.state.step == 6
    for (key, x), y in zip(full.model.state_dict().items(),
                           resumed.model.state_dict().values()):
        assert torch.equal(x, y), key


def test_noop_resume_returns_the_restored_best(tmp_path):
    items = _items(8)
    best = _trainer(tmp_path, items, epochs=1).train()
    assert np.isfinite(best)
    again = _trainer(tmp_path, items, epochs=1, resume=True).train()  # no epoch left
    assert again == pytest.approx(best, rel=1e-6)
    # best/best_model.pth is a reference-layout student, loaded strictly
    ref = torch.load(tmp_path / "ck" / "best" / "best_model.pth", weights_only=True)
    StudentModel(CFG, num_classes=C).load_state_dict(ref, strict=True)


def test_empty_val_loader_rejected(tmp_path):
    items = _items(8)
    with pytest.raises(ValueError, match="batch_size"):
        _trainer(tmp_path, items, val=items[:3])
    trainer = _trainer(tmp_path, items)
    trainer.val_loader = []  # the evaluate() backstop
    with pytest.raises(ValueError, match="0 batches"):
        trainer.evaluate()


def test_preemption_cuts_a_resume_checkpoint(tmp_path, monkeypatch):
    trainer = _trainer(tmp_path, _items(12))
    step = trainer.train_step

    def step_then_signal(batch):
        out = step(batch)
        if trainer.state.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(trainer, "train_step", step_then_signal)
    trainer.train()
    assert trainer.preempted and trainer.state.step == 2
    with open(tmp_path / "ck" / "step_2" / "extra.json") as f:
        assert json.load(f) == {"epoch": 0, "batch_in_epoch": 2}


def test_trainer_learns_and_needs_a_card_unless_cpu(tmp_path):
    items = _items(8)
    trainer = _trainer(tmp_path, items, epochs=3, async_checkpoint=True)
    before = trainer.evaluate()
    trainer.train()
    after = trainer.evaluate()
    assert after["total"] < before["total"]
    assert sorted(os.listdir(tmp_path / "ck"))[0] == "best"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cpu"):
            _trainer(tmp_path, items, device="cuda")


def test_segment_index_matches_jax():
    from vimoclip_tpu.data.segment_dataset import build_segment_index as jax_index

    lengths = {"a": 0, "b": 5, "c": 30, "d": 61, "e": 1}
    assert build_segment_index(lengths, 30) == jax_index(lengths, 30)


@pytest.mark.parametrize("layout, cache", [("ak", 0), ("ak", 2), ("mn", 0)])
def test_segment_dataset_matches_jax(corpus, layout, cache):
    h5, vdir, nested = corpus[layout]
    spatial = (32, 32) if layout == "mn" else None
    kw = dict(sequence_length=6, nested_prefix=nested, spatial_size=spatial,
              decode_cache_videos=cache)
    ours, theirs = SegmentDataset(h5, vdir, **kw), JSegmentDataset(h5, vdir, **kw)
    assert ours.segments == theirs.segments and len(ours) > 4
    # the last segment of each video is a padded one that reads past the end
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a["video_id"] == b["video_id"]
        for key in ("rgb_emb", "motion_frames", "labels"):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{i} {key}")
    a = collate_segments([ours[0], ours[1]])
    b = jax_collate([theirs[0], theirs[1]])
    assert a["video_id"] == b["video_id"]
    assert a["motion_frames"].shape == (2, 5, 32, 32, 3)


def test_cli_trains_on_the_cpu_and_refuses_multi_gpu(corpus, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    h5, vdir, _ = corpus["ak"]
    clip = tmp_path / "clip.pt"
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionEncoder

    torch.manual_seed(0)
    torch.save({f"visual.{k}": v for k, v in ClipVisionEncoder(CFG).state_dict().items()},
               clip)
    args = ["--train-embeddings", h5, "--val-embeddings", h5, "--motion-videos-dir", vdir,
            "--checkpoint-dir", str(tmp_path / "ck"), "--log-dir", str(tmp_path / "logs"),
            "--clip-weights", str(clip), "--num-classes", str(C), "--sequence-length", "6",
            "--batch-size", "2", "--epochs", "1", "--num-workers", "1", "--float32",
            "--lr", "1e-3", "--device", "cpu"]
    train_student.main(args)
    best = torch.load(tmp_path / "ck" / "best" / "best_model.pth", weights_only=True)
    assert best["visual_encoder.conv1.weight"].shape == (32, 3, 8, 8)
    with pytest.raises(SystemExit):
        train_student.main(args + ["--data-parallel", "2"])
