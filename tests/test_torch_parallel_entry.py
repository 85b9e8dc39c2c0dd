"""Data parallelism at the port's entry points on the CPU: extraction and
``vimo-predict-torch`` with ``--data-parallel 2`` (two CPU replicas of each
tower) against the JAX package's ``--data-parallel 2`` (a two-device mesh
of the virtual CPU devices); the replica split itself; the stage-2 CLI's
refusal of a lone process; and the default paths (no process group,
``--data-parallel 1``) bit for bit equal to the computation they ran before
the parallel slice: no collective, copy or reordering was added to them."""

import copy
import os

import numpy as np
import pytest
import torch
import yaml

from vimoclip_tpu_torch.cli import extract_embeddings
from vimoclip_tpu_torch.cli import tfam_train_eval
from vimoclip_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    LoggingConfig,
    TFAMModelConfig,
    TrainingConfig,
)
from vimoclip_tpu_torch.data.embedding_dataset import collate_pad
from vimoclip_tpu_torch.data.segment_dataset import collate_segments
from vimoclip_tpu_torch import losses
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig
from vimoclip_tpu_torch.ops.preprocess import clip_preprocess
from vimoclip_tpu_torch.parallel import Replicas, replica_devices
from vimoclip_tpu_torch.prng import KeyChain
from vimoclip_tpu_torch.train.state import make_adam, make_adamw
from vimoclip_tpu_torch.train.student_trainer import StudentTrainer
from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer

from test_torch_extraction import CFG, _hf_checkpoint, assert_same_file, corpus  # noqa: F401
from test_torch_extraction import state, params  # noqa: F401
from test_torch_serving import _cli_probabilities, _reference_files, weights  # noqa: F401
from test_torch_serving import VGEOM, TGEOM, C as SERVE_C

torch.set_num_threads(1)


def without_tensorflow(tmp_path, monkeypatch) -> None:
    """Child processes (``torchrun`` ranks) find a ``tensorflow`` that
    refuses to import, so TensorBoard takes its own stub: importing
    TensorFlow costs rank 0 some 16 s on this CPU host."""
    shim = tmp_path / "no_tensorflow" / "tensorflow"
    shim.mkdir(parents=True, exist_ok=True)
    (shim / "__init__.py").write_text("raise ImportError('TensorFlow is left out of "
                                      "these test ranks')\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        filter(None, [str(shim.parent), os.environ.get("PYTHONPATH")])))


def test_extraction_data_parallel_matches_jax(corpus, tmp_path):  # noqa: F811
    from vimoclip_tpu.cli.extract_embeddings import main as jax_cli

    common = ["--data-root", corpus, "--annotation-file", os.path.join(corpus, "train.txt"),
              "--class-file", os.path.join(corpus, "classes.csv"),
              "--clip-weights", _hf_checkpoint(tmp_path), "--batch-size", "8",
              "--split", "train", "--float32", "--data-parallel", "2"]
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "jax.h5")
    extract_embeddings.main(common + ["--output", ours, "--device", "cpu"])
    jax_cli(common + ["--output", theirs])
    assert_same_file(ours, theirs)


def test_predict_data_parallel_matches_jax(weights, tmp_path, mesh8):  # noqa: F811
    """``vimo-predict-torch --data-parallel 2`` against JAX's predictor on a
    two-device mesh (what JAX's ``--data-parallel 2`` builds)."""
    import jax

    from vimoclip_tpu.config import TFAMModelConfig as JTFAMConfig
    from vimoclip_tpu.parallel import MeshConfig as JMeshConfig
    from vimoclip_tpu.parallel import create_mesh
    from vimoclip_tpu.serving import ViMoCLIPPredictor as JPredictor

    paths, config, video, jvision, jparams = _reference_files(weights, tmp_path)
    got = _cli_probabilities(paths, config, video, tmp_path, ["--data-parallel", "2"])
    mesh = create_mesh(JMeshConfig(2, 1), devices=jax.devices()[:2])
    ref = JPredictor(teacher_config=jvision, student_config=jvision,
                     tfam_config=JTFAMConfig(**TGEOM), num_classes=SERVE_C, frame_batch=8,
                     length_bucket=8, max_seq_len=64, half_precision=False, mesh=mesh,
                     **jparams).predict(video).probabilities
    for c in range(SERVE_C):  # JSON rounds to 4 decimals
        assert abs(got[c] - float(ref[c])) <= 1e-4


def test_replicas_split_rows_in_order():
    torch.manual_seed(0)
    layer = torch.nn.Linear(6, 3)
    x = torch.randn(8, 6)
    reps = Replicas(layer, replica_devices(2, "cpu"))
    assert [r for _, _, r in reps.blocks(8)] == [slice(0, 4), slice(4, 8)]
    assert reps.modules[1] is not layer
    seen = []
    out = reps(lambda m, block: seen.append(block.clone()) or m(block), x)
    assert [s.shape[0] for s in seen] == [4, 4] and torch.equal(torch.cat(seen), x)
    torch.testing.assert_close(out, layer(x), rtol=0, atol=1e-6)
    one = Replicas(layer, ["cpu"])
    assert torch.equal(one(lambda m, b: m(b), x), layer(x))
    with pytest.raises(ValueError, match="not divisible by data axis 2"):
        reps.check_divides(7, "batch")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 2 cards"):
            replica_devices(2, "cuda")
        with pytest.raises(ValueError, match="not on this machine"):
            Replicas(layer, ["cuda:0"])


def test_tfam_cli_refuses_a_lone_process_asking_for_ranks(tmp_path, monkeypatch):
    """``training.data_parallel: 2`` without ``torchrun`` names the command."""
    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({"training": {"device": "cpu", "data_parallel": 2,
                                                "model_parallel": 1}}))
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2 -m "
                                         "vimoclip_tpu_torch.cli.tfam_train_eval"):
        tfam_train_eval.main(["--config", str(cfg)])


# -- the default paths, bit for bit ------------------------------------------

D, LAYERS, NC = 32, 2, 6


def _tfam_config() -> ExperimentConfig:
    return ExperimentConfig(
        training=TrainingConfig(batch_size=4, num_workers=1, lr=1e-3, device="cpu", seed=3),
        logging=LoggingConfig(), data=DataConfig(num_classes=NC),
        model=TFAMModelConfig(d_model=D, nhead=4, num_layers=LAYERS, dim_feedforward=64,
                              dropout=0.1, mlp_dropout=0.1, attention_impl="flash"))


def _tfam_batch() -> dict:
    rng = np.random.default_rng(1)
    items = [{"video_id": f"v{i}", "embeddings": rng.standard_normal((n, D)).astype(np.float32),
              "motion_embeddings": rng.standard_normal((n - 1, D)).astype(np.float32),
              "labels": (rng.random(NC) < 0.3).astype(np.float32)}
             for i, n in enumerate((6, 9, 4, 7))]
    return {k: v for k, v in collate_pad(items).items() if k != "video_id"}


def _tfam_default(tmp_path):
    items = [{"video_id": "x", "embeddings": np.zeros((2, D), np.float32),
              "motion_embeddings": np.zeros((1, D), np.float32),
              "labels": np.zeros(NC, np.float32)}] * 4
    trainer = TFAMTrainer(_tfam_config(), str(tmp_path / "logs"), str(tmp_path / "ck"),
                          items, items)
    assert trainer.mesh is None and trainer.partition is None
    model = copy.deepcopy(trainer.model)
    opt = make_adamw(model.parameters(), 1e-3, 0.1)
    batch = _tfam_batch()
    loss, logits = trainer.train_step(batch)

    # the step as it was written before the parallel slice
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    model.train()
    gen = KeyChain(3)("dropout", 0)
    want = model(t["embeddings"], t["motion_embeddings"], t["mask_rgb"], t["mask_motion"],
                 generator=gen)
    want_loss = losses.bce_with_logits(want, t["labels"])
    want_loss.backward()
    opt.step()
    return (loss, logits, trainer.model), (want_loss.detach(), want.detach(), model)


def _student_default(tmp_path):
    cfg = ClipVisionConfig(image_size=32, patch_size=16, hidden_size=32, num_layers=1,
                           num_heads=2, intermediate_size=64, projection_dim=16)
    rng = np.random.default_rng(2)
    items = [{"video_id": f"s{i}", "rgb_emb": rng.standard_normal((4, 16)).astype(np.float32),
              "motion_frames": rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8),
              "labels": np.eye(5, dtype=np.float32)[i % 5]} for i in range(4)]
    trainer = StudentTrainer(items, items, checkpoint_dir=str(tmp_path / "ck"),
                             vision_config=cfg, num_classes=5, lr=1e-3, batch_size=4,
                             num_workers=1, half_precision=False, device="cpu",
                             grad_clip=0.5)
    assert trainer.mesh is None and trainer.partition is None
    model = copy.deepcopy(trainer.model)
    opt = make_adam(model.parameters(), 1e-3, grad_clip=0.5)
    batch = collate_segments(items)
    vals, logits = trainer.train_step(batch)

    model.train()
    _, distill, want = model(torch.from_numpy(batch["motion_frames"]))
    d = losses.distillation_loss(distill, torch.from_numpy(batch["rgb_emb"])[:, :-1], "cosine")
    c = losses.classification_loss(want, torch.from_numpy(batch["labels"]), 9.0)
    (d + c).backward()
    opt.step()
    return (vals, logits, trainer.model), (torch.stack([d + c, d, c]).detach(),
                                           want.detach(), model)


@pytest.mark.parametrize("entry", ["tfam_step", "student_step"])
def test_default_training_steps_are_bitwise(tmp_path, entry):
    """One process, no process group, data_parallel -1: the trainers' step
    is the plain step (same dropout stream, same optimizer), bit for bit."""
    (loss, logits, model), (want_loss, want, ref) = (
        _tfam_default if entry == "tfam_step" else _student_default)(tmp_path)
    assert torch.equal(loss, want_loss) and torch.equal(logits, want)
    for (name, a), b in zip(model.state_dict().items(), ref.state_dict().values()):
        assert torch.equal(a, b), name


def test_default_extraction_is_bitwise(state):  # noqa: F811
    from vimoclip_tpu_torch.extraction import ClipExtractor

    extractor = ClipExtractor(state, CFG, batch_size=8, half_precision=False, device="cpu")
    assert len(extractor.replicas) == 1
    frames = np.random.default_rng(4).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    got = extractor._fetch(extractor._dispatch(frames))
    with torch.inference_mode():
        want = extractor.encoder(clip_preprocess(torch.from_numpy(frames), CFG.image_size,
                                                 dtype=torch.float32)).float()
    assert np.array_equal(got, want.numpy())


def test_default_predictor_is_bitwise(weights, tmp_path):  # noqa: F811
    """``--data-parallel 1``: each tower window is the tower's own call."""
    from vimoclip_tpu_torch.cli import predict as cli

    paths, config, video, _, _ = _reference_files(weights, tmp_path)
    args = cli.argparse.Namespace(
        teacher_weights=paths["teacher"], student_torch_checkpoint=paths["student"],
        student_clip_weights=None, tfam_config=config, tfam_torch_checkpoint=paths["tfam"],
        quantize=None, token_merge=0, verify_fidelity=0, frame_batch=8, float32=True,
        quirk_batch_pooling=False, device="cpu", data_parallel=1)
    pred = cli.build_predictor(args)
    frames = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (8, 36, 48, 3), dtype=np.uint8))
    with torch.inference_mode():
        for enc, embed in ((pred.teacher, pred._teacher_embed),
                           (pred.student, pred._student_embed)):
            want = enc(clip_preprocess(frames, VGEOM["image_size"],
                                       dtype=torch.float32)).float()
            assert torch.equal(embed(frames), want)
