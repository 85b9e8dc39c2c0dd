"""The port's one-command cascade on the CPU: ``run_pipeline(device="cpu")``
through the port's own CLIs (extract -> motion -> distil -> export -> fuse)
on a tiny corpus, with a relative workdir; every marker and artifact; the
stage-0 file equal to the JAX package's ``create_hdf5_dataset`` on the same
inputs; an identical rerun skips every stage; ``force`` reruns them."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import vimoclip_tpu_torch.cli.export_motion_embeddings as export_cli
import vimoclip_tpu_torch.cli.extract_embeddings as extract_cli
import vimoclip_tpu_torch.cli.tfam_train_eval as tfam_cli
import vimoclip_tpu_torch.cli.train_student as student_cli
import vimoclip_tpu_torch.motion as motion
from vimoclip_tpu.data.video_reader import write_video
from vimoclip_tpu.extraction import create_hdf5_dataset as jax_create_hdf5_dataset
from vimoclip_tpu.models.pretrained import load_clip_vision as jax_load_clip_vision
from vimoclip_tpu_torch.cli.run_pipeline import main as pipeline_main
from vimoclip_tpu_torch.pipeline import PipelineConfig, run_pipeline

from test_torch_extraction import assert_same_file

torch.set_num_threads(1)

C = 3
STAGES = ("extract_train", "extract_val", "generate_motion", "train_student",
          "export_motion", "tfam")


@pytest.fixture(scope="module")
def cascade(tmp_path_factory):
    """One real run of the pipeline CLI; returns (tmp dir, argv)."""
    tmp = tmp_path_factory.mktemp("pipeline")
    root = tmp / "videos"
    root.mkdir()
    rng = np.random.default_rng(3)
    names = []
    for i in range(6):
        frames = rng.integers(0, 256, (int(rng.integers(7, 10)), 36, 48, 3), dtype=np.uint8)
        write_video(str(root / f"v{i}.mp4"), frames)
        names.append(f"v{i}.mp4")
    (root / "train.txt").write_text("\n".join(f"{n} {i % C}" for i, n in enumerate(names)))
    (root / "val.txt").write_text("\n".join(f"{n} {i % C}" for i, n in enumerate(names[:3])))
    (root / "classes.csv").write_text("id,name\n" + "\n".join(f"{i},cls{i}" for i in range(C)))

    from transformers import CLIPVisionConfig as HFConfig
    from transformers import CLIPVisionModelWithProjection

    torch.manual_seed(0)
    hf = CLIPVisionModelWithProjection(HFConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=2,
        image_size=32, patch_size=8, projection_dim=24))
    torch.save(hf.state_dict(), tmp / "clip.pt")
    (tmp / "tfam.yaml").write_text(yaml.safe_dump({
        "training": {"mode": "both", "seed": 49, "lr": 3e-3, "epochs": 1, "batch_size": 4,
                     "num_workers": 1},
        "model": {"d_model": 24, "nhead": 2, "num_layers": 1, "dim_feedforward": 48,
                  "dropout": 0.0, "mlp_dropout": 0.0},
        "data": {"length_bucket": 8},
    }))
    argv = ["--workdir", "run", "--data-root", str(root),
            "--train-annotations", str(root / "train.txt"),
            "--val-annotations", str(root / "val.txt"),
            "--class-file", str(root / "classes.csv"),
            "--clip-weights", str(tmp / "clip.pt"), "--tfam-config", str(tmp / "tfam.yaml"),
            "--num-classes", str(C), "--extract-batch", "8", "--student-epochs", "1",
            "--student-batch", "2", "--sequence-length", "5", "--num-workers", "1",
            "--float32", "--device", "cpu"]
    cwd = os.getcwd()
    os.chdir(tmp)  # the workdir is relative on purpose
    try:
        pipeline_main(argv)
    finally:
        os.chdir(cwd)
    return tmp, argv


def test_pipeline_writes_every_marker_and_artifact(cascade):
    tmp, _ = cascade
    run = tmp / "run"
    for stage in STAGES:
        assert (run / f".{stage}.done").exists(), stage
    for name in ("rgb_train.h5", "rgb_val.h5", "motion.h5", "video_list.txt",
                 "tfam/pipeline.yaml", "student_ckpt/best/best_model.pth"):
        assert (run / name).exists(), name
    assert sorted(os.listdir(run / "motion_videos")) == [f"v{i}.mp4" for i in range(6)]
    injected = yaml.safe_load((run / "tfam" / "pipeline.yaml").read_text())
    assert injected["training"]["device"] == "cpu"
    assert injected["data"]["train_dataset_path"] == str(run / "rgb_train.h5")
    assert injected["data"]["flow_dataset_path"] == str(run / "motion.h5")
    results = sorted((run / "tfam").glob("results/results_*.json"))
    assert results and (run / "tfam" / "pipeline" / "checkpoints" / "pipeline").is_dir()
    final = json.loads(results[-1].read_text())
    assert np.isfinite(final["metrics"]["mAP"])


def test_pipeline_stage0_equals_jax_extraction(cascade):
    tmp, _ = cascade
    root = tmp / "videos"
    config, params = jax_load_clip_vision(str(tmp / "clip.pt"))
    for split, ann in (("train", "train.txt"), ("val", "val.txt")):
        theirs = str(tmp / f"jax_{split}.h5")
        errors = jax_create_hdf5_dataset(
            data_root=str(root), annotation_file=str(root / ann),
            class_file=str(root / "classes.csv"), output_hdf5=theirs, params=params,
            config=config, batch_size=8, split=split,
            clip_model_name=f"ViT-B/{config.patch_size}", half_precision=False)
        assert errors == {}
        assert_same_file(str(tmp / "run" / f"rgb_{split}.h5"), theirs)


def _count_stage_calls(monkeypatch):
    calls = {}

    def spy(name):
        def stage(*args, **kwargs):
            calls.setdefault(name, []).append((args, kwargs))
            return {}
        return stage

    for mod, name in ((extract_cli, "extract"), (student_cli, "train_student"),
                      (export_cli, "export"), (tfam_cli, "tfam")):
        monkeypatch.setattr(mod, "main", spy(name))
    monkeypatch.setattr(motion, "process_video_list", spy("motion"))
    return calls


def test_identical_rerun_skips_every_stage(cascade, monkeypatch):
    tmp, argv = cascade
    calls = _count_stage_calls(monkeypatch)
    monkeypatch.chdir(tmp)
    pipeline_main(argv)
    assert calls == {}


def test_force_reruns_every_stage(cascade, monkeypatch):
    tmp, argv = cascade
    calls = _count_stage_calls(monkeypatch)
    monkeypatch.chdir(tmp)
    pipeline_main(argv + ["--force"])
    assert {k: len(v) for k, v in calls.items()} == {
        "extract": 2, "motion": 1, "train_student": 1, "export": 1, "tfam": 1}
    assert "--overwrite" in calls["export"][0][0][0]
    assert calls["motion"][0][1]["skip_existing"] is False
    for name in ("extract", "train_student", "export"):
        stage_argv = calls[name][0][0][0]
        assert stage_argv[stage_argv.index("--device") + 1] == "cpu"
    assert "--device" not in calls["tfam"][0][0][0]


def test_pipeline_refuses_multi_gpu(cascade, tmp_path, monkeypatch):
    """What this test refused before slice 7a now runs: ``--data-parallel
    2`` extracts with two replicas of the tower (the file one tower writes)
    and trains stage 1 under ``torchrun`` on two gloo ranks; stage 2 reads
    its own ``training.data_parallel: 2`` and runs under ``torchrun`` too.
    Every marker lands, and rank 0's checkpoints and results are there."""
    from test_torch_parallel_entry import without_tensorflow

    tmp, argv = cascade
    without_tensorflow(tmp_path, monkeypatch)
    doc = yaml.safe_load((tmp / "tfam.yaml").read_text())
    doc["training"]["data_parallel"] = 2
    (tmp_path / "tfam.yaml").write_text(yaml.safe_dump(doc))
    argv = list(argv)
    argv[argv.index("--workdir") + 1] = str(tmp_path / "run")
    argv[argv.index("--tfam-config") + 1] = str(tmp_path / "tfam.yaml")
    pipeline_main(argv + ["--data-parallel", "2"])
    run = tmp_path / "run"
    for stage in STAGES:
        assert (run / f".{stage}.done").exists(), stage
    for split in ("train", "val"):
        assert_same_file(str(run / f"rgb_{split}.h5"), str(tmp / "run" / f"rgb_{split}.h5"))
    assert (run / "student_ckpt" / "best" / "best_model.pth").exists()
    results = sorted((run / "tfam").glob("results/results_*.json"))
    assert len(results) == 1  # rank 0 alone writes
    assert np.isfinite(json.loads(results[-1].read_text())["metrics"]["mAP"])
