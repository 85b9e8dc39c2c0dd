"""The port's operations tools on the CPU: the sweep harness
(``cli/run_experiments.py``) against the JAX package's, the device
benchmark (``cli/benchmark.py``) at a tiny size, and ``utils/profiling.py``."""

import json
import math
import os
import sys
import time

import numpy as np
import pytest
import torch
import yaml

from vimoclip_tpu.cli import run_experiments as jax_sweep
from vimoclip_tpu.data import EmbeddingWriter
from vimoclip_tpu.data.video_reader import write_video
from vimoclip_tpu_torch.cli import benchmark
from vimoclip_tpu_torch.cli import run_experiments as sweep
from vimoclip_tpu_torch.config import TFAMModelConfig, load_experiment_config
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig
from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer
from vimoclip_tpu_torch.utils.profiling import (
    MemoryMonitor,
    annotate,
    device_memory_stats,
    trace,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """The trainers run without TensorBoard, as on the card's machine: its
    import takes seconds."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.mark.parametrize("overrides", [
    ({}, None),
    ({"train_dataset_path": "/x/train.h5", "frame_diff_dataset_path": "/x/m.h5"},
     {"training": {"epochs": 2, "device": "cpu"}, "model": {"d_model": 16}}),
], ids=["defaults", "overrides"])
def test_generate_writes_the_jax_files_byte_for_byte(tmp_path, overrides):
    data, base = overrides
    ref = jax_sweep.generate(str(tmp_path / "jax"), data, base_overrides=base)
    got = sweep.generate(str(tmp_path / "port"), data, base_overrides=base)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in ref]
    assert len(got) == len(sweep.REFERENCE_GRID) == 21
    for a, b in zip(got, ref):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a
    assert sweep.REFERENCE_GRID == jax_sweep.REFERENCE_GRID
    # every file loads through the port's config system
    cfg = load_experiment_config(got[3])
    assert cfg.training.batch_size == 4 and not cfg.model.use_cross_attention


def test_sweep_order_matches_jax():
    names = ["config_10.yaml", "config_2.yaml", "config_default.yaml", "config_x.yaml",
             "config_1.yaml"]
    assert sweep._sweep_order(names) == jax_sweep._sweep_order(names)
    assert sweep._sweep_order(names)[:3] == ["config_default.yaml", "config_1.yaml",
                                             "config_2.yaml"]


def _sweep_fixture(tmp_path, mode="both", broken=False):
    """Two tiny configs (cross-attention and temporal concat) over a paired
    HDF5 corpus, on the CPU; with ``broken`` a third whose model raises."""
    rng = np.random.default_rng(11)
    rgb, motion = str(tmp_path / "rgb.h5"), str(tmp_path / "mot.h5")
    with EmbeddingWriter(rgb, num_classes=4, embed_dim=16) as wr, \
         EmbeddingWriter(motion, embed_dim=16) as wm:
        for i in range(8):
            t = int(rng.integers(5, 9))
            lab = np.zeros(4, np.float32)
            lab[i % 4] = 1
            wr.write_video(f"v{i}.mp4", rng.normal(size=(t, 16)).astype(np.float32),
                           labels=lab)
            wm.write_video(f"v{i}", rng.normal(size=(t - 1, 16)).astype(np.float32))
    cfg_dir = tmp_path / "cfgs"
    cfg_dir.mkdir()
    base = {
        "training": {"mode": mode, "seed": 49, "lr": 1e-3, "epochs": 1, "batch_size": 4,
                     "num_workers": 1, "device": "cpu"},
        "logging": {"log_dir": "logs", "checkpoint_dir": "ckpt"},
        "data": {"num_classes": 4, "train_dataset_path": rgb, "val_dataset_path": rgb,
                 "flow_dataset_path": motion, "length_bucket": 8},
        "model": {"d_model": 16, "nhead": 2, "num_layers": 1, "dim_feedforward": 32,
                  "dropout": 0.0, "mlp_dropout": 0.0},
    }
    models = [{"use_cross_attention": True}, {"use_cross_attention": False}]
    if broken:  # 3 heads do not divide d_model 16: the model refuses
        models.insert(1, {"nhead": 3})
    for i, model in enumerate(models):
        cfg = dict(base, model=dict(base["model"], **model))
        (cfg_dir / f"config_{i}.yaml").write_text(yaml.safe_dump(cfg))
    return cfg_dir


def test_sweep_runs_records_errors_and_goes_on(tmp_path, monkeypatch):
    cfg_dir = _sweep_fixture(tmp_path, broken=True)
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "sweep.json")
    results = sweep.run(str(cfg_dir), out)
    assert [r["status"] for r in results] == ["ok", "error", "ok"]
    assert "error" in results[1]
    for r in (results[0], results[2]):
        assert 0.0 <= r["best_val_mAP"] <= 1.0
        assert math.isfinite(r["eval_loss"]) and 0.0 <= r["eval_mAP"] <= 1.0
    with open(out) as f:
        assert json.load(f) == results
    assert os.path.isdir(cfg_dir / "config_0" / "results")


def test_sweep_stops_on_preemption_and_resume_carries_ok_forward(tmp_path, monkeypatch):
    """A preempted config stops the sweep (its result written, -inf as
    null); ``run --resume`` carries ``ok`` configs forward without training
    them again and reruns the rest with ``training.resume`` on."""
    cfg_dir = _sweep_fixture(tmp_path, mode="train")
    monkeypatch.chdir(tmp_path)
    resumes, calls = [], {"n": 0}
    orig_init = TFAMTrainer.__init__

    def recording_init(self, config, *a, **kw):
        resumes.append(config.training.resume)
        orig_init(self, config, *a, **kw)

    def phased_train(self):
        calls["n"] += 1
        if calls["n"] == 2:  # config_1 preempted before its first validation
            self.preempted = True
            return float("-inf")
        return 0.5 if calls["n"] == 1 else 0.7

    monkeypatch.setattr(TFAMTrainer, "__init__", recording_init)
    monkeypatch.setattr(TFAMTrainer, "train", phased_train)
    out = str(tmp_path / "sweep.json")
    results = sweep.run(str(cfg_dir), out)
    assert [r["status"] for r in results] == ["ok", "preempted"]
    assert results[1]["best_val_mAP"] is None
    with open(out) as f:
        assert json.load(f) == results  # strict JSON: no -Infinity

    resumes.clear()
    recovered = sweep.run(str(cfg_dir), out, resume=True)
    assert [r["status"] for r in recovered] == ["ok", "ok"]
    assert [r["best_val_mAP"] for r in recovered] == [0.5, 0.7]
    assert calls["n"] == 3 and resumes == [True]


def test_sweep_main_generate(tmp_path, capsys):
    sweep.main(["generate", "--out-dir", str(tmp_path / "g"), "--train-h5", "/t.h5",
                "--base-overrides", json.dumps({"training": {"device": "cpu"}})])
    assert "wrote 21 configs" in capsys.readouterr().out
    cfg = load_experiment_config(str(tmp_path / "g" / "config_default.yaml"))
    assert cfg.training.device == "cpu" and cfg.data.train_dataset_path == "/t.h5"


TINY_VISION = ClipVisionConfig(image_size=32, patch_size=8, hidden_size=32, num_layers=1,
                               num_heads=2, intermediate_size=64, projection_dim=16)
TINY_TFAM = TFAMModelConfig(d_model=16, nhead=2, num_layers=1, dim_feedforward=32,
                            dropout=0.0, mlp_dropout=0.0)


def test_bench_gpu_on_the_cpu_at_a_tiny_size():
    out = benchmark._bench_gpu(batch=4, iters=2, device="cpu", vision_config=TINY_VISION,
                               tfam_config=TINY_TFAM, frame_hw=(36, 48), clips=(2, 9))
    assert out["device"] == "cpu" and out["device_memory"] == {}
    for key in ("extract_frames_per_s", "tfam_clips_per_s"):
        assert math.isfinite(out[key]) and out[key] > 0


def test_bench_gpu_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        benchmark._bench_gpu(batch=1, iters=1)


def test_bench_motion_frame_diff_on_the_cpu(tmp_path):
    rng = np.random.default_rng(2)
    vids = []
    for i in range(2):
        path = str(tmp_path / f"v{i}.mp4")
        write_video(path, rng.integers(0, 256, (8, 32, 48, 3), dtype=np.uint8))
        vids.append(path)
    out = benchmark._bench_motion(vids, "frame_diff", str(tmp_path), device="cpu")
    assert out["videos"] == 2 and out["frames"] == 14  # 2 x (8 - 1)
    assert out["fps"] > 0 and out["peak_device_mb"] is None
    assert "nonzero_frac" in out["output_stats"]


def test_benchmark_main_motion_only(tmp_path, monkeypatch):
    """``--skip-gpu --skip-flow`` runs the frame-difference arm only; on the
    CPU the arm's default device (the card) is refused."""
    write_video(str(tmp_path / "a.mp4"),
                np.random.default_rng(0).integers(0, 256, (5, 32, 48, 3), dtype=np.uint8))
    args = ["--videos-dir", str(tmp_path), "--skip-gpu", "--skip-flow",
            "--output", str(tmp_path / "r.json")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            benchmark.main(args)
        return
    benchmark.main(args)
    assert json.loads((tmp_path / "r.json").read_text())["frame_diff"]["frames"] == 4


def test_profiling_trace_annotate_and_memory(tmp_path):
    d = str(tmp_path / "traces")
    with trace(d):
        with annotate("smoke"):
            _ = torch.ones(8, 8) @ torch.ones(8, 8)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "smoke" for e in events)
    if not torch.cuda.is_available():
        assert device_memory_stats() == {}
    with MemoryMonitor(interval_s=0.01) as mem:
        _ = np.zeros((1000, 1000))
        time.sleep(0.05)
    assert len(mem.samples_mb) >= 2 and mem.peak_mb > 0
