"""The port's spans (``utils/profiling.py::annotate``) on the CPU: under a
profiler the trainer, the data pipeline, attention and the predictor open
their ``vimo.*`` spans once per step, batch, call or window, nested as
documented; with no profiler running ``annotate`` hands out the shared no-op
context and nothing is recorded."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vimoclip_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    LoggingConfig,
    TFAMModelConfig,
    TrainingConfig,
)
from vimoclip_tpu_torch.data.video_reader import write_video
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
from vimoclip_tpu_torch.models.tfam import TFAM
from vimoclip_tpu_torch.serving import ViMoCLIPPredictor
from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer
from vimoclip_tpu_torch.utils import profiling

torch.set_num_threads(1)
D, C = 16, 5
TFAM_GEOM = dict(d_model=D, nhead=2, num_layers=1, dim_feedforward=32, dropout=0.1,
                 mlp_dropout=0.0, attention_impl="flash")


def _spans(prof) -> list[tuple[str, int, int]]:
    """(name, start, end) of every ``vimo.*`` range recorded, by start."""
    events = prof.profiler.kineto_results.events()
    return sorted(((e.name(), e.start_ns(), e.end_ns()) for e in events
                   if e.name().startswith("vimo.")), key=lambda s: s[1])


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def _each_inside(spans, child: str, parent: str) -> None:
    parents = _named(spans, parent)
    for c in _named(spans, child):
        assert sum(_inside(c, p) for p in parents) == 1, (child, parent)


def _items(n, rng):
    items = []
    for i in range(n):
        t = int(rng.integers(5, 12))
        labels = np.zeros(C, np.float32)
        labels[int(rng.integers(C))] = 1.0
        items.append({"video_id": f"v{i}", "labels": labels,
                      "embeddings": rng.standard_normal((t, D)).astype(np.float32),
                      "motion_embeddings": rng.standard_normal((t - 1, D)).astype(np.float32)})
    return items


def test_train_epoch_spans_each_phase_once_a_step(tmp_path):
    cfg = ExperimentConfig(
        training=TrainingConfig(epochs=1, batch_size=4, num_workers=2, lr=1e-3,
                                device="cpu", seed=3),
        logging=LoggingConfig(), data=DataConfig(num_classes=C, length_bucket=8),
        model=TFAMModelConfig(**TFAM_GEOM))
    items = _items(8, np.random.default_rng(0))  # 2 steps
    trainer = TFAMTrainer(cfg, str(tmp_path / "logs"), str(tmp_path / "ck"), items, items)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_epoch(0)
    spans = _spans(prof)
    counts = {name: len(_named(spans, name)) for name in {s[0] for s in spans}}
    # the last data wait finds the loader's end
    assert {k: v for k, v in counts.items() if not k.startswith("vimo.attn.")} == {
        "vimo.train.data_wait": 3, "vimo.train.step": 2, "vimo.train.forward": 2,
        "vimo.train.backward": 2, "vimo.train.optimizer": 2, "vimo.train.loss_fetch": 2,
        "vimo.train.metric": 2, "vimo.data.load_wait": 2,
        "vimo.data.collate": 2, "vimo.data.upload": 2}
    # every attention call of the forward has its backward
    assert counts["vimo.attn.fwd"] == counts["vimo.attn.bwd"] > 0
    assert counts["vimo.attn.fwd"] % 2 == 0
    for child in ("vimo.train.forward", "vimo.train.backward", "vimo.train.optimizer"):
        _each_inside(spans, child, "vimo.train.step")
    _each_inside(spans, "vimo.attn.fwd", "vimo.train.forward")
    _each_inside(spans, "vimo.attn.bwd", "vimo.train.backward")
    for child in ("vimo.data.load_wait", "vimo.data.collate", "vimo.data.upload"):
        _each_inside(spans, child, "vimo.train.data_wait")
    # the loop's phases do not overlap, so their host times add up
    top = sorted((s for s in spans if s[0] in (
        "vimo.train.data_wait", "vimo.train.step", "vimo.train.loss_fetch",
        "vimo.train.metric")), key=lambda s: s[1])
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))
    assert [s[0] for s in top[:5]] == ["vimo.train.data_wait", "vimo.train.step",
                                       "vimo.train.loss_fetch", "vimo.train.metric",
                                       "vimo.train.data_wait"]


@pytest.mark.parametrize("given", ["frames", "file"])
def test_predict_videos_spans_a_request_and_its_five_phases(given, tmp_path):
    """``predict_videos([frames])`` and ``predict(path)``, its one-clip form
    on a file, open the same spans."""
    vision = ClipVisionConfig(image_size=32, patch_size=8, hidden_size=32, num_layers=1,
                              num_heads=2, intermediate_size=64, projection_dim=D)
    tfam_cfg = TFAMModelConfig(**(TFAM_GEOM | {"dropout": 0.0}))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        teacher = ClipVisionEncoder(vision, torch.float32).state_dict()
        student = ClipVisionEncoder(vision, torch.float32).state_dict()
        fusion = TFAM(tfam_cfg, C, torch.float32).state_dict()
    predictor = ViMoCLIPPredictor(teacher, vision, student, vision, fusion, tfam_cfg,
                                  num_classes=C, frame_batch=8, length_bucket=8,
                                  half_precision=False, device="cpu")
    clip = np.random.default_rng(1).integers(0, 256, (20, 40, 48, 3), dtype=np.uint8)
    path = str(tmp_path / "clip.mp4")
    write_video(path, clip)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if given == "frames":
            (pred,) = predictor.predict_videos([clip])
        else:
            pred = predictor.predict(path)
    assert pred.probabilities.shape == (C,)
    spans = _spans(prof)
    (request,) = _named(spans, "vimo.serve.request")
    windows = 3  # 20 frames in windows of 8
    for name, count in (("vimo.serve.pool", 2), ("vimo.serve.upload", windows),
                        ("vimo.serve.embed", windows), ("vimo.serve.fetch", windows),
                        ("vimo.serve.fuse", 1)):
        found = _named(spans, name)
        assert len(found) == count, name
        assert all(_inside(s, request) for s in found), name
    _each_inside(spans, "vimo.attn.fwd", "vimo.serve.fuse")
    children = sorted((s for s in spans if s[0] in (
        "vimo.serve.pool", "vimo.serve.upload", "vimo.serve.embed", "vimo.serve.fetch",
        "vimo.serve.fuse")), key=lambda s: s[1])
    assert all(a[2] <= b[1] for a, b in zip(children, children[1:]))


def test_annotate_is_the_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert profiling.annotate("vimo.test.off") is profiling._NO_SPAN
    handed = []

    def worker():  # a plain thread does not carry the profiler's state
        span = profiling.annotate("vimo.test.worker")
        handed.append(span)
        with span, profiling.annotate("vimo.test.nested"):
            torch.ones(2) + 1

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("vimo.test.on"):
            thread = threading.Thread(target=worker)
            thread.start()
            thread.join()
    assert handed == [profiling._NO_SPAN]
    assert [s[0] for s in _spans(prof)] == ["vimo.test.on"]
