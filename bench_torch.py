#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (``vimoclip_tpu_torch``): the four hot
paths of ``bench.py`` on one NVIDIA card, in one JSON line.

    python3 bench_torch.py

1. **Extraction** (headline metric): CLIP ViT-B/16 in bf16 on 128
   device-resident 360x640 uint8 frames a call, ``clip_preprocess`` on the
   card then the tower; the turbo arm (dynamic int8 matmuls + ToMe r = 16)
   on the same weights; against a reference-style baseline on the same
   machine: 64 frames preprocessed serially, one at a time, by the port's
   ``clip_preprocess`` on CPU tensors, then one device forward
   (``transformers.CLIPImageProcessor``, which ``bench.py`` uses, is not on
   the card's machine).
2. **TFAM train step** (stage 2): d 512, 8 heads, 4 layers, ff 2048,
   cross-attention, ``attention_impl="auto"``, bf16 compute, dropout 0.1
   from an explicit generator, b 8 x t 512, BCE + AdamW.
3. **Student train step** (stage 1): ViT-B/32 in bf16, b 8 x 29 frames of
   360x640 uint8, cosine distillation + ``classification_loss(..., 9.0)``,
   Adam.
4. **Serving**: warm latency of one 450-frame host video through
   ``ViMoCLIPPredictor`` (ViT-B/16 teacher, ViT-B/32 student, TFAM), and
   pooled ``predict_videos`` against a serial loop over six device-resident
   clips, with the largest probability difference between the two.
5. **cuda_test**: the card-only tests (``pytest -m cuda
   tests/test_torch_cuda.py``) in a subprocess, their verdict and counts.

Timing: every input is on the card before the clock starts. A timed call is
``iters`` eager calls of the path between two CUDA events, after one
warm-up call, with one ``torch.cuda.synchronize`` at its end; the best of
three (five for the train steps). Eager PyTorch cannot hoist a
loop-invariant body, so ``bench.py``'s ``lax.scan`` and its one-pixel
perturbation have no counterpart here. Every path of the port is
host-bound, so wall time alone cannot be read: beside each wall time the
line holds the device busy time and idle share of one extra timed call,
traced with ``torch.profiler`` (``utils/profiling.py::trace``; the
profiler's own host cost is inside that call's wall time). TFLOP/s count
true matmul FLOPs (2 a MAC; a train step 3x its forward) and the MFU is
against a bf16 matmul ceiling this run measures on this card (chained
4096^3 ``torch.matmul``, best of three).

The line: ``{"metric", "value", "unit", "vs_baseline", "detail"}`` with
``bench.py``'s keys (``cuda_test`` in place of ``tpu_test``); ``device``
is the card's name and power limit as ``nvidia-smi`` gives them. Without a
card it exits 2 with a message and prints nothing on stdout. Unlike
``bench.py`` it swallows no failure: a section that raises, a ``cuda_test``
that does not pass, or a pooled/serial probability difference above 1e-5
still prints the line, then exits 1. The kernels build from
``vimoclip_tpu_torch/csrc`` into ``build/`` at first use.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

VIT_B16_GFLOP_PER_FRAME = 35.0  # true FLOPs fwd @ 224^2 (2 FLOPs/MAC)

# bench.py's three recipes (held to its own by tests/test_torch_bench.py)
EXTRACTION_RECIPE = dict(batch=128, iters=32)
TFAM_RECIPE = dict(b=8, t=512, d=512, layers=4, ff=2048, classes=140, iters=32)
STUDENT_RECIPE = dict(b=8, t=29, h=360, w=640, classes=140, iters=16)

SERVING_LENGTHS = (160, 144, 176, 152, 168, 136)
SERVING_DELTA_MAX = 1e-5  # pooled against serial probabilities
CEILING_N = 4096
CEILING_CHAIN = 32
BASELINE_FRAMES = 64
# ``-o addopts=``: the project's own ``-q`` and this one would make ``-qq``,
# which drops the summary line the record is read from
CUDA_TEST_CMD = ["-m", "pytest", "-o", "addopts=", "-m", "cuda", "--noconftest",
                 "-p", "no:cacheprovider", "tests/test_torch_cuda.py", "-q"]
CUDA_TEST_TIMEOUT_S = 900


def _make_frames(n: int, h=360, w=640, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 256, (n, h // 24, w // 32, 3), dtype=np.uint8)
    import cv2

    return np.stack(
        [cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR) for f in low]
    )


def _best_of(fn, n=3) -> float:
    """Best wall time of n calls (first call must be warm)."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def _transformer_flops(t: int, d: int, ff: int, layers: int, cross: bool) -> float:
    """True matmul FLOPs of one forward over a t-token sequence (per batch
    element): q/k/v/out projections, attention score+value matmuls, FFN."""
    proj = 4 * 2 * t * d * d  # q, k, v, out
    attn = 2 * 2 * t * t * d  # scores + values
    ffn = 2 * 2 * t * d * ff
    per_layer = proj + attn + ffn
    if cross:
        per_layer += proj + attn
    return layers * per_layer


def _round(tree, nd=3):
    if isinstance(tree, dict):
        return {k: _round(v, nd) for k, v in tree.items()}
    if isinstance(tree, float):
        return round(tree, nd) if np.isfinite(tree) else None
    return tree


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_call(fn, iters: int, device) -> float:
    """Seconds of ``iters`` calls of ``fn``: CUDA events around them on the
    card, then one synchronize; the host clock on the CPU."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3


def _best_timed(fn, iters: int, device, n: int = 3) -> float:
    """Best of ``n`` timed calls of ``iters`` calls each, after one warm-up
    call of ``fn``."""
    fn()
    _sync(device)
    return min(_timed_call(fn, iters, device) for _ in range(n))


def _device_us(event) -> float:
    """Device time of a profiler entry that ran on the card (kernels,
    copies); 0 for host entries, whose device time would count twice."""
    from torch.autograd import DeviceType

    if event.device_type != DeviceType.CUDA:
        return 0.0
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def _busy(fn, iters: int, device) -> dict:
    """Wall ms, device busy ms and idle share of one traced call of
    ``iters`` calls of ``fn``; None for each on the CPU (not measured)."""
    if device.type != "cuda":
        return {"profiled_wall_ms": None, "device_busy_ms": None, "device_idle_share": None}
    import tempfile

    from vimoclip_tpu_torch.utils.profiling import trace

    _sync(device)
    with tempfile.TemporaryDirectory(prefix="bench_torch_trace_") as log_dir:
        with trace(log_dir) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            _sync(device)
            wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(_device_us(e) for e in prof.key_averages()) / 1e3
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms}


def _launches() -> dict:
    """The port's kernel launch counts so far, by kind."""
    from vimoclip_tpu_torch.ops.kernels.flash_attention import flash_attention
    from vimoclip_tpu_torch.ops.kernels.normalize import fused_normalize

    return {**flash_attention.launches, "fused_normalize": fused_normalize.launches}


def _launched_since(before: dict) -> dict:
    """Launches of each kind since ``before``, the kinds that ran only."""
    return {k: n - before[k] for k, n in _launches().items() if n != before[k]}


def _generator(device, seed: int):
    import torch

    return torch.Generator(device=device).manual_seed(seed)


def measure_ceiling(device="cuda", n: int = CEILING_N) -> float:
    """TFLOP/s of 32 chained (n, n) x (n, n) bf16 ``torch.matmul`` calls a
    timed call, best of three: the card's bf16 matmul ceiling as this run
    measures it."""
    import torch

    from vimoclip_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    g = _generator(dev, 0)
    # w / sqrt(n) keeps the chained product's scale near the input's
    w = (torch.randn(n, n, device=dev, generator=g) / n ** 0.5).to(torch.bfloat16)
    x0 = torch.randn(n, n, device=dev, generator=g).to(torch.bfloat16)

    def run():
        x = x0
        for _ in range(CEILING_CHAIN):
            x = torch.matmul(x, w)
        return x

    best = _best_timed(run, 1, dev)
    return 2.0 * n ** 3 * CEILING_CHAIN / best / 1e12


# ---------------------------------------------------------------------------
# the four paths
# ---------------------------------------------------------------------------


def bench_extraction(device="cuda", recipe=EXTRACTION_RECIPE, vision_config=None,
                     frame_hw=(360, 640), ceiling_tflops: float | None = None) -> dict:
    """Frames/s of ViT-B/16 extraction (``clip_preprocess`` on the card,
    then the tower, bf16) and of its turbo arm (int8 + ToMe r = 16) on the
    same weights and frames, against the serial host-preprocessing
    baseline."""
    import dataclasses

    import torch

    from vimoclip_tpu_torch.models import init_parameters_
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
    from vimoclip_tpu_torch.ops.preprocess import clip_preprocess
    from vimoclip_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    bf16 = torch.bfloat16
    cfg = vision_config or ClipVisionConfig.vit_b_16()  # the AK teacher
    batch, iters = recipe["batch"], recipe["iters"]
    enc = init_parameters_(ClipVisionEncoder(cfg, dtype=bf16).to(dev), _generator(dev, 0))
    enc.eval().requires_grad_(False)
    frames = _make_frames(batch, *frame_hw)
    dev_frames = torch.from_numpy(frames).to(dev)

    def arm(encoder):
        def call():
            with torch.inference_mode():
                return encoder(clip_preprocess(dev_frames, cfg.image_size, dtype=bf16))
        best = _best_timed(call, iters, dev)
        return batch * iters / best, _busy(call, iters, dev)

    fps, busy = arm(enc)
    qcfg = dataclasses.replace(cfg, matmul_quant="int8", token_merge_r=16)
    qenc = ClipVisionEncoder(qcfg, dtype=bf16).to(dev)
    qenc.load_state_dict(enc.state_dict(), strict=True)
    turbo_fps, turbo_busy = arm(qenc.eval().requires_grad_(False))

    # the reference's hot-loop structure: each frame preprocessed alone on
    # the host, then one device forward of the stack
    base = frames[:BASELINE_FRAMES]

    def one_baseline_round() -> None:
        with torch.inference_mode():
            pixels = torch.cat([clip_preprocess(torch.from_numpy(f[None]), cfg.image_size)
                                for f in base])
            enc(pixels.to(dev))
        _sync(dev)

    one_baseline_round()
    ref_fps = len(base) / _best_of(one_baseline_round)

    tflops = fps * VIT_B16_GFLOP_PER_FRAME / 1e3
    return {
        "fps": fps,
        "ref_fps": ref_fps,
        "batch": batch,
        "iters": iters,
        "tflops_per_sec": tflops,
        "mfu_vs_measured_ceiling": (tflops / ceiling_tflops if ceiling_tflops else None),
        "wall_ms_per_batch": batch / fps * 1e3,
        **busy,
        "turbo_fps": turbo_fps,
        "turbo_speedup": turbo_fps / fps,
        "turbo_profiled": turbo_busy,
        "baseline": f"{len(base)} frames preprocessed one at a time by clip_preprocess "
                    "on host CPU tensors (float32), then one device forward",
    }


def tfam_loss(model, rgb, motion, mask_rgb, mask_flow, labels, generator=None):
    """The TFAM step's loss: BCE with logits over the fusion's logits
    (``bench.py``'s ``loss_fn`` of the TFAM step)."""
    from vimoclip_tpu_torch import losses

    logits = model(rgb, motion, mask_rgb, mask_flow, generator=generator)
    return losses.bce_with_logits(logits, labels)


def student_loss(model, frames, teacher, labels):
    """The student step's loss: cosine distillation of the distillation
    branch to the teacher embeddings plus the positive-weighted BCE (9.0)
    of the logits (``bench.py``'s ``loss_fn`` of the student step)."""
    from vimoclip_tpu_torch import losses

    _, distill, logits = model(frames)
    return (losses.distillation_loss(distill, teacher, "cosine")
            + losses.classification_loss(logits, labels, 9.0))


def _train_timing(step, iters: int, dev, flops_per_step: float,
                  ceiling_tflops: float | None) -> dict:
    """Best of five timed calls of ``iters`` steps, launches per step over
    them, and one traced call."""
    step()  # warm-up: kernel builds, cuBLAS set-up, optimizer state
    _sync(dev)
    before = _launches()
    best = min(_timed_call(step, iters, dev) for _ in range(5))
    per_step = {k: n / (5 * iters) for k, n in _launched_since(before).items()}
    tflops = flops_per_step / (best / iters) / 1e12
    return {
        "ms_per_step": best / iters * 1e3,
        "tflops_per_sec": tflops,
        "mfu_vs_measured_ceiling": tflops / ceiling_tflops if ceiling_tflops else None,
        "launches_per_step": per_step,
        **_busy(step, iters, dev),
    }, best


def bench_tfam_train(device="cuda", recipe=TFAM_RECIPE,
                     ceiling_tflops: float | None = None) -> dict:
    """The stage-2 train step at the AK recipe: loss, gradients and AdamW."""
    import torch

    from vimoclip_tpu_torch.config import TFAMModelConfig
    from vimoclip_tpu_torch.models import init_parameters_
    from vimoclip_tpu_torch.models.tfam import TFAM
    from vimoclip_tpu_torch.train.state import make_adamw
    from vimoclip_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    b, t, d, layers, ff, classes, iters = (
        recipe[k] for k in ("b", "t", "d", "layers", "ff", "classes", "iters"))
    cfg = TFAMModelConfig(d_model=d, nhead=8, num_layers=layers, dim_feedforward=ff,
                          attention_impl="auto")
    model = TFAM(cfg, num_classes=classes, dtype=torch.bfloat16).to(dev)
    init_parameters_(model, _generator(dev, 0)).train()
    rng = np.random.default_rng(0)
    put = lambda a: torch.from_numpy(a).to(dev)
    rgb = put(rng.normal(size=(b, t, d)).astype(np.float32))
    motion = put(rng.normal(size=(b, t - 1, d)).astype(np.float32))
    mr = torch.ones(b, t, dtype=torch.bool, device=dev)
    mf = torch.ones(b, t - 1, dtype=torch.bool, device=dev)
    labels = put((rng.random((b, classes)) < 0.05).astype(np.float32))
    opt = make_adamw(model.parameters(), 1e-4, 0.1)
    gen = _generator(dev, 1)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = tfam_loss(model, rgb, motion, mr, mf, labels, gen)
        loss.backward()
        opt.step()
        return loss.detach()

    fwd = b * _transformer_flops(t, d, ff, layers, cross=True)
    timing, best = _train_timing(step, iters, dev, 3 * fwd, ceiling_tflops)
    kinds = sorted(timing["launches_per_step"])
    return {
        "clips_per_sec": b * iters / best,
        **timing,
        "batch": b, "seq_len": t, "heads": cfg.nhead,
        "attention_impl": ("auto -> kernels: " + ", ".join(kinds) if kinds
                           else "auto -> eager (no kernel launched)"),
        "dtype": "bfloat16", "dropout": cfg.dropout,
    }


def bench_student_train(device="cuda", recipe=STUDENT_RECIPE, vision_config=None,
                        ceiling_tflops: float | None = None) -> dict:
    """The stage-1 train step: ViT-B/32 distillation on 360x640 uint8
    motion frames, cosine distillation + BCE, Adam."""
    import torch

    from vimoclip_tpu_torch.models import init_parameters_
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig
    from vimoclip_tpu_torch.models.student import StudentModel
    from vimoclip_tpu_torch.train.state import make_adam
    from vimoclip_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    b, t, h, w, classes, iters = (recipe[k] for k in ("b", "t", "h", "w", "classes", "iters"))
    cfg = vision_config or ClipVisionConfig.vit_b_32()  # reference student backbone
    model = StudentModel(cfg, num_classes=classes, dtype=torch.bfloat16).to(dev)
    init_parameters_(model, _generator(dev, 0)).train()
    rng = np.random.default_rng(0)
    put = lambda a: torch.from_numpy(a).to(dev)
    frames = put(rng.integers(0, 256, (b, t, h, w, 3), dtype=np.uint8))
    teacher = put(rng.normal(size=(b, t, cfg.projection_dim)).astype(np.float32))
    labels = put((rng.random((b, classes)) < 0.05).astype(np.float32))
    opt = make_adam(model.parameters(), 1e-4)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = student_loss(model, frames, teacher, labels)
        loss.backward()
        opt.step()
        return loss.detach()

    tokens = (cfg.image_size // cfg.patch_size) ** 2 + 1
    fwd = b * t * _transformer_flops(tokens, cfg.hidden_size, cfg.intermediate_size,
                                     cfg.num_layers, cross=False)
    timing, best = _train_timing(step, iters, dev, 3 * fwd, ceiling_tflops)
    return {
        "segments_per_sec": b * iters / best,
        "frames_per_sec": b * t * iters / best,
        **timing,
        "batch": b, "frames_per_segment": t, "frame_hw": f"{h}x{w}",
    }


def bench_serving(device="cuda", teacher_config=None, student_config=None,
                  tfam_config=None, classes: int = 140, frame_hw=(360, 640)) -> dict:
    """Warm single-video latency from host frames, and pooled
    ``predict_videos`` against a serial per-video loop over device-resident
    clips, through ``ViMoCLIPPredictor`` at full width on random weights
    (seeds 0, 1, 2)."""
    import torch

    from vimoclip_tpu_torch.config import TFAMModelConfig
    from vimoclip_tpu_torch.models import init_parameters_
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
    from vimoclip_tpu_torch.models.tfam import TFAM
    from vimoclip_tpu_torch.serving import ViMoCLIPPredictor
    from vimoclip_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    tcfg = teacher_config or ClipVisionConfig.vit_b_16()
    scfg = student_config or ClipVisionConfig.vit_b_32()
    fcfg = tfam_config or TFAMModelConfig()

    def state(module, seed):
        return init_parameters_(module.to(dev), _generator(dev, seed)).state_dict()

    pred = ViMoCLIPPredictor(
        teacher_state=state(ClipVisionEncoder(tcfg), 0), teacher_config=tcfg,
        student_state=state(ClipVisionEncoder(scfg), 1), student_config=scfg,
        tfam_state=state(TFAM(fcfg, num_classes=classes), 2), tfam_config=fcfg,
        num_classes=classes, frame_batch=128, length_bucket=512,
        half_precision=True, device=dev,
    )

    # a) one host video spanning several frame windows
    clip = np.tile(_make_frames(8, *frame_hw, seed=3), (57, 1, 1, 1))[:450]

    def one_video() -> None:
        rgb_emb, mot_emb = pred.embed_video(clip)
        pred.predict_embeddings(rgb_emb, mot_emb, "bench")

    one_video()  # cuBLAS set-up, kernel build, warm
    before = _launches()
    lat = _best_of(one_video, n=2)
    request_launches = {k: n / 2 for k, n in _launched_since(before).items()}
    lat_busy = _busy(one_video, 1, dev)

    # b) pooled against serial over device-resident clips
    lengths = SERVING_LENGTHS
    videos = [torch.from_numpy(_make_frames(n, *frame_hw, seed=10 + i)).to(dev)
              for i, n in enumerate(lengths)]

    def serial():
        return [pred.predict_embeddings(*pred.embed_video(v), f"v{i}")
                for i, v in enumerate(videos)]

    def pooled():
        return pred.predict_videos(videos)

    a, b = serial(), pooled()
    delta = max(float(np.max(np.abs(x.probabilities - y.probabilities)))
                for x, y in zip(a, b))
    t_serial = _best_of(serial, n=2)
    before = _launches()
    t_pooled = _best_of(pooled, n=2)
    pooled_launches = {k: n / 2 for k, n in _launched_since(before).items()}
    pooled_busy = _busy(pooled, 1, dev)
    n_frames = sum(lengths)
    return {
        "video_latency_s_450f_wall": lat,
        "video_latency_fps": 450 / lat,
        "video_latency_profiled": lat_busy,
        "serial_videos_per_s": len(lengths) / t_serial,
        "pooled_videos_per_s": len(lengths) / t_pooled,
        "pooled_speedup_vs_serial": t_serial / t_pooled,
        "pooled_frames_per_s": n_frames / t_pooled,
        "pooled_profiled": pooled_busy,
        "pooled_vs_serial_max_prob_delta": delta,
        "k1_launches_per_request": request_launches.get("fwd", 0),
        "launches_per_request": request_launches,
        "launches_per_pooled_call": pooled_launches,
        "batch_videos": len(lengths), "batch_lengths": list(lengths),
        "note": "latency from host frames (one pinned upload per window); "
                "pooled/serial over device-resident frames",
    }


# ---------------------------------------------------------------------------
# the card tests
# ---------------------------------------------------------------------------


def parse_pytest_summary(stdout: str) -> tuple[str, dict]:
    """(summary line, counts by outcome) of a ``pytest -q`` run's output,
    read as ``bench.py`` reads it."""
    import re

    lines = stdout.strip().splitlines() or [""]
    tail = next(
        (ln for ln in reversed(lines) if re.search(r"\d+ (passed|failed)", ln)),
        lines[-1],
    )
    counts = dict(
        (kind, int(n))
        for n, kind in re.findall(r"(\d+) (passed|failed|error|skipped)", tail)
    )
    return tail, counts


def bench_cuda_test(device="cuda", timeout_s: float = CUDA_TEST_TIMEOUT_S) -> dict:
    """Run the card-only tests (``tests/test_torch_cuda.py``, marker
    ``cuda``) in a subprocess and record the verdict. ``--noconftest``:
    ``tests/conftest.py`` imports JAX, which the card's machine lacks."""
    import subprocess

    import torch

    if torch.device(device).type != "cuda":
        return {"status": "skipped", "reason": f"device {str(device)!r} is not a card"}
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, *CUDA_TEST_CMD], cwd=HERE,
                              capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return {"status": "FAILED", "error": f"timed out after {timeout_s} s",
                "duration_s": time.perf_counter() - t0}
    tail, counts = parse_pytest_summary(proc.stdout)
    return {
        "status": "passed" if proc.returncode == 0 else "FAILED",
        "returncode": proc.returncode,
        "summary": tail[:200],
        "duration_s": time.perf_counter() - t0,
        **counts,
    }


# ---------------------------------------------------------------------------
# the line
# ---------------------------------------------------------------------------


def _section(failures: list, name: str, fn, *args, **kw):
    """``fn``'s result with its ``seconds`` added when it is a dict, or
    ``{"error": ...}`` with the failure noted."""
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - recorded, and the run exits 1
        failures.append(f"{name}: {type(e).__name__}: {e}")
        return {"error": f"{type(e).__name__}: {str(e)[:300]}"}
    if isinstance(out, dict):
        out["seconds"] = time.perf_counter() - t0
    return out


def run(device="cuda", extraction: dict | None = None, tfam: dict | None = None,
        student: dict | None = None, serving: dict | None = None,
        ceiling: dict | None = None, cuda_test: dict | None = None) -> tuple[dict, list]:
    """Every section on ``device`` (keyword arguments of each section
    function by name), then the line. Returns ``(line, failures)``: each
    failure one sentence, none when the run holds."""
    import torch

    from vimoclip_tpu_torch.utils.device import describe_card, resolve_device

    dev = resolve_device(device)
    failures: list[str] = []
    start = _launches()
    ceiling_tflops = _section(failures, "ceiling", measure_ceiling, dev, **(ceiling or {}))
    if isinstance(ceiling_tflops, dict):
        ceiling_tflops = None
    ext = _section(failures, "extraction", bench_extraction, dev,
                   ceiling_tflops=ceiling_tflops, **(extraction or {}))
    tfam_ = _section(failures, "tfam_train_step", bench_tfam_train, dev,
                     ceiling_tflops=ceiling_tflops, **(tfam or {}))
    student_ = _section(failures, "student_train_step", bench_student_train, dev,
                        ceiling_tflops=ceiling_tflops, **(student or {}))
    serving_ = _section(failures, "serving", bench_serving, dev, **(serving or {}))
    launches = _launched_since(start)
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the card tests' process needs the memory
    tests = _section(failures, "cuda_test", bench_cuda_test, dev, **(cuda_test or {}))
    if "error" not in tests and tests["status"] != "passed":
        why = tests.get("summary") or tests.get("reason", "")
        failures.append(f"cuda_test: {tests['status']}: {why}")
    delta = serving_.get("pooled_vs_serial_max_prob_delta")
    if delta is not None and not delta <= SERVING_DELTA_MAX:
        failures.append(f"serving: pooled vs serial probabilities differ by {delta} "
                        f"> {SERVING_DELTA_MAX}")

    fps, ref_fps = ext.get("fps"), ext.get("ref_fps")
    detail = _round({
        "baseline_ref_style_fps_same_host": ref_fps,
        "baseline": ext.get("baseline"),
        "batch": ext.get("batch"),
        "iters_per_call": ext.get("iters"),
        "dtype": "bfloat16",
        "device": describe_card(dev),
        "measured_ceiling_tflops": ceiling_tflops,
        "extraction_tflops_per_sec": ext.get("tflops_per_sec"),
        "extraction_mfu_vs_measured_ceiling": ext.get("mfu_vs_measured_ceiling"),
        "extraction_wall_ms_per_batch": ext.get("wall_ms_per_batch"),
        "extraction_profiled": {k: ext.get(k) for k in
                                ("profiled_wall_ms", "device_busy_ms", "device_idle_share")},
        "extraction_turbo_fps": ext.get("turbo_fps"),
        "extraction_turbo_speedup": ext.get("turbo_speedup"),
        "extraction_turbo_config": "token_merge_r=16 + int8"
        if ext.get("turbo_fps") else None,
        "extraction_turbo_profiled": ext.get("turbo_profiled"),
        "extraction_error": ext.get("error"),
        "extraction_seconds": ext.get("seconds"),
        "tfam_train_step": tfam_,
        "student_train_step": student_,
        "serving": serving_,
        "cuda_test": tests,
        "kernel_launches": launches,
        "note": "baseline = the reference's hot-loop structure (serial per-frame "
                "preprocessing on the host + one device forward) on this host, with "
                "the port's clip_preprocess on CPU tensors; the reference publishes no "
                "throughput numbers (BASELINE.md). MFU against this run's measured "
                "bf16 matmul ceiling, true FLOPs (2/MAC). Decode is not timed: "
                "frames are on the card before the clock starts.",
    })
    if delta is not None:  # unrounded: its limit is below _round's resolution
        detail["serving"]["pooled_vs_serial_max_prob_delta"] = delta
    line = {
        "metric": "clip_vit_b16_extraction_throughput",
        "value": round(fps, 1) if fps is not None else None,
        "unit": "frames/s/card",
        "vs_baseline": round(fps / ref_fps, 2)
        if fps is not None and np.isfinite(ref_fps) else None,
        "detail": detail,
    }
    return line, failures


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is False; the benchmark needs a "
              "CUDA card and does not run on the CPU", file=sys.stderr)
        return 2
    if not (HERE / "vimoclip_tpu_torch" / "__init__.py").is_file():
        print(f"bench_torch: no vimoclip_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    line, failures = run()
    print(json.dumps(line))
    for f in failures:
        print(f"bench_torch: FAILED {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
