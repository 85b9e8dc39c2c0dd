#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vimoclip_tpu_torch``) on one
NVIDIA card:

    python3 chip_smoke.py [--seed N]

1. Device: the card's name and count, and nvidia-smi's name and power limit.
2. Build: every CUDA kernel from ``vimoclip_tpu_torch/csrc`` with nvcc for
   sm_90a (seconds and the ``-Xptxas -v`` report).
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   card at the serving shapes, with its time, the plain version's, one
   PyTorch library call's (a yardstick the port never calls) and the bound.
4. Main path: the full-width serving cascade (ViT-B/16 teacher, ViT-B/32
   student, TFAM d512/8 heads/4 layers cross-attention, 140 classes) on
   weights drawn from ``--seed``, answering one request of three clips, with
   the kernel launch counts of that request, and checked against the same
   predictor on the eager attention path.
5. A JSON line of the kernels, then ``{"ok": true, "device": {...}}`` last.

Any failed check raises: the script exits non-zero and prints no result. It
needs a CUDA card (exits 2 without one) and the package beside it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet; dense), for the bounds.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # f32: outside the tensor cores

# Kernel vs plain: float32 sums in another order (~1e-6); bfloat16 rounds p
# at another running max and stores a bf16 output (rel. 2^-8 at |o| ~ 1).
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# flash vs eager attention through the whole bf16 cascade, on probabilities:
# the two paths round bf16 scores and weights at different points.
PATH_TOL = 1e-2

# (B, H, Tq, Tk, D): self- and cross-attention at the request's bucketed
# lengths, an unbucketed ragged key length, and T=2048 (32 key tiles).
KERNEL_SHAPES = [(3, 8, 384, 384, 64), (3, 8, 384, 256, 64),
                 (3, 8, 384, 299, 64), (3, 8, 2048, 2048, 64)]
MAIN_SHAPE = KERNEL_SHAPES[0]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls, CUDA
    events around the run (after ``warmup`` calls). When the host launches
    slower than the card runs, this is the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20) -> float:
    """Mean device busy time per call of ``fn``: the durations of every
    kernel and copy it ran on the card, from a ``torch.profiler`` trace
    (CUPTI) over ``iters`` calls after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(_device_us(e) for e in prof.key_averages())
    check(busy_us > 0, "the profiler recorded no device time")
    return busy_us / iters / 1e3


def _device_us(event) -> float:
    """Device time of a profiler entry that ran on the card (kernels,
    copies); 0 for host-side entries, whose device time would count twice."""
    from torch.autograd import DeviceType

    if event.device_type != DeviceType.CUDA:
        return 0.0
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def profile_request(torch, run, smi: str) -> dict:
    """One request under ``torch.profiler`` (host and card): wall time,
    device busy time and idle share, and the largest device and host
    entries. The profiler's own host overhead is inside this wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    top_dev = sorted(events, key=_device_us, reverse=True)[:8]
    top_host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    out = {
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "top_device_ms": [[e.key[:70], _device_us(e) / 1e3, e.count] for e in top_dev],
        "top_host_self_ms": [[e.key[:70], e.self_cpu_time_total / 1e3, e.count]
                             for e in top_host],
    }
    print("[profile] " + json.dumps(out) + f" [{smi}]")
    return out


def phase_device(torch) -> tuple[str, int, str]:
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)
    return name, count, smi


def phase_build() -> None:
    from vimoclip_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {len(built)} kernel source(s) in {time.perf_counter() - t0:.2f} s")
    for b in built.values():
        print(f"[build] {b.name}: {b.seconds:.2f} s -> {b.path.relative_to(HERE)}")
        print(b.log.strip())


def phase_kernels(torch, seed: int, smi: str) -> dict:
    import torch.nn.functional as F

    from vimoclip_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    main = None
    g = torch.Generator(device="cuda").manual_seed(seed)
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for shape in KERNEL_SHAPES:
            b, h, tq, tk, d = shape
            q = torch.randn(b, h, tq, d, device="cuda", generator=g).to(dtype)
            k = torch.randn(b, h, tk, d, device="cuda", generator=g).to(dtype)
            v = torch.randn(b, h, tk, d, device="cuda", generator=g).to(dtype)
            mask = torch.rand(b, tk, device="cuda", generator=g) < 0.25
            mask[0] = True  # one fully masked row: uniform over the real keys
            out = flash_attention(q, k, v, key_padding_mask=mask)
            ref = flash_attention_reference(q, k, v, mask)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            check(err <= KERNEL_TOL[dtype_name],
                  f"flash_attention {dtype_name} {shape}: max|d| {err} > "
                  f"{KERNEL_TOL[dtype_name]}")
            bias = torch.where(mask, -1e9, 0.0)[:, None, None, :].to(dtype)
            kernel = lambda: flash_attention(q, k, v, key_padding_mask=mask)
            plain = lambda: flash_attention_reference(q, k, v, mask)
            library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
            ms, plain_ms, library_ms = (device_ms(torch, f)
                                        for f in (kernel, plain, library))
            item = dtype.itemsize
            moved = (2 * b * h * tq * d + 2 * b * h * tk * d) * item + b * tk
            flops = 4 * b * h * tq * tk * d  # QK^T and PV
            t_bytes = moved / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
            row = {
                "dtype": dtype_name, "shape": list(shape), "max_abs_err": err,
                "tol": KERNEL_TOL[dtype_name], "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "call_ms": cuda_ms(torch, kernel),  # host launch time included
            }
            print("[kernel] flash_attention_fwd " + json.dumps(row) + f" [{smi}]")
            if dtype_name == "bfloat16" and shape == MAIN_SHAPE:
                main = row
    check(main is not None, "no measurement at the main path's shape")
    return main


def _predictor_states(torch, seed: int):
    from vimoclip_tpu_torch.config import TFAMModelConfig
    from vimoclip_tpu_torch.models import init_parameters_
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
    from vimoclip_tpu_torch.models.tfam import TFAM

    g = torch.Generator(device="cuda").manual_seed(seed)
    teacher_cfg, student_cfg = ClipVisionConfig.vit_b_16(), ClipVisionConfig.vit_b_32()
    tfam_cfg = TFAMModelConfig(d_model=512, nhead=8, num_layers=4,
                               dim_feedforward=2048, use_cross_attention=True,
                               attention_impl="flash")
    states = {
        "teacher": init_parameters_(ClipVisionEncoder(teacher_cfg), g).state_dict(),
        "student": init_parameters_(ClipVisionEncoder(student_cfg), g).state_dict(),
        "tfam": init_parameters_(TFAM(tfam_cfg, num_classes=140), g).state_dict(),
    }
    return teacher_cfg, student_cfg, tfam_cfg, states


def phase_main_path(torch, seed: int, smi: str) -> dict:
    import dataclasses

    import numpy as np

    from vimoclip_tpu_torch.ops.kernels.flash_attention import flash_attention
    from vimoclip_tpu_torch.ops.preprocess import frame_diff
    from vimoclip_tpu_torch.serving import ViMoCLIPPredictor

    teacher_cfg, student_cfg, tfam_cfg, states = _predictor_states(torch, seed)

    def predictor(cfg):
        return ViMoCLIPPredictor(
            teacher_state=states["teacher"], teacher_config=teacher_cfg,
            student_state=states["student"], student_config=student_cfg,
            tfam_state=states["tfam"], tfam_config=cfg, num_classes=140,
            frame_batch=128, length_bucket=128, max_seq_len=2048,
            half_precision=True, device="cuda")

    rng = np.random.default_rng(seed)
    videos = [rng.integers(0, 256, (t, 360, 640, 3), dtype=np.uint8)
              for t in (120, 200, 300)]
    pred = predictor(tfam_cfg)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred.predict_videos(videos)  # first request: cuBLAS/cuDNN set-up included
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3

    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    out = pred.predict_videos(videos)
    torch.cuda.synchronize()
    request_ms = (time.perf_counter() - t0) * 1e3
    launches = flash_attention.launches
    peak_bytes = torch.cuda.max_memory_allocated()

    check(launches == 8, f"flash_attention launched {launches} times, expected 8 "
                         "(4 layers x self + cross)")
    probs = np.stack([p.probabilities for p in out])
    check(probs.shape == (3, 140), f"probabilities shape {probs.shape}")
    check(bool(np.isfinite(probs).all()), "non-finite probabilities")
    check(bool(((probs >= 0) & (probs <= 1)).all()), "probabilities outside [0, 1]")

    eager = predictor(dataclasses.replace(tfam_cfg, attention_impl="xla"))
    before = flash_attention.launches
    probs_xla = np.stack([p.probabilities for p in eager.predict_videos(videos)])
    check(flash_attention.launches == before, "the eager predictor launched the kernel")
    path_err = float(np.abs(probs - probs_xla).max())
    check(path_err <= PATH_TOL, f"flash vs eager probabilities: max|d| {path_err} "
                                f"> {PATH_TOL}")

    profile_request(torch, lambda: pred.predict_videos(videos), smi)

    # one 128-frame window through each tower, preprocessing included
    frames = torch.from_numpy(videos[2][:129]).cuda()
    with torch.inference_mode():
        diffs = frame_diff(frames)
        teacher_ms = cuda_ms(torch, lambda: pred._teacher_embed(frames[:128]),
                             iters=5, warmup=1)
        student_ms = cuda_ms(torch, lambda: pred._student_embed(diffs),
                             iters=5, warmup=1)
    stats = {
        "request_ms": request_ms, "cold_request_ms": cold_ms,
        "frames": sum(len(v) for v in videos), "flash_launches": launches,
        "teacher_frames_per_s": 128 / teacher_ms * 1e3,
        "student_frames_per_s": 128 / student_ms * 1e3,
        "peak_mem_bytes": peak_bytes, "flash_vs_eager_max_abs": path_err,
        "top1": [p.top_classes[0][0] for p in out],
    }
    print("[main] " + json.dumps(stats) + f" [{smi}]")
    return stats


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (HERE / "vimoclip_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no vimoclip_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import vimoclip_tpu_torch

    check(Path(vimoclip_tpu_torch.__file__).resolve().parent.parent == HERE,
          f"imported {vimoclip_tpu_torch.__file__}, not the package beside the script")
    # state both precisions: float32 products in full float32 everywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name, count, smi = phase_device(torch)
    phase_build()
    k1 = phase_kernels(torch, args.seed, smi)
    stats = phase_main_path(torch, args.seed, smi)
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "vimoclip_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "vimoclip_tpu/ops/pallas/flash_attention.py:113",
        "launches": stats["flash_launches"], "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
