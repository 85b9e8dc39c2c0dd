"""Motion-modality and device benchmark (the port's copy of
``vimoclip_tpu/cli/benchmark.py``; the reference's
``utils/video_benchmark_raft.py``).

    python -m vimoclip_tpu_torch.cli.benchmark [--videos-dir DIR] [--seed N]

- With ``--videos-dir``: motion generators (frame difference on the card,
  Farnebäck, or a ptlflow model with ``--flow-backend raft``) on N sample
  videos: wall time, frames/s, host-RSS peak, peak CUDA memory and output
  statistics.
- Unless ``--skip-gpu``: the card's rate for the ViT-B/16 extraction
  forward (preprocessing included) on 360x640 uint8 frames, and for the
  TFAM forward on 8 clips of 450 frames, both bf16 on weights drawn from
  ``--seed``, timed with CUDA events after a warm-up call.

Every report names the device it ran on. A JSON report and a console table.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import time

import numpy as np
import torch

from vimoclip_tpu_torch.utils.logging import setup_logging
from vimoclip_tpu_torch.utils.profiling import MemoryMonitor, device_memory_stats


def _torch_cuda_peak_tracker():
    """(reset_fn, peak_mb_fn) over ``torch.cuda.max_memory_allocated``;
    both do nothing without a card."""
    if torch.cuda.is_available():
        return torch.cuda.reset_peak_memory_stats, (
            lambda: torch.cuda.max_memory_allocated() / 1e6)
    return (lambda: None), (lambda: None)


def _bench_motion(videos: list[str], kind: str, tmp_dir: str, flow_fn=None,
                  device: str = "cuda") -> dict:
    """One arm. ``kind``: 'frame_diff' (on ``device``) | 'flow' (Farnebäck)
    | 'raft' (any ptlflow-interface backend passed as ``flow_fn``)."""
    import functools

    from vimoclip_tpu_torch.data.video_reader import read_video
    from vimoclip_tpu_torch.motion import (
        farneback_flow,
        generate_frame_diff_video,
        generate_optical_flow_video,
    )

    if kind == "frame_diff":
        gen = functools.partial(generate_frame_diff_video, device=device)
    else:
        gen = functools.partial(generate_optical_flow_video,
                                flow_fn=flow_fn or farneback_flow)
    reset_peak, peak_mb = _torch_cuda_peak_tracker()
    reset_peak()
    frames_total, t_total, stats = 0, 0.0, []
    with MemoryMonitor() as mem:
        for i, src in enumerate(videos):
            dst = os.path.join(tmp_dir, f"{kind}_{i}.mp4")
            t0 = time.perf_counter()
            n = gen(src, dst)
            t_total += time.perf_counter() - t0
            frames_total += n
            out = read_video(dst, max_frames=16).astype(np.float32)
            stats.append({"mean": float(out.mean()), "std": float(out.std()),
                          "nonzero_frac": float((out > 8).mean())})
    device_peak = peak_mb()
    return {
        "kind": kind,
        "videos": len(videos),
        "frames": frames_total,
        "wall_s": round(t_total, 3),
        "fps": round(frames_total / t_total, 1) if t_total else None,
        "peak_rss_mb": round(mem.peak_mb, 1),
        "peak_device_mb": round(device_peak, 1) if device_peak else None,
        "output_stats": {
            k: round(float(np.mean([s[k] for s in stats])), 4) for k in stats[0]
        } if stats else {},
    }


def _timed_ms(fn, iters: int, device: torch.device) -> float:
    """Milliseconds for ``iters`` calls of ``fn`` after one warm-up call:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end)


@torch.inference_mode()
def _bench_gpu(batch: int = 128, iters: int = 4, seed: int = 0,
               device: str | torch.device = "cuda", vision_config=None,
               tfam_config=None, frame_hw: tuple[int, int] = (360, 640),
               clips: tuple[int, int] = (8, 450)) -> dict:
    """Frames/s of the extraction forward (``clip_preprocess`` + the CLIP
    tower, ViT-B/16 by default) on ``batch`` uint8 frames of ``frame_hw``,
    and clips/s of the TFAM forward (d512, 8 heads, 4 layers by default) on
    ``clips`` = (B, T) random embeddings, both bf16 on weights drawn from
    ``seed``. ``device`` is the card unless the caller asks for the CPU."""
    from vimoclip_tpu_torch.config import TFAMModelConfig
    from vimoclip_tpu_torch.models import init_parameters_
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
    from vimoclip_tpu_torch.models.tfam import TFAM
    from vimoclip_tpu_torch.ops.preprocess import clip_preprocess
    from vimoclip_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    dtype = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "batch": batch, "iters": iters}

    cfg = vision_config or ClipVisionConfig.vit_b_16()
    enc = init_parameters_(ClipVisionEncoder(cfg, dtype=dtype).to(dev), g).eval()
    frames = torch.randint(0, 256, (batch, *frame_hw, 3), dtype=torch.uint8,
                           device=dev, generator=g)
    ms = _timed_ms(lambda: enc(clip_preprocess(frames, cfg.image_size, dtype=dtype)),
                   iters, dev)
    out["extract_frames_per_s"] = batch * iters / ms * 1e3

    tcfg = tfam_config or TFAMModelConfig(dropout=0.0, mlp_dropout=0.0)
    model = init_parameters_(TFAM(tcfg, num_classes=140, dtype=dtype).to(dev), g).eval()
    b, t = clips
    rgb = torch.randn(b, t, tcfg.d_model, device=dev, generator=g)
    mot = torch.randn(b, t - 1, tcfg.d_model, device=dev, generator=g)
    mr = torch.ones(b, t, dtype=torch.bool, device=dev)
    mf = torch.ones(b, t - 1, dtype=torch.bool, device=dev)
    ms = _timed_ms(lambda: model(rgb, mot, mr, mf), iters, dev)
    out["tfam_clips_per_s"] = b * iters / ms * 1e3
    out["device_memory"] = device_memory_stats()
    return out


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="ViMoCLIP pipeline benchmark "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--videos-dir", default=None,
                   help="sample RGB videos for the motion-generator benchmark")
    p.add_argument("--num-videos", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--skip-gpu", action="store_true")
    p.add_argument("--skip-flow", action="store_true",
                   help="skip the (slow) optical-flow arm")
    p.add_argument("--flow-backend", choices=["farneback", "raft"], default="farneback",
                   help="optical-flow arm: in-repo Farneback, or any "
                        "ptlflow-interface model")
    p.add_argument("--flow-weights", default=None,
                   help="raft backend: ptlflow ckpt name/path, or a serialized "
                        "torch module file when ptlflow is absent")
    p.add_argument("--flow-model", default="raft",
                   help="ptlflow architecture name (raft, gma, ...)")
    p.add_argument("--flow-device", default="cuda",
                   help="torch device for the learned flow backend")
    p.add_argument("--output", default="benchmark_results.json")
    args = p.parse_args(argv)

    setup_logging(log_file=None)
    report: dict = {"timestamp": time.strftime("%Y-%m-%d %H:%M:%S")}

    if args.videos_dir:
        import glob as g
        import tempfile

        videos = sorted(g.glob(os.path.join(args.videos_dir, "*.mp4")))
        random.Random(args.seed).shuffle(videos)
        videos = videos[: args.num_videos]
        tmp = tempfile.mkdtemp(prefix="vimo_bench_")
        report["frame_diff"] = _bench_motion(videos, "frame_diff", tmp)
        if not args.skip_flow:
            if args.flow_backend == "raft":
                from vimoclip_tpu_torch.motion import load_flow_backend

                flow_fn = load_flow_backend("raft", weights=args.flow_weights,
                                            model_name=args.flow_model,
                                            device=args.flow_device)
                report["raft"] = _bench_motion(videos, "raft", tmp, flow_fn)
            else:
                report["optical_flow"] = _bench_motion(videos, "flow", tmp)

    if not args.skip_gpu:
        report["gpu"] = _bench_gpu(args.batch, args.iters, args.seed)

    with open(args.output, "w") as f:
        json.dump(report, f, indent=2)
    try:
        from tabulate import tabulate

        rows = []
        for k, v in report.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    if isinstance(vv, (int, float, str)):
                        rows.append([k, kk, vv])
        print(tabulate(rows, headers=["section", "metric", "value"], tablefmt="pretty"))
    except ImportError:
        print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
