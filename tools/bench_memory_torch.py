#!/usr/bin/env python
"""Peak device memory of the stage-1 student train step on one NVIDIA card,
dense against gradient accumulation, on the PyTorch port; written to
MEMBENCH_TORCH.json.

The port's copy of ``tools/bench_memory.py``: the ``StudentTrainer`` step at
the reference's batch 32 (train.py:183) and its recipe shape (29 motion
frames of 360x640 uint8, ViT-B/32, bf16, 140 classes), dense against
``grad_accum`` 4, and a batch B that runs the card out of memory dense but
trains accumulated. PyTorch allocates at run time, so the reading is the
caching allocator's peak, ``torch.cuda.max_memory_allocated()``, over two
executed steps (weights, Adam state, the batch on the card and the step's
activations), where JAX read XLA's static buffer assignment.

Segments are synthetic and in memory (the card's machine has no OpenCV or
h5py to write and read videos and HDF5 files): one batch of random frames
and teacher embeddings from a seed, collated by the trainer's own loader.

Each arm runs in a fresh subprocess, so every arm starts from an empty
allocator. An arm that runs out of memory reports ``"status": "oom"``.

Arms are ``batch:grad_accum``. ``B`` stands for the smallest multiple of 32
that runs the card out dense: it is reckoned from the 32:1 and 32:4 peaks
(a straight line in the batch through both), then measured, moving by 32
until the dense arm at B runs out and the one at B - 32 does not; ``n``
accumulates B in microbatches of 8, as 32:4 does.

Usage:
    python tools/bench_memory_torch.py --out MEMBENCH_TORCH.json
    python tools/bench_memory_torch.py --arms 32:1,32:4   # a subset: merged
    # into an existing --out artifact, its other arms kept
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

# the reference stage-1 recipe shape: 29 motion frames (a 30-frame teacher
# window minus one, train.py:98) at the AK videos' 360x640
T_MOTION, HEIGHT, WIDTH = 29, 360, 640
EMBED_DIM, NUM_CLASSES = 512, 140
MICROBATCH = 8  # rows per accumulation step of the B arm, as 32:4
STEP = 32  # B is a multiple of this
DEFAULT_ARMS = "32:1,32:4,B:1,B:n"
ARM_TIMEOUT_S = 900


def segments(batch_size: int, seed: int = 0) -> list[dict]:
    """``batch_size`` synthetic stage-1 segments at the recipe shape."""
    import numpy as np

    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (batch_size, T_MOTION, HEIGHT, WIDTH, 3), dtype=np.uint8)
    rgb = rng.standard_normal((batch_size, T_MOTION + 1, EMBED_DIM)).astype(np.float32)
    labels = np.eye(NUM_CLASSES, dtype=np.float32)[rng.integers(0, NUM_CLASSES, batch_size)]
    return [{"video_id": f"seg{i:03d}", "motion_frames": frames[i], "rgb_emb": rgb[i],
             "labels": labels[i]} for i in range(batch_size)]


def arm(batch_size: int, accum: int, device: str = "cuda") -> dict:
    """One arm in this process: the shipped ``StudentTrainer`` at the
    recipe shape takes two steps on one batch; the peak of
    ``max_memory_allocated`` on a card (not measured on the CPU), or
    ``status: oom`` when the card runs out."""
    import numpy as np
    import torch

    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig
    from vimoclip_tpu_torch.train.student_trainer import StudentTrainer
    from vimoclip_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    items = segments(batch_size)
    rec = {"batch_size": batch_size, "grad_accum": accum,
           "shape": [batch_size, T_MOTION, HEIGHT, WIDTH, 3], "device": str(dev)}
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        trainer = StudentTrainer(
            items, items, checkpoint_dir=tempfile.mkdtemp(prefix="membench_torch_"),
            vision_config=ClipVisionConfig.vit_b_32(), num_classes=NUM_CLASSES,
            batch_size=batch_size, grad_accum=accum, half_precision=True, num_workers=1,
            epochs=1, device=dev)
        batch = trainer.train_loader.collate(items)
        del items
        t0 = time.perf_counter()
        losses = []
        for _ in range(2):
            vals, _ = trainer.train_step(batch)
            losses.append(float(vals[0]))  # waits for the step
        rec["wall_s_2steps"] = round(time.perf_counter() - t0, 2)
        rec["total_loss"] = losses
        if not np.all(np.isfinite(losses)):
            raise RuntimeError(f"non-finite loss {losses}")
        rec["status"] = "ok"
    except torch.cuda.OutOfMemoryError as e:
        rec.update(status="oom", oom_evidence=str(e)[:600])
    if on_card:
        rec["peak_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
        rec["peak_allocated_gib"] = round(rec["peak_allocated_bytes"] / 2**30, 3)
        rec["card_total_bytes"] = torch.cuda.mem_get_info(dev)[1]
    return rec


def run_arm(batch_size: int, accum: int, device: str) -> dict:
    """``arm`` in a fresh subprocess; a crash or a timeout is recorded."""
    fd, out = tempfile.mkstemp(prefix="membench_arm_", suffix=".json")
    os.close(fd)
    print(f"== arm batch={batch_size} grad_accum={accum}", flush=True)
    try:
        rc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--phase", "arm", "--batch-size",
             str(batch_size), "--grad-accum", str(accum), "--arm-out", out,
             "--device", device], timeout=ARM_TIMEOUT_S).returncode
        if rc == 0:
            with open(out) as f:
                return json.load(f)
    except subprocess.TimeoutExpired:
        rc = f"timeout after {ARM_TIMEOUT_S}s"
    finally:
        os.unlink(out)
    return {"batch_size": batch_size, "grad_accum": accum, "status": f"failed rc={rc}"}


def reckon_b(dense32: dict, accum32: dict) -> int:
    """The first multiple of ``STEP`` whose dense peak passes the card's
    memory on the line through the 32:1 and 32:4 peaks (32 and 8 rows of
    activations; the batch on the card and the optimizer state in both)."""
    per_row = (dense32["peak_allocated_bytes"] - accum32["peak_allocated_bytes"]) / (32 - 8)
    fixed = dense32["peak_allocated_bytes"] - 32 * per_row
    total = dense32["card_total_bytes"]
    rows = (total - fixed) / max(per_row, 1.0)
    return max(2 * STEP, STEP * (int(rows) // STEP + 1))


def find_b(measure, start: int) -> int:
    """The smallest multiple of ``STEP`` from ``start`` on, moving by one
    step, whose dense arm runs out of memory while the one below does not.
    ``measure(b)`` runs the dense arm at b and returns its record."""
    b = start
    ran = {}
    for _ in range(6):
        ran[b] = measure(b)["status"] == "oom"
        if ran[b] and ran.get(b - STEP) is False:
            return b
        if ran[b]:
            if b - STEP <= STEP:
                return b
            b -= STEP
        else:
            b += STEP
            if ran.get(b):
                return b
    raise RuntimeError(f"no out-of-memory batch bracketed from {start}: {ran}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="MEMBENCH_TORCH.json")
    p.add_argument("--arms", default=DEFAULT_ARMS)
    p.add_argument("--device", default="cuda")
    p.add_argument("--phase", choices=["all", "arm"], default="all")
    p.add_argument("--batch-size", type=int)
    p.add_argument("--grad-accum", type=int)
    p.add_argument("--arm-out")
    args = p.parse_args(argv)

    if args.phase == "arm":
        rec = arm(args.batch_size, args.grad_accum, args.device)
        with open(args.arm_out, "w") as f:
            json.dump(rec, f)
        print(json.dumps(rec), flush=True)
        return 0

    from vimoclip_tpu_torch.utils.device import describe_card, resolve_device

    resolve_device(args.device)  # no card: raise before any arm
    # a subset re-measures its arms and keeps the file's others
    prior: dict[tuple[int, int], dict] = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            prior = {(r["batch_size"], r["grad_accum"]): r for r in json.load(f)["results"]}

    def measure(b: int, n: int) -> dict:
        prior[b, n] = run_arm(b, n, args.device)  # the arm prints its record
        return prior[b, n]

    b = None
    for spec in args.arms.split(","):
        size, accum = spec.split(":")
        if size == "B":
            if b is None:
                start = reckon_b(prior[32, 1], prior[32, 4])
                print(f"B reckoned from the 32:1 and 32:4 peaks: {start}", flush=True)
                b = find_b(lambda x: measure(x, 1), start)
            size = b
            if accum == "1":
                continue  # measured while finding B
        size = int(size)
        measure(size, size // MICROBATCH if accum == "n" else int(accum))

    artifact = {
        "bench": "stage-1 student train-step peak device memory (max_memory_allocated), "
                 "dense vs grad_accum (ViT-B/32 bf16, 29 frames @ 360x640, 140 classes: "
                 "reference train.py:183 recipe shape) on the PyTorch port",
        "device": describe_card(args.device),
        "results": [prior[k] for k in sorted(prior)],
    }
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(json.dumps(artifact, indent=2))
    bad = [r for r in artifact["results"] if r["status"] not in ("ok", "oom")]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
