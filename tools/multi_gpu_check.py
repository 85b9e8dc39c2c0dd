#!/usr/bin/env python3
"""Data, tensor, sequence and pipeline parallelism of the PyTorch/CUDA port
(``vimoclip_tpu_torch``) across the cards of one host, one process per card:

    python3 -m torch.distributed.run --standalone --nproc-per-node 4 tools/multi_gpu_check.py

1. Before the process group exists, rank 0 takes the one-card steps: the AK
   TFAM recipe of ``chip_smoke.py`` phase 6 (d_model 512, 8 heads, 4 layers,
   ff 2048, 140 classes, batch 8, dropout 0.1, bf16, ``flash``) over three
   batches of synthetic clips, and one step of the MN student recipe of
   phase 8 (ViT-B/32, batch 8, 29 224x224 motion frames, 12 classes, CE);
   the first steps' gradients, and warm step times.
2. Over NCCL, every (data, model) mesh of the world (N x 1, 2 x N/2, 1 x N)
   takes the same TFAM steps from the same weights. Rank 0 holds the first
   step's loss and gathered gradients to the one-card step (loss 1e-4,
   gradients 5e-3 rel. L2: bf16 products over other row counts and head
   splits) and reports the later losses, its kernel launches per step and
   the warm step time.
3. Sequence and pipeline parallelism at the 2048-frame bucket (eight clips,
   the longest padded to 2048): every (data, seq, pipe) layout of the world
   among seq N, data 2 x seq N/2, pipe N, data 2 x pipe N/2 and pipe 2 x
   seq N/2 takes one TFAM step from the same weights, held to the one-card
   step with the same limits: with dropout 0.1 under seq alone (its masks
   are the one-card masks), without dropout where a pipe axis draws its
   own. Rank 0 reports the warm step and every card's
   ``max_memory_allocated`` beside the one-card step's.
4. The student at data 2 x model N/2 the same way, one step.
5. After the group, rank 0 extracts 2,048 224x224 frames with ViT-B/16
   (batch 256) on 1, 2 and N replicas (``cuda:0 .. cuda:N-1``): frames/s of
   a warm pass each, rel. L2 against one replica.

Weights and data come from ``--seed``. Rank 0 prints one JSON line per part,
the cards' name and power limit, and ``{"ok": ...}`` last; the exit code is
non-zero if a check failed. ``--device cpu --tiny`` rehearses the same flow over gloo
at small widths.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

from vimoclip_tpu_torch.config import (  # noqa: E402
    DataConfig,
    ExperimentConfig,
    LoggingConfig,
    TFAMModelConfig,
    TrainingConfig,
)
from vimoclip_tpu_torch.data.embedding_dataset import collate_pad  # noqa: E402
from vimoclip_tpu_torch.data.segment_dataset import collate_segments  # noqa: E402
from vimoclip_tpu_torch.extraction import ClipExtractor  # noqa: E402
from vimoclip_tpu_torch.models import init_parameters_  # noqa: E402
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder  # noqa: E402
from vimoclip_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from vimoclip_tpu_torch.train.student_trainer import StudentTrainer  # noqa: E402
from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer  # noqa: E402
from vimoclip_tpu_torch.utils.device import describe_card  # noqa: E402

LOSS_TOL, GRAD_TOL = 1e-4, 5e-3
FULL = dict(d=512, heads=8, layers=4, ff=2048, classes=140, lengths=(60, 501), long=(1200, 1921),
            vit=ClipVisionConfig.vit_b_32(), teacher=ClipVisionConfig.vit_b_16(), hw=224,
            seq=30, frames=2048, batch=256)
TINY = dict(d=64, heads=8, layers=4, ff=128, classes=10, lengths=(5, 21), long=(20, 100),
            vit=ClipVisionConfig(image_size=32, patch_size=16, hidden_size=64, num_layers=2,
                                 num_heads=4, intermediate_size=128, projection_dim=32),
            teacher=ClipVisionConfig(image_size=32, patch_size=16, hidden_size=32,
                                     num_layers=1, num_heads=2, intermediate_size=64,
                                     projection_dim=16),
            hw=32, seq=4, frames=64, batch=16)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tfam_config(geo: dict, device: torch.device, data: int = -1, model: int = 1,
                seq: int = 1, pipe: int = 1, dropout: float = 0.1):
    return ExperimentConfig(
        training=TrainingConfig(seed=0, lr=1e-4, batch_size=8, num_workers=1,
                                device=device.type, half_precision=device.type == "cuda",
                                data_parallel=data, model_parallel=model, seq_parallel=seq,
                                pipeline_parallel=pipe),
        logging=LoggingConfig(),
        data=DataConfig(num_classes=geo["classes"], length_bucket=128, max_seq_len=2048),
        model=TFAMModelConfig(d_model=geo["d"], nhead=geo["heads"], num_layers=geo["layers"],
                              dim_feedforward=geo["ff"], dropout=dropout,
                              mlp_dropout=dropout, attention_impl="flash"))


def tfam_data(geo: dict, seed: int):
    rng = np.random.default_rng(seed)
    items = []
    for i, t in enumerate(rng.integers(*geo["lengths"], 24)):
        labels = np.zeros(geo["classes"], np.float32)
        labels[rng.choice(geo["classes"], 2, replace=False)] = 1.0
        items.append({"video_id": f"c{i}", "labels": labels,
                      "embeddings": 0.05 * rng.standard_normal((t, geo["d"])).astype(np.float32),
                      "motion_embeddings": 0.05 * rng.standard_normal(
                          (t - 1, geo["d"])).astype(np.float32)})
    batches = [{k: v for k, v in collate_pad(items[i:i + 8], bucket=128).items()
                if k != "video_id"} for i in range(0, 24, 8)]
    return items, batches


def long_batch(geo: dict, seed: int) -> dict:
    """Eight clips at the 2048-frame bucket (one clip 2008 frames long)."""
    rng = np.random.default_rng(seed + 2)
    lengths = rng.integers(*geo["long"], 8)
    lengths[3] = 2008 if geo is FULL else geo["long"][1]
    items = [{"video_id": f"l{i}", "labels": (rng.random(geo["classes"]) < 0.02).astype(
        np.float32), "embeddings": 0.05 * rng.standard_normal((t, geo["d"])).astype(np.float32),
        "motion_embeddings": 0.05 * rng.standard_normal((t - 1, geo["d"])).astype(np.float32)}
        for i, t in enumerate(lengths)]
    return {k: v for k, v in collate_pad(items, bucket=128, max_seq_len=2048).items()
            if k != "video_id"}


def student_data(geo: dict, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed + 1)
    return [{"video_id": f"s{i}",
             "rgb_emb": rng.standard_normal((geo["seq"], geo["vit"].projection_dim)).astype(
                 np.float32),
             "motion_frames": rng.integers(0, 256, (geo["seq"] - 1, geo["hw"], geo["hw"], 3),
                                           dtype=np.uint8),
             "labels": np.eye(12, dtype=np.float32)[i % 12]} for i in range(8)]


def full_grads(model, partition) -> torch.Tensor:
    """The gradient of every parameter, whole (gathered over ``model`` and
    every stage's layers over ``pipe``), flattened in the one-card order."""
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    if partition is not None:
        grads = partition.full_state(grads)
    return torch.cat([g.float().flatten() for g in grads.values()])


def warm_ms(step, device, n: int = 10, warmup: int = 3) -> float:
    times = []
    for i in range(warmup + n):
        _sync(device)
        t0 = time.perf_counter()
        step()
        _sync(device)
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    return float(np.mean(times)) * 1e3


def tfam_run(geo, device, items, batches, where: Path, data=-1, model=1, seq=1, pipe=1,
             dropout=0.1) -> dict:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    trainer = TFAMTrainer(tfam_config(geo, device, data, model, seq, pipe, dropout),
                          log_dir=str(where / "logs"), checkpoint_dir=str(where / "ck"),
                          train_dataset=items, val_dataset=items)
    losses, launches = [], []
    for i, batch in enumerate(batches):
        fa.reset_launch_counts()
        loss, _ = trainer.train_step(batch)
        losses.append(float(loss))
        launches.append(dict(fa.flash_attention.launches))
        if i == 0:
            grads = full_grads(trainer.model, trainer.partition).cpu()
    local = {k: torch.from_numpy(v).to(device) for k, v in batches[0].items()}
    out = {"losses": losses, "grads": grads, "launches": launches,
           "warm_step_ms": warm_ms(lambda: trainer.train_step(local), device, n=5)}
    if device.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    return out


def student_run(geo, device, items, where: Path, data=-1, model=1) -> dict:
    trainer = StudentTrainer(items, items, checkpoint_dir=str(where / "ck"),
                             vision_config=geo["vit"], num_classes=12, class_loss="ce",
                             lr=1e-5, batch_size=8, num_workers=1,
                             half_precision=device.type == "cuda", device=device.type,
                             data_parallel=data, model_parallel=model)
    batch = collate_segments(items)
    vals, _ = trainer.train_step(batch)
    grads = full_grads(trainer.model, trainer.partition).cpu()
    local = {k: v if isinstance(v, list) else torch.from_numpy(v).to(device)
             for k, v in batch.items()}
    return {"loss": float(vals[0]), "grads": grads,
            "warm_step_ms": warm_ms(lambda: trainer.train_step(local), device, n=5)}


def held(got: dict, ref: dict, loss_key: str = "losses") -> dict:
    first = (got[loss_key][0] if loss_key == "losses" else got[loss_key])
    want = (ref[loss_key][0] if loss_key == "losses" else ref[loss_key])
    rel = ((got["grads"] - ref["grads"]).norm() / ref["grads"].norm()).item()
    return {"first_loss_abs": abs(first - want), "grad_rel_l2": rel,
            "ok": abs(first - want) <= LOSS_TOL and rel <= GRAD_TOL}


def extraction(geo, n_cards: int, device, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed + 2)
    cfg = geo["teacher"]
    state = init_parameters_(ClipVisionEncoder(cfg), g).state_dict()
    frames = torch.randint(0, 256, (geo["frames"], geo["hw"], geo["hw"], 3), generator=g,
                           dtype=torch.uint8).numpy()
    videos = {f"v{i}": frames[i::4] for i in range(4)}

    def decode(path, chunk_size):
        for i in range(0, len(videos[path]), chunk_size):
            yield videos[path][i:i + chunk_size]

    out, ref = {}, None
    counts = sorted({1, 2, n_cards})
    for n in counts:
        devices = ([torch.device("cuda", i) for i in range(n)] if device.type == "cuda"
                   else ["cpu"] * n)
        ext = ClipExtractor(state, cfg, batch_size=geo["batch"], decode_fn=decode,
                            devices=devices, device=device)
        done = {}
        for _ in range(2):  # cold, then the timed warm pass
            _sync(device)
            t0 = time.perf_counter()
            ext.extract([(k, k) for k in videos], lambda v, e: done.__setitem__(v, e))
            _sync(device)
        seconds = time.perf_counter() - t0
        emb = np.concatenate([done[k] for k in sorted(videos)])
        ref = emb if ref is None else ref
        out[str(n)] = {"frames_per_s": len(frames) / seconds,
                       "rel_l2_vs_one": float(np.linalg.norm(emb - ref) / np.linalg.norm(ref))}
        del ext
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true", help="small widths (a CPU rehearsal)")
    ap.add_argument("--only-seq-pipe", action="store_true",
                    help="part 3 alone (with its one-card steps)")
    args = ap.parse_args()
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < world:
            print("multi_gpu_check: needs one CUDA card per rank", file=sys.stderr)
            return 2
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
    geo = TINY if args.tiny else FULL
    work = HERE / "build" / "multi_gpu_check"
    items, batches = tfam_data(geo, args.seed)
    segments = student_data(geo, args.seed)
    failed = []

    def report(part: str, payload: dict) -> None:
        if rank == 0:
            print(json.dumps({"part": part, **payload}), flush=True)

    ref = {}
    long = [long_batch(geo, args.seed)]
    every = not args.only_seq_pipe
    if rank == 0 and every:  # the one-card steps, before any process group
        ref["tfam"] = tfam_run(geo, device, items, batches, work / "one" / "tfam")
        ref["student"] = student_run(geo, device, segments, work / "one" / "student")
        report("one_card", {"tfam_losses": ref["tfam"]["losses"],
                            "tfam_warm_step_ms": ref["tfam"]["warm_step_ms"],
                            "tfam_launches": ref["tfam"]["launches"],
                            "student_loss": ref["student"]["loss"],
                            "student_warm_step_ms": ref["student"]["warm_step_ms"]})
    for drop in (0.1, 0.0) if rank == 0 else ():
        ref[f"long{drop}"] = tfam_run(geo, device, items, long, work / "one" / f"l{drop}",
                                      dropout=drop)
        report("one_card_long", {"dropout": drop, "loss": ref[f"long{drop}"]["losses"][0],
                                 "launches": ref[f"long{drop}"]["launches"],
                                 "warm_step_ms": ref[f"long{drop}"]["warm_step_ms"],
                                 "max_memory_allocated": ref[f"long{drop}"].get(
                                     "max_memory_allocated")})
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            device_id=device if device.type == "cuda" else None)
    try:
        meshes = [(world, 1), (2, world // 2), (1, world)] if world >= 4 else [(world, 1),
                                                                            (1, world)]
        for data, model in meshes if every else ():
            got = tfam_run(geo, device, items, batches, work / f"tfam_{data}x{model}",
                           data, model)
            if rank == 0:
                verdict = held(got, ref["tfam"])
                failed += [] if verdict["ok"] else [f"tfam {data}x{model}"]
                report("tfam", {"data": data, "model": model, "losses": got["losses"],
                                "launches_rank0": got["launches"],
                                "warm_step_ms": got["warm_step_ms"], **verdict})
        half = world // 2
        layouts = [(-1, world, 1), (2, half, 1), (-1, 1, world), (2, 1, half), (-1, half, 2)]
        for data, seq, pipe in layouts:
            if pipe > 1 and geo["layers"] % pipe or (data == 2 and world < 4):
                continue
            drop = 0.1 if pipe == 1 else 0.0
            got = tfam_run(geo, device, items, long, work / f"long_{data}x{seq}x{pipe}",
                           data=data, seq=seq, pipe=pipe, dropout=drop)
            mem = [None] * world
            dist.all_gather_object(mem, got.get("max_memory_allocated"))
            if rank == 0:
                verdict = held(got, ref[f"long{drop}"])
                failed += [] if verdict["ok"] else [f"tfam data {data} seq {seq} pipe {pipe}"]
                report("tfam_seq_pipe", {
                    "data": data, "seq": seq, "pipe": pipe, "dropout": drop,
                    "loss": got["losses"][0], "launches_rank0": got["launches"],
                    "warm_step_ms": got["warm_step_ms"],
                    "one_card_warm_step_ms": ref[f"long{drop}"]["warm_step_ms"],
                    "max_memory_allocated": mem,
                    "one_card_max_memory_allocated": ref[f"long{drop}"].get(
                        "max_memory_allocated"), **verdict})
        data, model = (2, world // 2) if world >= 4 else (world, 1)
        got = student_run(geo, device, segments, work / f"student_{data}x{model}", data,
                          model) if every else None
        if rank == 0 and every:
            verdict = held(got, ref["student"], "loss")
            failed += [] if verdict["ok"] else [f"student {data}x{model}"]
            report("student", {"data": data, "model": model, "loss": got["loss"],
                               "warm_step_ms": got["warm_step_ms"], **verdict})
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return 0
    if every:
        report("extract_replicas", extraction(geo, world, device, args.seed))
    cards = ([describe_card(f"cuda:{i}") for i in range(torch.cuda.device_count())]
             if device.type == "cuda" else [])
    report("device", {"cards": cards, "world": world})
    print(json.dumps({"ok": not failed, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
