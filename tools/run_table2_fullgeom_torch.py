#!/usr/bin/env python
"""The Table-2 fusion-mode contrast at the flagship geometry, on the
PyTorch port and one NVIDIA card: TFAM d512 / 8 heads / 4 layers / ff 2048
with the reference's dropout-0.1 / AdamW / per-epoch-cosine recipe, trained
for cross-attention, temporal concat, rgb-only and flow-only on the
order-only two-factor corpus with a disjoint val split, and the paper's
ordering checked on the best val mAPs (BASELINE.md: cross 77.09 /
concat_t 76.99 >= rgb 75.83 >> flow 51.05).

The port's copy of ``tools/run_table2_fullgeom.py``, with its geometry,
recipe, corpus, modes, ``ordering_ok`` rule, preemption and exit codes,
``--modes`` subsets and artifact keys. It adds the card's name and power
limit (``device``) and the corpus route.

Training goes through the port's ``TFAMTrainer`` on ``cuda`` with the
default ``attention_impl: auto`` and JAX's ``half_precision: False``: the
8-12-frame clips pad to the 16-frame bucket and train with dropout 0.1, so
every train step runs the float32 attention kernels K1' and K2 at
(8, 8, 16, 16, 64), one of each per attention site and layer (8 + 8 a step
in cross mode); evaluation without dropout at 16 keys runs eager under
``auto``. ``--attention-impl flash`` sends evaluation through K1 as well.

The corpus (``tools/run_table2_sweep_torch.py``) comes by the memory route
by default, which needs no OpenCV or h5py (the card's machine has
neither); ``--corpus files`` builds the files route's HDF5 files on the
CPU (reused from ``--work-dir`` when present) and trains from them. Both
extract the RGB stream in bf16, as JAX's corpus does.

Each run starts in a fresh temporary directory unless ``--work-dir`` names
one; ``--resume`` continues the arms found there (a preempted arm from its
checkpoint, a finished arm from its recorded best).

Usage:
    python tools/run_table2_fullgeom_torch.py --out SWEEP_FULLGEOM_TORCH.json
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tools"))

# the flagship geometry: reference cfg_AK/config_default.yaml + AMO_CLIP.py
GEOMETRY = {"d_model": 512, "nhead": 8, "num_layers": 4,
            "dim_feedforward": 2048, "dropout": 0.1, "mlp_dropout": 0.1}
RECIPE = {"epochs": 30, "batch_size": 8, "lr": 1e-4, "weight_decay": 0.1,
          "eta_min": 1e-6, "seed": 49}
CORPUS = {"videos_per_class": 48, "val_videos_per_class": 16,
          "projection_dim": 512, "order_only": True}
# every clip pads to one 16-frame bucket
LENGTH_BUCKET = 16

# fusion modes -> TFAMModelConfig flags (cli/run_experiments.py mapping)
MODES = {
    "cross": {"use_cross_attention": True},
    "concat_t": {"use_cross_attention": False, "concat_dim": 1},
    "rgb": {"use_only_rgb": True},
    "flow": {"use_only_flow": True},
}


def ordering_ok(by: dict) -> bool:
    """The paper's direction (JAX's rule): cross >= rgb + 0.05, rgb >= flow
    + 0.15, and concat_t (when run) >= rgb."""
    return bool(by["cross"] >= by["rgb"] + 0.05
                and by["rgb"] >= by["flow"] + 0.15
                and by.get("concat_t", by["rgb"]) >= by["rgb"] - 1e-9)


def corpus(route: str, work: str, seed: int, device: str) -> tuple:
    """(train, val) datasets of the corpus by ``route``: the memory route's
    item lists on ``device``, or the files route's HDF5 files (built on
    the CPU into ``work`` unless there) as ``PairedEmbeddingDataset``s."""
    import run_table2_sweep_torch as sweep

    if route == "memory":
        return sweep.corpus_items(seed, device=device, **CORPUS)
    from vimoclip_tpu_torch.data.embedding_dataset import PairedEmbeddingDataset

    paths = [os.path.join(work, n) for n in ("rgb.h5", "motion.h5", "classes.csv",
                                             "rgb_val.h5")]
    if os.path.exists(paths[3]):
        print(f"corpus: reusing {work}", flush=True)
    else:
        os.makedirs(work, exist_ok=True)
        paths = sweep.build_corpus(work, seed=seed, device="cpu", **CORPUS)
    rgb, motion, _, val = paths
    return PairedEmbeddingDataset(rgb, motion), PairedEmbeddingDataset(val, motion)


def make_trainer(mode: str, items: tuple, run_dir: str, device: str,
                 epochs: int = RECIPE["epochs"], *, attention_impl: str = "auto",
                 resume: bool = False):
    """The port's ``TFAMTrainer`` for one fusion mode at the flagship
    geometry and recipe, float32, on ``items`` = (train, val); ``resume``
    continues from the newest checkpoint under ``run_dir``."""
    from vimoclip_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        LoggingConfig,
        TFAMModelConfig,
        TrainingConfig,
    )
    from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer

    cfg = ExperimentConfig(
        training=TrainingConfig(
            # a resume reads only the newest step checkpoint, so older ones
            # are not kept
            mode="train", num_workers=2, half_precision=False, resume=resume,
            keep_checkpoints=1,
            device=device, **(RECIPE | {"epochs": epochs})),
        logging=LoggingConfig(),
        data=DataConfig(num_classes=6, length_bucket=LENGTH_BUCKET),
        model=TFAMModelConfig(**GEOMETRY, **MODES[mode], attention_impl=attention_impl),
    )
    return TFAMTrainer(cfg, log_dir=os.path.join(run_dir, mode, "logs"),
                       checkpoint_dir=os.path.join(run_dir, mode, "ckpt"),
                       train_dataset=items[0], val_dataset=items[1])


def run_mode(mode: str, items: tuple, run_dir: str, device: str,
             epochs: int = RECIPE["epochs"], **trainer_kw) -> dict:
    """Train one fusion mode (``make_trainer``, given ``trainer_kw``) and
    report its best val mAP, wall time, train steps and per-epoch history."""
    t0 = time.time()
    trainer = make_trainer(mode, items, run_dir, device, epochs, **trainer_kw)
    best_val_map = float(trainer.train())
    res = {
        "mode": mode,
        # preempted before the first validation -> -inf, which json.dump
        # would write as non-RFC -Infinity
        "best_val_mAP": round(best_val_map, 4) if math.isfinite(best_val_map) else None,
        "wall_s": round(time.time() - t0, 1),
        "train_steps": int(trainer.state.step),
        "device": device,
        "history": [{k: (round(v, 5) if isinstance(v, float) else v) for k, v in h.items()}
                    for h in trainer.history],
    }
    if trainer.preempted:
        res["status"] = "preempted"
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="SWEEP_FULLGEOM_TORCH.json")
    p.add_argument("--work-dir", default="",
                   help="working directory (default: a fresh temporary directory)")
    p.add_argument("--resume", action="store_true",
                   help="continue the arms found in --work-dir")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--modes", default=",".join(MODES))
    p.add_argument("--device", default="cuda")
    p.add_argument("--corpus", choices=["memory", "files"], default="memory")
    p.add_argument("--attention-impl", choices=["auto", "flash", "xla"], default="auto")
    args = p.parse_args(argv)
    if args.resume and not args.work_dir:
        p.error("--resume needs the --work-dir of the run it continues")

    import torch

    from vimoclip_tpu_torch.utils.device import describe_card, resolve_device
    from vimoclip_tpu_torch.utils.logging import setup_logging

    resolve_device(args.device)  # no card: raise before any work
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    setup_logging(log_file=None)
    work = os.path.abspath(args.work_dir or tempfile.mkdtemp(prefix="table2_fullgeom_torch_"))
    t0 = time.time()
    items = corpus(args.corpus, work, args.seed, args.device)
    corpus_s = time.time() - t0
    print(f"corpus ({args.corpus} route): {len(items[0])} train, {len(items[1])} val "
          f"clips in {corpus_s:.1f} s", flush=True)
    run_dir = os.path.join(work, "runs")
    results = []
    preempted = False
    for mode in args.modes.split(","):
        res = run_mode(mode, items, run_dir, args.device,
                       attention_impl=args.attention_impl, resume=args.resume)
        results.append(res)
        print(json.dumps({k: v for k, v in res.items() if k != "history"}), flush=True)
        if res.get("status") == "preempted":
            # SIGTERM mid-arm: the trainer checkpointed, but the grace
            # deadline is ticking: write the partial artifact and stop;
            # a rerun with --resume continues this arm from its checkpoint
            preempted = True
            print(f"preempted during '{mode}': stopping sweep; continue with "
                  f"--work-dir {work} --resume", flush=True)
            break

    by = {r["mode"]: r["best_val_mAP"] for r in results}
    ok = None
    if not preempted and set(by) >= {"cross", "rgb", "flow"}:
        ok = ordering_ok(by)
    artifact = {
        "sweep": "Table-2 fusion-mode contrast at full flagship geometry on the PyTorch "
                 "port (AMO_CLIP.py:6-51; paper ordering per BASELINE.md)",
        "corpus": {"kind": "two-factor cascade, disjoint val textures",
                   "route": args.corpus, "build_s": round(corpus_s, 1),
                   "rgb_extraction": "bf16", **CORPUS},
        "geometry": GEOMETRY,
        "recipe": RECIPE,
        "attention_impl": args.attention_impl,
        "device": describe_card(args.device),
        "results": results,
        "best_val_mAP": by,
        "ordering_ok": ok,
        "preempted": preempted,
        "wall_s": round(time.time() - t0, 1),
    }
    with open(os.path.abspath(args.out), "w") as f:
        json.dump(artifact, f, indent=2)
    print(f"fullgeom sweep -> {args.out}; ordering_ok={ok} ({by})")
    # 1 only for an evaluated ordering failure or a preempted partial run;
    # a --modes subset (ordering_ok None, not evaluated) is a success
    if preempted:
        return 1
    return 0 if ok is not False else 1


if __name__ == "__main__":
    sys.exit(main())
