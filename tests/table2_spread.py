#!/usr/bin/env python
"""Where the port's Table-2 toy sweep parts from the JAX package's: both
stacks on the CPU, one JSON file of best val mAPs.

- ``teacher``: the port's 21-config grid (``run_table2_sweep_torch.run_sweep``)
  over the files route given JAX's tiny-teacher weights, with the RGB
  stream extracted in bf16 (as JAX's corpus) and in float32: with the
  teacher and the precision both JAX's, what differs from ``SWEEP.json``
  is stage-2 training alone.
- ``corpus``: the port's files route given JAX's teacher against JAX's
  corpus, both at their defaults (RGB in bf16), one video per class in
  both corpus kinds: the largest relative L2 per file.
- ``seeds``: the cross (``config_default.yaml``) and rgb-only
  (``config_7.yaml``) configs of both stacks over JAX's own corpus files
  (``tools/run_table2_sweep.py::build_corpus``), at training seeds 49
  (the grid's) to 53: how far one stack's result moves with its seed.

A helper of the tests (it imports both stacks), not collected by pytest.

Usage:
    JAX_PLATFORMS=cpu python tests/table2_spread.py --out build/table2_spread.json
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEEDS = range(49, 54)
CONFIGS = {"cross": 0, "rgb": 7}  # REFERENCE_GRID indices


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_teacher(sweep):
    import jax
    import jax.numpy as jnp

    from vimoclip_tpu.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
    from vimoclip_tpu_torch.models.convert import clip_vision_state_from_jax

    vcfg = ClipVisionConfig(image_size=32, patch_size=8, hidden_size=32, num_layers=1,
                            num_heads=2, intermediate_size=64, projection_dim=24)
    params = ClipVisionEncoder(vcfg).init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    return clip_vision_state_from_jax(params, sweep.tiny_teacher(24)[0], prefix="")


def teacher_variants(sweep, work: str) -> dict:
    out = {}
    for name, half in (("bf16", True), ("float32", False)):
        art = sweep.run_sweep(os.path.join(work, f"teacher_{name}"), 0, device="cpu",
                              teacher_state=_jax_teacher(sweep), rgb_half_precision=half)
        best = {r["config"]: r["best_val_mAP"] for r in art["results"]}
        out[name] = {"configs_ok": art["configs_ok"], "wall_s": art["wall_s"],
                     "modes": {m: best[c] for m, c in sweep.MODE_CONFIGS.items()},
                     "ordering": art["mode_ordering"]["torch"]}
        print(f"teacher {name}: {out[name]}", flush=True)
    return out


def corpus_agreement(sweep, jax_sweep, work: str) -> dict:
    import h5py
    import numpy as np

    def read(path):
        with h5py.File(path, "r") as f:
            return {k: g["embeddings"][:] for k, g in f.items() if isinstance(g, h5py.Group)}

    out = {}
    for order_only in (False, True):
        kw = dict(seed=0, videos_per_class=1, val_videos_per_class=1, order_only=order_only)
        tag = "order" if order_only else "flicker"
        theirs = jax_sweep.build_corpus(os.path.join(work, f"jax_{tag}"), **kw)
        ours = sweep.build_corpus(os.path.join(work, f"torch_{tag}"), device="cpu",
                                  teacher_state=_jax_teacher(sweep), **kw)
        for jp, tp in zip(theirs, ours):
            if jp.endswith(".h5"):
                want, got = read(jp), read(tp)
                out[f"{tag}/{os.path.basename(jp)}"] = max(
                    float(np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k]))
                    for k in want)
    print(f"corpus: {out}", flush=True)
    return out


def seed_spread(sweep, jax_sweep, work: str) -> dict:
    import vimoclip_tpu.cli.run_experiments as jax_rx
    import vimoclip_tpu_torch.cli.run_experiments as torch_rx

    corpus = os.path.join(work, "jax_corpus")
    os.makedirs(corpus)
    rgb_h5, motion_h5, classes = jax_sweep.build_corpus(corpus, seed=0)
    data = {"num_classes": 6, "class_names_dir": classes, "train_dataset_path": rgb_h5,
            "val_dataset_path": rgb_h5, "frame_diff_dataset_path": motion_h5,
            "length_bucket": 8}
    stacks = {"jax": (jax_rx, jax_sweep.TINY_BASE_OVERRIDES),
              "torch": (torch_rx, {"training": dict(sweep.TINY_BASE_OVERRIDES["training"],
                                                    device="cpu"),
                                   "model": sweep.TINY_BASE_OVERRIDES["model"]})}
    out = {}
    cwd = os.getcwd()
    for stack, (rx, base) in stacks.items():
        grid = rx.REFERENCE_GRID
        out[stack] = {m: {} for m in CONFIGS}
        for seed in SEEDS:
            overrides = copy.deepcopy(base)
            overrides["training"]["seed"] = seed
            cfg_dir = tempfile.mkdtemp(dir=work)
            rx.REFERENCE_GRID = [grid[i] for i in CONFIGS.values()]
            try:
                rx.generate(cfg_dir, data_overrides=data, base_overrides=overrides)
                os.chdir(cfg_dir)
                results = rx.run(cfg_dir, os.path.join(cfg_dir, "results.json"))
            finally:
                rx.REFERENCE_GRID = grid
                os.chdir(cwd)
            # the two-entry grid writes config_default.yaml and config_1.yaml
            names = dict(zip(("config_default.yaml", "config_1.yaml"), CONFIGS))
            for r in results:
                out[stack][names[r["config"]]][seed] = r["best_val_mAP"]
            print(f"seed {stack} {seed}: " + json.dumps(
                {m: out[stack][m][seed] for m in CONFIGS}), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--parts", default="corpus,teacher,seeds",
                   help="the parts to run; their results replace those in --out")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(ROOT))
    sweep = _tool("run_table2_sweep_torch")
    jax_sweep = _tool("run_table2_sweep")
    from vimoclip_tpu_torch.utils.logging import setup_logging

    setup_logging()
    work = tempfile.mkdtemp(prefix="table2_spread_")
    parts = args.parts.split(",")
    out = {"jax_record": "SWEEP.json (seed 49)"}
    if os.path.exists(args.out):
        with open(args.out) as f:
            out = json.load(f) | out
    if "corpus" in parts:
        out["corpus_rel_l2"] = corpus_agreement(sweep, jax_sweep, work)
    if "teacher" in parts:
        out["teacher"] = teacher_variants(sweep, work)
    if "seeds" in parts:
        out["seeds"] = seed_spread(sweep, jax_sweep, work)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
