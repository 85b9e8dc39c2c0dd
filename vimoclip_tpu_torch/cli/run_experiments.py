"""Sweep harness: generate and run the TFAM ablation grid (the port's copy
of ``vimoclip_tpu/cli/run_experiments.py``).

The reference reproduces its Table 2 with 21 hand-written YAMLs run one
after another by a shell script (TFAM/cfg_AK/config_*.yaml,
TFAM/run_experiments.sh). Here the grid is generated: ``generate`` writes
the 21 YAML files (byte for byte those of the JAX package), and ``run``
trains and evaluates every config in a directory with the port's
``TFAMTrainer``/``TFAMTester`` and tabulates each run's best val mAP. The
axes that vary:

  fusion mode   {cross-attention, rgb-only, motion-only,
                 concat temporal (dim=1), concat channel (dim=-1)}
  use_pe        {false, true}
  dropout pair  {(0.1, 0.1), (0.2, 0.3)}: dropout/mlp_dropout move together
  batch_size    4 for the temporal-concat (dim=1) self-attn points, else 8

The generated configs train on ``cuda``; ``--base-overrides
'{"training": {"device": "cpu"}}'`` puts a sweep on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os

from vimoclip_tpu_torch.utils.logging import setup_logging

# The reference's sweep: config_default + config_{1..20}, each entry the
# LITERAL override set of the corresponding TFAM/cfg_AK/config_N.yaml vs
# config_default.yaml (field-by-field equality pinned in
# tests/test_cli_tools.py for the JAX package's copy). Quirks preserved:
# config_1 and config_20 are exact re-runs of config_default and config_2,
# and the reference YAMLs' ``training.model_path`` key is dead (the loader
# hardcodes checkpoint_dir/best_model.pth, train_and_eval.py:187), so it
# is not reproduced — like the unused ``testing:`` section of
# config_test.yaml.
REFERENCE_GRID: list[dict] = [
    {},  # config_default: cross-attention fusion
    {},  # config_1: re-run of default (reference duplicate)
    {"model": {"dropout": 0.2, "mlp_dropout": 0.3}},  # config_2
    {"training": {"batch_size": 4},
     "model": {"use_cross_attention": False}},  # config_3: temporal concat
    {"model": {"use_cross_attention": False, "concat_dim": -1}},  # config_4
    {"training": {"batch_size": 4},
     "model": {"use_cross_attention": False, "use_pe": True}},  # config_5
    {"model": {"use_cross_attention": False, "use_pe": True,
               "concat_dim": -1}},  # config_6
    {"model": {"use_cross_attention": False, "use_only_rgb": True}},  # config_7
    {"model": {"use_cross_attention": False, "use_only_flow": True}},  # config_8
    {"model": {"use_cross_attention": False, "use_only_rgb": True,
               "use_pe": True}},  # config_9
    {"model": {"use_cross_attention": False, "use_only_flow": True,
               "use_pe": True}},  # config_10
    {"training": {"batch_size": 4},
     "model": {"use_cross_attention": False,
               "dropout": 0.2, "mlp_dropout": 0.3}},  # config_11
    {"model": {"use_cross_attention": False, "concat_dim": -1,
               "dropout": 0.2, "mlp_dropout": 0.3}},  # config_12
    {"model": {"use_cross_attention": False, "use_only_rgb": True,
               "dropout": 0.2, "mlp_dropout": 0.3}},  # config_13
    {"model": {"use_cross_attention": False, "use_only_flow": True,
               "dropout": 0.2, "mlp_dropout": 0.3}},  # config_14
    {"model": {"use_cross_attention": False, "use_only_rgb": True,
               "use_pe": True, "dropout": 0.2, "mlp_dropout": 0.3}},  # config_15
    {"model": {"use_cross_attention": False, "use_only_flow": True,
               "use_pe": True, "dropout": 0.2, "mlp_dropout": 0.3}},  # config_16
    {"training": {"batch_size": 4},
     "model": {"use_cross_attention": False, "use_pe": True,
               "dropout": 0.2, "mlp_dropout": 0.3}},  # config_17
    {"model": {"use_cross_attention": False, "use_pe": True, "concat_dim": -1,
               "dropout": 0.2, "mlp_dropout": 0.3}},  # config_18
    {"model": {"use_pe": True}},  # config_19
    {"model": {"dropout": 0.2, "mlp_dropout": 0.3}},  # config_20: rerun of 2
]


def base_config(data_overrides: dict | None = None) -> dict:
    """The reference's shared YAML schema (cfg_AK/config_default.yaml)."""
    cfg = {
        "training": {
            "mode": "both", "seed": 49, "lr": 1.0e-4, "epochs": 30,
            "batch_size": 8, "num_workers": 4,
        },
        "logging": {"log_dir": "logs", "checkpoint_dir": "checkpoints"},
        "data": {
            "num_classes": 140,
            "class_names_dir": "dataset/annotations/ak_action.csv",
            "train_dataset_path": "", "val_dataset_path": "",
            "frame_diff_dataset_path": "",
        },
        "model": {
            "d_model": 512, "nhead": 8, "num_layers": 4,
            "dim_feedforward": 2048, "use_cross_attention": True,
            "use_only_rgb": False, "use_only_flow": False, "use_pe": False,
            "concat_dim": 1, "dropout": 0.1, "mlp_dropout": 0.1,
        },
    }
    if data_overrides:
        cfg["data"].update(data_overrides)
    return cfg


def generate(
    out_dir: str,
    data_overrides: dict | None = None,
    base_overrides: dict | None = None,
) -> list[str]:
    """Write the 21-run grid. ``base_overrides`` patches the base config's
    sections BEFORE each grid entry applies, so shrinking geometry for a
    synthetic sweep (epochs, d_model, ...) never clobbers the axes the grid
    itself varies (batch_size, dropout, fusion flags)."""
    import yaml

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, overrides in enumerate(REFERENCE_GRID):
        cfg = base_config(data_overrides)
        for section, vals in (base_overrides or {}).items():
            cfg.setdefault(section, {}).update(vals)
        for section, vals in overrides.items():
            cfg[section].update(vals)
        name = "config_default.yaml" if i == 0 else f"config_{i}.yaml"
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False)
        paths.append(path)
    return paths


def _sweep_order(paths: list[str]) -> list[str]:
    """Reference execution order: config_default first, then config_1..N
    numerically (run_experiments.sh:3-23); non-grid names sort last."""

    def key(p: str):
        name = os.path.splitext(os.path.basename(p))[0]
        suffix = name.split("config_", 1)[-1]
        if suffix == "default":
            return (0, 0, name)
        return (1, int(suffix), name) if suffix.isdigit() else (2, 0, name)

    return sorted(paths, key=key)


def run(config_dir: str, results_path: str, resume: bool = False) -> list[dict]:
    """Run every config as the reference sweep does: each trains and
    evaluates per its ``training.mode``. A config that fails is recorded
    (``status: error``) and the sweep goes on; the results JSON is rewritten
    after every config, so a crash loses at most the run in flight.

    A SIGTERM or SIGINT during a run stops the sweep after that config
    (``status: preempted``; the trainer has cut its resume checkpoint).
    ``resume=True`` (``run --resume``) carries the configs recorded ``ok``
    in ``results_path`` forward without training them again and runs the
    rest with ``training.resume`` on, so the preempted config goes on from
    its checkpoint."""
    import math

    from vimoclip_tpu_torch.config import derive_run_dirs, load_experiment_config
    from vimoclip_tpu_torch.prng import set_seed
    from vimoclip_tpu_torch.train.tfam_trainer import TFAMTester, TFAMTrainer

    done: dict[str, dict] = {}
    if resume and os.path.exists(results_path):
        with open(results_path) as f:
            done = {e["config"]: e for e in json.load(f) if e.get("status") == "ok"}
        if done:
            logging.info("resume: carrying %d completed configs forward", len(done))

    results = []
    preempted = False
    for path in _sweep_order(glob.glob(os.path.join(config_dir, "config_*.yaml"))):
        name = os.path.basename(path)
        if name in done:
            results.append(done[name])
            continue
        logging.info("=== %s ===", path)
        entry: dict = {"config": name, "status": "ok"}
        try:
            config = load_experiment_config(path)
            if resume:
                config.training.resume = True
            set_seed(config.training.seed)
            log_dir, ckpt_dir = derive_run_dirs(config)
            trainer = TFAMTrainer(config, log_dir=log_dir, checkpoint_dir=ckpt_dir)
            if config.training.mode in ("train", "both"):
                best = float(trainer.train())
                # a run preempted before its first validation has best -inf,
                # which json.dump would write as non-RFC -Infinity
                entry["best_val_mAP"] = best if math.isfinite(best) else None
                if trainer.preempted:
                    # the remaining configs do not start: rerun with --resume
                    entry["status"] = "preempted"
                    preempted = True
            if not preempted and config.training.mode in ("test", "both"):
                base = path.split(".yaml")[0]
                tester = TFAMTester(trainer, results_dir=os.path.join(base, "results"))
                tester.load_best()
                evaluated = tester.evaluate(save_predictions=True, top_k=5)
                entry["eval_loss"] = evaluated["metrics"]["loss"]
                entry[f"eval_{trainer.metric_name}"] = evaluated["metrics"][
                    trainer.metric_name]
        except Exception as e:  # noqa: BLE001 — record the failure and go on
            logging.exception("sweep config failed: %s", path)
            entry.update(status="error", error=str(e))
        results.append(entry)
        with open(results_path, "w") as f:
            json.dump(results, f, indent=2)
        if preempted:
            logging.warning("preempted: stopping the sweep after %s; rerun with "
                            "--resume to continue", path)
            break
    try:
        from tabulate import tabulate

        def fmt(r, key):
            v = r.get(key)
            return f"{v:.4f}" if isinstance(v, (int, float)) else "-"

        print(tabulate(
            [(r["config"], r["status"], fmt(r, "best_val_mAP"),
              fmt(r, "eval_mAP") if "eval_mAP" in r else fmt(r, "eval_accuracy"))
             for r in results],
            headers=["config", "status", "best val mAP", "eval metric"],
            tablefmt="pretty",
        ))
    except ImportError:
        pass
    return results


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="TFAM ablation sweep (PyTorch/CUDA port)")
    sub = p.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("generate", help="write the sweep configs")
    g.add_argument("--out-dir", default="configs/cfg_AK")
    g.add_argument("--train-h5", default="")
    g.add_argument("--val-h5", default="")
    g.add_argument("--motion-h5", default="")
    g.add_argument("--base-overrides", default="",
                   help="JSON dict of section->field overrides applied to the "
                        "base config before each grid entry (e.g. shrink the "
                        "geometry, or train on the CPU)")
    r = sub.add_parser("run", help="run every config in a directory")
    r.add_argument("--config-dir", default="configs/cfg_AK")
    r.add_argument("--results", default="sweep_results.json")
    r.add_argument("--resume", action="store_true",
                   help="carry configs already ok in --results forward and "
                        "resume the one in flight from its checkpoint")
    args = p.parse_args(argv)

    setup_logging()
    if args.cmd == "generate":
        overrides = {}
        if args.train_h5:
            overrides["train_dataset_path"] = args.train_h5
        if args.val_h5:
            overrides["val_dataset_path"] = args.val_h5
        if args.motion_h5:
            overrides["frame_diff_dataset_path"] = args.motion_h5
        base = json.loads(args.base_overrides) if args.base_overrides else None
        paths = generate(args.out_dir, overrides, base_overrides=base)
        print(f"wrote {len(paths)} configs to {args.out_dir}")
    else:
        run(args.config_dir, args.results, resume=args.resume)


if __name__ == "__main__":
    main()
