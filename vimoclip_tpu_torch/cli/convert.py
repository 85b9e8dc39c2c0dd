"""vimo-convert-torch: export the port's trained checkpoints in the
reference's torch formats (the port's copy of ``vimoclip_tpu/cli/convert.py``).

Subcommands:
  tfam-to-torch     a stage-2 checkpoint (``TFAMTrainer``) -> the reference
                    ``best_model.pth``: ``{"state_dict", "epoch",
                    "best_val_mAP"}`` (TFAM/train_and_eval.py:133-149; the
                    reference eval loads ``checkpoint["state_dict"]``)
  student-to-torch  a stage-1 checkpoint (``StudentTrainer``) -> the
                    reference ``student_best.pth``, a bare state dict

Both read the port's checkpoint layout (``train/state.py``,
``CheckpointManager``): ``<dir>/<name>/state.pt`` plus ``extra.json``. The
port's modules keep the reference's state-dict layout, and its TFAM owns
``cross_attn``/``norm_cross`` in every layer and ``projection_layer`` in
every fusion mode, as the reference's does, so the payload loads with
``strict=True`` there. ``--module-prefix`` prepends DataParallel's
``module.`` to every key. Orbax directories, which the JAX package's
trainers write, are read only by the JAX package's ``vimo-convert``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def _load_port_state(checkpoint_dir: str, name: str) -> tuple[dict, dict]:
    """(model state dict, extra-json sidecar) of ``<dir>/<name>``."""
    path = os.path.join(os.path.abspath(checkpoint_dir), name)
    if not os.path.isdir(path):
        available = sorted(
            d for d in os.listdir(checkpoint_dir)
            if os.path.isdir(os.path.join(checkpoint_dir, d))
        ) if os.path.isdir(checkpoint_dir) else []
        raise SystemExit(f"no checkpoint '{name}' under {checkpoint_dir} "
                         f"(available: {available or 'none'})")
    state_path = os.path.join(path, "state.pt")
    if not os.path.exists(state_path):
        raise SystemExit(
            f"{path} has no state.pt: not a checkpoint of the PyTorch port. An "
            "Orbax checkpoint of the JAX package is converted by its own "
            "`vimo-convert` (Orbax cannot be read without JAX)")
    state = torch.load(state_path, map_location="cpu", weights_only=True)["model"]
    extra = {}
    extra_path = os.path.join(path, "extra.json")
    if os.path.exists(extra_path):
        with open(extra_path) as f:
            extra = json.load(f)
    return state, extra


def _count_layers(state: dict) -> int:
    return len({k.split(".")[1] for k in state if k.startswith("layers.")})


def _prefixed(state: dict, module_prefix: bool) -> dict:
    prefix = "module." if module_prefix else ""
    return {prefix + k: v for k, v in state.items()}


def convert_tfam(checkpoint_dir: str, out: str, name: str = "best",
                 num_layers: int | None = None,
                 module_prefix: bool = False) -> dict:
    """Stage-2 checkpoint -> reference ``best_model.pth``; returns the
    saved payload. ``num_layers`` keeps the first N layers (default: all).
    The sidecar's epoch and best metric ride along under the reference's
    own keys; its loader reads only ``state_dict``."""
    state, extra = _load_port_state(checkpoint_dir, name)
    have = _count_layers(state)
    if have == 0:
        raise SystemExit(f"checkpoint under {checkpoint_dir}/{name} has no layers.* "
                         "weights: is this a stage-2 TFAM checkpoint?")
    n = num_layers or have
    if n > have:
        raise SystemExit(f"--num-layers {n}: the checkpoint has {have} layers")
    state = {k: v for k, v in state.items()
             if not k.startswith("layers.") or int(k.split(".")[1]) < n}
    payload: dict = {"state_dict": _prefixed(state, module_prefix)}
    if "epoch" in extra:
        payload["epoch"] = int(extra["epoch"])
    if "best_metric" in extra:
        payload["best_val_mAP"] = float(extra["best_metric"])
    torch.save(payload, out)
    return payload


def convert_student(checkpoint_dir: str, out: str, name: str = "best",
                    module_prefix: bool = False) -> dict:
    """Stage-1 checkpoint -> reference ``student_best.pth`` (a bare state
    dict: ``visual_encoder.*`` in the OpenAI CLIP layout, ``residual_mlp``,
    ``classification_head``)."""
    state, _ = _load_port_state(checkpoint_dir, name)
    if not any(k.startswith("visual_encoder.") for k in state):
        raise SystemExit(f"checkpoint under {checkpoint_dir}/{name} has no "
                         "visual_encoder weights: is this a stage-1 student checkpoint?")
    tensors = _prefixed(state, module_prefix)
    torch.save(tensors, out)
    return tensors


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    for cmd in ("tfam-to-torch", "student-to-torch"):
        s = sub.add_parser(cmd)
        s.add_argument("--checkpoint-dir", required=True,
                       help="the trainer's checkpoint directory")
        s.add_argument("--name", default="best",
                       help="checkpoint under the dir: 'best' or 'step_N' "
                            "(default: best)")
        s.add_argument("--out", required=True, help="output .pth path")
        s.add_argument("--module-prefix", action="store_true",
                       help="prefix every key with DataParallel's 'module.' "
                            "(reference stage-1 layout)")
    sub.choices["tfam-to-torch"].add_argument(
        "--num-layers", type=int, default=None,
        help="keep the first N layers (default: all in the checkpoint)")
    args = p.parse_args(argv)

    if args.cmd == "tfam-to-torch":
        payload = convert_tfam(args.checkpoint_dir, args.out, name=args.name,
                               num_layers=args.num_layers,
                               module_prefix=args.module_prefix)
        n = len(payload["state_dict"])
        print(f"wrote {args.out}: {n} tensors"
              + (f", best_val_mAP={payload['best_val_mAP']:.4f}"
                 if "best_val_mAP" in payload else ""))
    else:
        tensors = convert_student(args.checkpoint_dir, args.out, name=args.name,
                                  module_prefix=args.module_prefix)
        print(f"wrote {args.out}: {len(tensors)} tensors")
    return 0


if __name__ == "__main__":
    sys.exit(main())
