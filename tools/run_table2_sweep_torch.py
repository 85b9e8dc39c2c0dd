#!/usr/bin/env python
"""The Table-2 sweep on the PyTorch port: the 21-config grid trained and
evaluated on the CPU over a synthetic cascade corpus, written to
SWEEP_TORCH.json beside the JAX package's SWEEP.json.

The port's copy of ``tools/run_table2_sweep.py``. The grid comes from
``vimoclip_tpu_torch.cli.run_experiments`` (``generate``, ``run``), whose
21 YAMLs equal the JAX package's byte for byte; the geometry is JAX's
``TINY_BASE_OVERRIDES`` (d 24, 2 heads, 1 layer, ff 48, 20 epochs, lr 5e-3)
on ``--device`` (``cuda`` unless given ``--device cpu``; the committed
SWEEP_TORCH.json ran on the CPU). Each config trains AND evaluates over
embedding files that the port's own extraction, motion and export stages
made from the synthetic two-factor corpus (``build_corpus``).

The corpus is JAX's, frame for frame: ``corpus_frames`` draws from
``np.random.default_rng(seed)`` in the order of JAX's ``build_corpus``
loop. It reaches the embeddings by one of two routes:

- files (``build_corpus``, on the CPU): mp4 videos
  (``data/video_reader.write_video``), teacher extraction into rgb.h5
  (``extraction.create_hdf5_dataset``), frame-diff videos
  (``motion.process_video_list``) and their export into motion.h5
  (``export.MotionEmbeddingExporter.export``). It needs OpenCV and h5py.
- memory (``corpus_items``, for the card's machine, which has neither): the
  same frames through ``ClipExtractor`` (its decode seam),
  ``ops/preprocess.frame_diff`` and ``MotionEmbeddingExporter._embed_chunk``,
  giving the item dicts ``TFAMTrainer(train_dataset=..., val_dataset=...)``
  takes. It skips the two mp4 encodes, so its embeddings differ from the
  files route's by the codec's artifacts.

The tiny teacher (image 32, patch 8, width 32, 1 layer, 2 heads, ff 64)
extracts the RGB stream in bf16 and the motion stream in float32, as JAX's
corpus does (``create_hdf5_dataset``'s default and ``half_precision=False``
for the export); ``rgb_half_precision=False`` runs both in float32. Its
weights are drawn from
``torch.Generator().manual_seed(seed)`` unless a state is given (the tests
give JAX's Flax weights through ``models/convert.py``).

Usage:
    python tools/run_table2_sweep_torch.py --out SWEEP_TORCH.json --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

N_COLOR, N_MOTION = 3, 2
N_CLASSES = N_COLOR * N_MOTION
FRAME_HW = (36, 48)
EXTRACT_BATCH = 16  # JAX's create_hdf5_dataset batch and export chunk
PALETTE = np.array([[100, 0, 0], [0, 100, 0], [0, 0, 100]], np.float32)

# JAX's TINY_BASE_OVERRIDES (tools/run_table2_sweep.py); ``main`` adds the
# device
TINY_BASE_OVERRIDES = {
    "training": {"epochs": 20, "lr": 5e-3, "num_workers": 2},
    "model": {"d_model": 24, "nhead": 2, "num_layers": 1, "dim_feedforward": 48},
}
# the grid's config of each fusion mode at the reference defaults
MODE_CONFIGS = {"cross": "config_default.yaml", "concat_t": "config_3.yaml",
                "rgb": "config_7.yaml", "flow": "config_8.yaml"}
# the JAX package's sweep, whose best val mAPs go beside the port's
JAX_ARTIFACT = os.path.join(_REPO, "SWEEP.json")


def corpus_frames(seed: int = 0, videos_per_class: int = 8, val_videos_per_class: int = 0,
                  order_only: bool = False) -> tuple[list, list, list]:
    """The synthetic two-factor corpus of JAX's ``build_corpus``, frame for
    frame: (uint8 (T, 36, 48, 3) RGB frames, names ``v{i}.mp4``, class
    labels). class = static colour cast (3) x motion factor (2): flicker
    against still, or with ``order_only`` the same low/high frame multiset
    as one step against alternation. Videos come class by class in turn;
    the first ``videos_per_class`` x 6 are the training split."""
    rng = np.random.default_rng(seed)
    n_videos = (videos_per_class + val_videos_per_class) * N_CLASSES
    frames, names, labels = [], [], []
    for i in range(n_videos):
        k = i % N_CLASSES
        color, flicker = k % N_COLOR, k // N_COLOR
        if order_only:
            t = int(rng.choice([8, 10, 12]))
            highs = ([bool(j % 2) for j in range(t)] if flicker
                     else [j >= t // 2 for j in range(t)])
            gs = [1.4 if hi else 0.2 for hi in highs]
        else:
            t = int(rng.integers(8, 13))
            gs = [0.8 + (0.6 if flicker and j % 2 else -0.6 if flicker else 0.0)
                  for j in range(t)]
        texture = rng.integers(0, 256, (*FRAME_HW, 3)).astype(np.float32)
        video = np.empty((t, *FRAME_HW, 3), np.float32)
        for j in range(t):
            video[j] = 0.25 * texture + PALETTE[color] + 60.0 * gs[j]
        frames.append(np.clip(video, 0, 255).astype(np.uint8))
        names.append(f"v{i}.mp4")
        labels.append(k)
    return frames, names, labels


def _flax_init_(encoder, generator) -> None:
    """The JAX tower's initialisers in distribution (the bits cannot match):
    LayerNorm scales 1 and biases 0, the class and position embeddings
    normal(0, 0.02), every other product Flax's default lecun-normal (a
    normal truncated at two sigma, variance 1 / fan-in). A random tower is
    the corpus's feature extractor, so its scale matters: at a uniform
    0.02 the colour casts reach the embeddings about 1e-3 apart, and the
    sweep learns nothing."""
    import torch
    from torch import nn

    norms = {id(m.weight) for m in encoder.modules() if isinstance(m, nn.LayerNorm)}
    with torch.no_grad():
        for name, p in encoder.named_parameters():
            if id(p) in norms:
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            elif name in ("class_embedding", "positional_embedding"):
                p.normal_(0.0, 0.02, generator=generator)
            else:  # (out, in...) weights; ``proj`` is (in, out)
                fan_in = p.shape[0] if name == "proj" else p[0].numel()
                std = fan_in ** -0.5 / 0.87962566103423978  # unit variance after the cut
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)


def tiny_teacher(projection_dim: int, seed: int = 0, state=None):
    """(config, state) of the tiny CLIP tower both streams run through:
    ``state`` (``ClipVisionEncoder`` layout) or weights drawn from
    ``torch.Generator().manual_seed(seed)`` (``_flax_init_``)."""
    import torch

    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder

    cfg = ClipVisionConfig(image_size=32, patch_size=8, hidden_size=32, num_layers=1,
                           num_heads=2, intermediate_size=64, projection_dim=projection_dim)
    if state is None:
        encoder = ClipVisionEncoder(cfg)
        _flax_init_(encoder, torch.Generator().manual_seed(seed))
        state = encoder.state_dict()
    return cfg, state


def _write_lines(path: str, lines) -> str:
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def build_corpus(work: str, seed: int = 0, projection_dim: int = 24,
                 videos_per_class: int = 8, val_videos_per_class: int = 0,
                 order_only: bool = False, *, device, teacher_state=None,
                 rgb_half_precision: bool = True):
    """The files route (module docstring) into ``work``: (rgb_h5, motion_h5,
    classes_csv), plus the held-out val_rgb_h5 when ``val_videos_per_class``
    > 0, as JAX's ``build_corpus`` returns them. ``device`` runs the
    teacher and the frame differences."""
    from vimoclip_tpu_torch.data.video_reader import write_video
    from vimoclip_tpu_torch.export import MotionEmbeddingExporter, find_motion_videos
    from vimoclip_tpu_torch.extraction import create_hdf5_dataset
    from vimoclip_tpu_torch.motion import process_video_list

    frames, names, labels = corpus_frames(seed, videos_per_class, val_videos_per_class,
                                          order_only)
    n_train = videos_per_class * N_CLASSES
    vids = os.path.join(work, "videos")
    os.makedirs(vids, exist_ok=True)
    for video, name in zip(frames, names):
        write_video(os.path.join(vids, name), video)
    classes = _write_lines(os.path.join(work, "classes.csv"), ["id,name"] + [
        f"{i},color{i % N_COLOR}_{'flicker' if i >= N_COLOR else 'still'}"
        for i in range(N_CLASSES)])
    vcfg, state = tiny_teacher(projection_dim, seed, teacher_state)

    def extract(split: slice, ann_name: str, h5_name: str) -> str:
        ann = _write_lines(os.path.join(work, ann_name),
                           [f"{n} {k}" for n, k in zip(names[split], labels[split])])
        out = os.path.join(work, h5_name)
        errors = create_hdf5_dataset(
            data_root=vids, annotation_file=ann, class_file=classes, output_hdf5=out,
            state=state, config=vcfg, batch_size=EXTRACT_BATCH, split="train",
            half_precision=rgb_half_precision, device=device)
        if errors:
            raise RuntimeError(f"extraction into {h5_name} failed: {errors}")
        return out

    rgb_h5 = extract(slice(0, n_train), "train.txt", "rgb.h5")
    val_rgb_h5 = (extract(slice(n_train, None), "val.txt", "rgb_val.h5")
                  if val_videos_per_class else None)
    diff_dir = os.path.join(work, "diffs")
    errors = process_video_list(_write_lines(os.path.join(work, "list.txt"), names), vids,
                                diff_dir, kind="frame_diff", device=device)
    if errors:
        raise RuntimeError(f"frame-diff videos failed: {errors}")
    motion_h5 = os.path.join(work, "motion.h5")
    exporter = MotionEmbeddingExporter(state, vcfg, chunk_size=EXTRACT_BATCH,
                                       half_precision=False, device=device)
    counts = exporter.export(find_motion_videos(diff_dir), motion_h5)
    if counts["errors"]:
        raise RuntimeError(f"motion export failed: {counts}")
    if val_videos_per_class:
        return rgb_h5, motion_h5, classes, val_rgb_h5
    return rgb_h5, motion_h5, classes


def embed_clips(rgb_frames: list, motion_frames: list, vcfg, state, device,
                rgb_half_precision: bool = True) -> tuple:
    """The memory route's embedding stage: each video's RGB frames through
    ``ClipExtractor`` (fed through its decode seam, batches of 16 across
    videos, as ``create_hdf5_dataset`` runs it; bf16 unless
    ``rgb_half_precision`` is False) and its motion frames through
    ``MotionEmbeddingExporter._embed_chunk`` in 16-frame chunks in float32,
    as ``export`` runs it, on ``device``. Returns two lists of (T, P)
    float32 arrays."""
    from vimoclip_tpu_torch.export import MotionEmbeddingExporter
    from vimoclip_tpu_torch.extraction import ClipExtractor

    by_id = {str(i): v for i, v in enumerate(rgb_frames)}

    def decode(path, chunk_size):
        video = by_id[path]
        for s in range(0, len(video), chunk_size):
            yield video[s:s + chunk_size]

    extractor = ClipExtractor(state, vcfg, batch_size=EXTRACT_BATCH,
                              half_precision=rgb_half_precision,
                              decode_workers=1, device=device, decode_fn=decode)
    rgb: dict[str, np.ndarray] = {}
    errors = extractor.extract([(i, i) for i in by_id], lambda vid, emb: rgb.__setitem__(vid, emb))
    if errors:
        raise RuntimeError(f"extraction failed: {errors}")
    exporter = MotionEmbeddingExporter(state, vcfg, chunk_size=EXTRACT_BATCH,
                                       half_precision=False, device=device)
    motion = [np.concatenate([exporter._embed_chunk(m[s:s + EXTRACT_BATCH])
                              for s in range(0, len(m), EXTRACT_BATCH)]) for m in motion_frames]
    return [rgb[str(i)] for i in range(len(rgb_frames))], motion


def motion_frames_of(frames: list, device) -> list:
    """``frame_diff`` of each video on ``device``: (T - 1, H, W, 3) uint8."""
    import torch

    from vimoclip_tpu_torch.ops.preprocess import frame_diff
    from vimoclip_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    return [frame_diff(torch.from_numpy(v).to(dev)).cpu().numpy() for v in frames]


def as_items(names, labels, rgb, motion) -> list[dict]:
    """``PairedEmbeddingDataset`` items, in its order (the HDF5 groups'
    names, sorted)."""
    items = [{"video_id": n, "embeddings": r, "motion_embeddings": m,
              "labels": np.eye(N_CLASSES, dtype=np.float32)[k]}
             for n, k, r, m in zip(names, labels, rgb, motion)]
    return sorted(items, key=lambda it: it["video_id"])


def corpus_items(seed: int = 0, projection_dim: int = 24, videos_per_class: int = 8,
                 val_videos_per_class: int = 0, order_only: bool = False, *, device,
                 teacher_state=None, rgb_half_precision: bool = True) -> tuple[list, list]:
    """The memory route (module docstring): (train items, val items) for
    ``TFAMTrainer``; the val items are the training split's when
    ``val_videos_per_class`` is 0, as the toy sweep validates on rgb.h5."""
    frames, names, labels = corpus_frames(seed, videos_per_class, val_videos_per_class,
                                          order_only)
    vcfg, state = tiny_teacher(projection_dim, seed, teacher_state)
    rgb, motion = embed_clips(frames, motion_frames_of(frames, device), vcfg, state, device,
                              rgb_half_precision)
    n = videos_per_class * N_CLASSES
    train = as_items(names[:n], labels[:n], rgb[:n], motion[:n])
    val = as_items(names[n:], labels[n:], rgb[n:], motion[n:]) if n < len(names) else train
    return train, val


def mode_ordering(best: dict) -> list[str]:
    """The fusion modes from the highest best val mAP down."""
    return sorted(MODE_CONFIGS, key=lambda m: -best[MODE_CONFIGS[m]])


def run_sweep(work: str, seed: int = 0, *, device: str, teacher_state=None,
              rgb_half_precision: bool = True) -> dict:
    """The grid over the files-route corpus, built and run in ``work`` on
    ``device``: the artifact's dict (``main``)."""
    from vimoclip_tpu_torch.cli.run_experiments import generate, run
    from vimoclip_tpu_torch.utils.device import describe_card

    t0 = time.time()
    rgb_h5, motion_h5, classes = build_corpus(work, seed=seed, device=device,
                                              teacher_state=teacher_state,
                                              rgb_half_precision=rgb_half_precision)
    geometry = {"training": dict(TINY_BASE_OVERRIDES["training"], device=device),
                "model": TINY_BASE_OVERRIDES["model"]}
    cfg_dir = os.path.join(work, "cfg_AK")
    generate(cfg_dir, data_overrides={
        "num_classes": N_CLASSES, "class_names_dir": classes,
        "train_dataset_path": rgb_h5, "val_dataset_path": rgb_h5,
        "frame_diff_dataset_path": motion_h5, "length_bucket": 8,
    }, base_overrides=geometry)
    cwd = os.getcwd()
    os.chdir(work)  # run dirs (logs/, checkpoints/, results) land in work
    try:
        results = run(cfg_dir, os.path.join(work, "sweep_results.json"))
    finally:
        os.chdir(cwd)

    with open(JAX_ARTIFACT) as f:
        jax_best = {r["config"]: r.get("best_val_mAP") for r in json.load(f)["results"]}
    for r in results:
        r["jax_best_val_mAP"] = jax_best.get(r["config"])
    ours = {r["config"]: r.get("best_val_mAP") for r in results}
    ordering = {"configs": MODE_CONFIGS, "jax": mode_ordering(jax_best)}
    if all(ours.get(c) is not None for c in MODE_CONFIGS.values()):
        ordering["torch"] = mode_ordering(ours)
    rgb_dtype = "bf16" if rgb_half_precision else "float32"
    return {
        "sweep": "reference Table-2 grid (TFAM/run_experiments.sh:3-23) on the PyTorch port",
        "corpus": "synthetic cascade, files route (tools/run_table2_sweep_torch.py:"
                  f"build_corpus, tiny teacher: rgb in {rgb_dtype}, motion in float32)",
        "geometry": geometry,
        "device": describe_card(device),
        "configs_total": len(results),
        "configs_ok": sum(r["status"] == "ok" for r in results),
        "wall_s": round(time.time() - t0, 1),
        "mode_ordering": ordering,
        "results": results,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="SWEEP_TORCH.json")
    p.add_argument("--work-dir", default="",
                   help="working directory (default: a fresh temporary directory)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out_path = os.path.abspath(args.out)

    from vimoclip_tpu_torch.cli.run_experiments import REFERENCE_GRID
    from vimoclip_tpu_torch.utils.device import resolve_device
    from vimoclip_tpu_torch.utils.logging import setup_logging

    resolve_device(args.device)  # no card: raise before any work
    setup_logging()
    work = os.path.abspath(args.work_dir or tempfile.mkdtemp(prefix="table2_sweep_torch_"))
    os.makedirs(work, exist_ok=True)
    artifact = run_sweep(work, args.seed, device=args.device)
    with open(out_path, "w") as f:
        json.dump(artifact, f, indent=2)
    ok, ordering = artifact["configs_ok"], artifact["mode_ordering"]
    print(f"sweep: {ok}/{artifact['configs_total']} ok -> {out_path}; modes by best val "
          f"mAP: {ordering.get('torch')} (JAX {ordering['jax']})")
    return 0 if ok == artifact["configs_total"] == len(REFERENCE_GRID) else 1


if __name__ == "__main__":
    sys.exit(main())
