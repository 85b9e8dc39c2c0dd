"""Teacher-embedding extraction CLI (the port's copy of
``vimoclip_tpu/cli/extract_embeddings.py``; the reference's
``extract_embeddings.py`` (AK, ViT-B/16) and
``extract_embeddings_mammalNet.py`` (MN, ViT-B/32) in one tool).

    python -m vimoclip_tpu_torch.cli.extract_embeddings \\
        --data-root videos/ --annotation-file train.txt --class-file classes.csv \\
        --output rgb_train.h5 --clip-weights clip.pt --split train [--device cpu]

It runs on the card (``--device``, default ``cuda``) and raises when there is
none; ``--device cpu`` runs on the CPU. ``--quantize int8`` and
``--token-merge R`` are opt-in approximations of the tower;
``--verify-fidelity N`` measures them on this shard's first readable video
before anything is written, and stops below ``--fidelity-threshold``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time

from vimoclip_tpu_torch.utils.logging import setup_logging


def _probe_fidelity(args, config, state) -> None:
    """--verify-fidelity on this shard's own videos: an unreadable video is
    skipped with a warning, as extraction skips it; a shard with no
    readable video raises."""
    from vimoclip_tpu_torch.extraction import load_annotations, shard_annotations
    from vimoclip_tpu_torch.fidelity import check_encoder_fidelity, sample_video_frames

    annotations = shard_annotations(load_annotations(args.annotation_file),
                                    args.num_shards, args.shard_index)
    for vid, _ in annotations:
        path = os.path.join(args.data_root, vid)
        try:
            frames = sample_video_frames(path, args.verify_fidelity)
        except Exception as e:  # noqa: BLE001 — any decode fault skips the video
            logging.warning("fidelity probe: cannot read %s (%s); trying the next "
                            "annotated video", path, e)
            continue
        check_encoder_fidelity(state, config, path, args.verify_fidelity,
                               args.fidelity_threshold, half_precision=not args.float32,
                               encoder_name="teacher ViT", frames=frames,
                               device=args.device)
        return
    raise RuntimeError("--verify-fidelity: no readable video in this shard's "
                       "annotation list to probe")


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="Extract CLIP frame embeddings to HDF5 "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--data-root", required=True, help="video directory")
    p.add_argument("--annotation-file", required=True,
                   help="'<video> label...' lines (train_multi.txt format)")
    p.add_argument("--class-file", required=True, help="id,name csv (ak_action.csv)")
    p.add_argument("--output", required=True, help="output HDF5 path")
    p.add_argument("--clip-weights", required=True,
                   help="CLIP checkpoint: safetensors / torch state dict / HF dir")
    p.add_argument("--max-frames", type=int, default=None,
                   help="uniform frame subsampling cap (extract_embeddings.py:77-81)")
    p.add_argument("--batch-size", type=int, default=256,
                   help="device batch (frames)")
    p.add_argument("--split", default="val", choices=["train", "val", "test"])
    p.add_argument("--dataset-name", default="AnimalKingdom")
    p.add_argument("--no-compression", action="store_true",
                   help="disable gzip (faster writes)")
    p.add_argument("--dedup-threshold", type=float, default=None,
                   help="opt-in temporal-redundancy gating: frames whose mean "
                        "|pixel delta| to the last embedded frame is below this "
                        "(uint8 units, e.g. 1.0) reuse its embedding")
    p.add_argument("--float32", action="store_true",
                   help="full-precision forward (default bfloat16)")
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="opt-in dynamic-int8 matmuls in the ViT blocks "
                        "(ops/quant.py): approximate, not the default path")
    p.add_argument("--token-merge", type=int, default=0, metavar="R",
                   help="opt-in ToMe token merging: merge R patch tokens after "
                        "every encoder block (ops/tome.py): approximate, not "
                        "the default path")
    p.add_argument("--verify-fidelity", type=int, default=0, metavar="N",
                   help="before extracting, run N frames sampled from the first "
                        "readable video of this shard through both the exact "
                        "and the --quantize/--token-merge tower and log the "
                        "cosine (fidelity.py); stops below --fidelity-threshold")
    p.add_argument("--fidelity-threshold", type=float, default=0.97,
                   help="minimum per-frame cosine the --verify-fidelity probe "
                        "must reach (default 0.97)")
    p.add_argument("--num-shards", type=int, default=1,
                   help="split the annotation list over this many extraction jobs "
                        "(pair with --shard-index; merge with vimo-h5-merge-torch)")
    p.add_argument("--shard-index", type=int, default=0)
    p.add_argument("--data-parallel", type=int, default=1,
                   help="one replica of the tower on each of N cards (cuda:0..N-1; "
                        "N times the CPU with --device cpu); --batch-size must "
                        "divide by N")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card is an error")
    args = p.parse_args(argv)

    setup_logging(log_file=None)
    from vimoclip_tpu_torch.extraction import create_hdf5_dataset
    from vimoclip_tpu_torch.models.pretrained import load_clip_vision
    from vimoclip_tpu_torch.parallel.mesh import replica_devices

    config, state = load_clip_vision(args.clip_weights)
    if args.quantize or args.token_merge:
        config = dataclasses.replace(
            config, matmul_quant=args.quantize or config.matmul_quant,
            token_merge_r=args.token_merge or config.token_merge_r)
        logging.info("approximate encoder options: quantize=%s token_merge=%d",
                     args.quantize, args.token_merge)
    if args.verify_fidelity and (config.matmul_quant or config.token_merge_r):
        _probe_fidelity(args, config, state)
    devices = None
    if args.data_parallel > 1:
        devices = replica_devices(args.data_parallel, args.device)
        logging.info("extraction: %d-way data parallel over %s", args.data_parallel,
                     [str(d) for d in devices])
    logging.info("%s visual tower: patch %d, %d layers, embedding %d",
                 type(config).__name__, config.patch_size, config.num_layers,
                 config.embed_dim)
    start = time.time()
    errors = create_hdf5_dataset(
        data_root=args.data_root,
        annotation_file=args.annotation_file,
        class_file=args.class_file,
        output_hdf5=args.output,
        state=state,
        config=config,
        max_frames=args.max_frames,
        batch_size=args.batch_size,
        split=args.split,
        dataset_name=args.dataset_name,
        clip_model_name=f"ViT-B/{config.patch_size}",
        compression=None if args.no_compression else "gzip",
        dedup_threshold=args.dedup_threshold,
        half_precision=not args.float32,
        devices=devices,
        num_shards=args.num_shards,
        shard_index=args.shard_index,
        device=args.device,
    )
    logging.info("done in %.1fs; %d errors", time.time() - start, len(errors))
    for vid, err in errors.items():
        logging.warning("  %s: %s", vid, err)


if __name__ == "__main__":
    main()
