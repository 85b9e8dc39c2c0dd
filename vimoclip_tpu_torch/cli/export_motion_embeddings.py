"""Motion-embedding export CLI (the port's copy of
``vimoclip_tpu/cli/export_motion_embeddings.py``; the reference's
``inference.py`` / ``inference_frame_diff.py`` in one tool).

    python -m vimoclip_tpu_torch.cli.export_motion_embeddings \\
        --videos-dir motion/ --output motion.h5 \\
        --torch-checkpoint student_best.pth [--resize 224 224] [--device cpu]

The student comes from a reference-format ``student_best.pth``
(``--torch-checkpoint``) or from the ``best/`` of a directory that the
port's stage-1 trainer wrote (``--checkpoint-dir``). Orbax directories of
the JAX package are not read: ``vimo-convert student-to-torch`` exports them
to ``.pth`` first. It runs on the card (``--device``, default ``cuda``) and
raises when there is none. ``--quantize int8`` and ``--token-merge R`` are
opt-in approximations of the student's tower; ``--verify-fidelity N``
measures them on the first motion video before the export starts.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os

from vimoclip_tpu_torch.utils.logging import setup_logging


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="Export student motion embeddings to HDF5 "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--videos-dir", required=True, help="motion (flow/diff) video dir")
    p.add_argument("--output", required=True, help="output HDF5 path")
    p.add_argument("--checkpoint-dir", default=None,
                   help="a stage-1 checkpoint directory of the port (reads best/)")
    p.add_argument("--torch-checkpoint", default=None,
                   help="reference-format student_best.pth (DataParallel 'module.' "
                        "prefix handled)")
    p.add_argument("--clip-weights", default=None,
                   help="vision config source; inferred from the checkpoint if omitted")
    p.add_argument("--chunk-size", type=int, default=128,
                   help="streaming decode/forward chunk (frames)")
    p.add_argument("--compression", choices=["lzf", "gzip", "none"], default="lzf")
    p.add_argument("--min-free-gb", type=float, default=2.0,
                   help="host RAM floor checked between chunks")
    p.add_argument("--overwrite", action="store_true",
                   help="recreate the output instead of resuming")
    p.add_argument("--resize", type=int, nargs=2, default=None, metavar=("H", "W"))
    p.add_argument("--float32", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card is an error")
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="opt-in dynamic-int8 matmuls in the student's ViT blocks "
                        "(ops/quant.py; the checkpoint loads unchanged): "
                        "approximate, not the default path")
    p.add_argument("--token-merge", type=int, default=0, metavar="R",
                   help="opt-in ToMe token merging in the student's ViT "
                        "(ops/tome.py): approximate, not the default path")
    p.add_argument("--verify-fidelity", type=int, default=0, metavar="N",
                   help="before exporting, run N frames sampled from the first "
                        "motion video through both the exact and the "
                        "--quantize/--token-merge student tower and log the "
                        "cosine (fidelity.py); stops below --fidelity-threshold")
    p.add_argument("--fidelity-threshold", type=float, default=0.97,
                   help="minimum per-frame cosine the --verify-fidelity probe "
                        "must reach (default 0.97)")
    args = p.parse_args(argv)
    if (args.checkpoint_dir is None) == (args.torch_checkpoint is None):
        p.error("exactly one of --checkpoint-dir / --torch-checkpoint is required")
    checkpoint = args.torch_checkpoint
    if args.checkpoint_dir:
        checkpoint = os.path.join(args.checkpoint_dir, "best", "best_model.pth")
        if not os.path.isfile(checkpoint):
            p.error(f"--checkpoint-dir: no {checkpoint}; the port reads the directories "
                    "its own stage-1 trainer writes. Orbax checkpoint directories are "
                    "exported to .pth with `vimo-convert student-to-torch` and passed "
                    "as --torch-checkpoint")

    setup_logging(log_file=None)
    from vimoclip_tpu_torch.export import MotionEmbeddingExporter, find_motion_videos
    from vimoclip_tpu_torch.models.convert import student_state_from_checkpoint

    vision_config = None
    if args.clip_weights:
        from vimoclip_tpu_torch.models.pretrained import load_clip_vision

        vision_config, _ = load_clip_vision(args.clip_weights)
    vision_config, state = student_state_from_checkpoint(checkpoint, vision_config)
    if args.quantize or args.token_merge:
        vision_config = dataclasses.replace(
            vision_config, matmul_quant=args.quantize or vision_config.matmul_quant,
            token_merge_r=args.token_merge or vision_config.token_merge_r)

    videos = find_motion_videos(args.videos_dir)
    logging.info("found %d motion videos", len(videos))
    if args.verify_fidelity and (vision_config.matmul_quant or vision_config.token_merge_r):
        if not videos:
            raise SystemExit("--verify-fidelity: no motion videos to probe")
        from vimoclip_tpu_torch.fidelity import check_encoder_fidelity
        from vimoclip_tpu_torch.models.convert import student_tower_state

        check_encoder_fidelity(student_tower_state(state), vision_config, videos[0],
                               args.verify_fidelity, args.fidelity_threshold,
                               half_precision=not args.float32,
                               encoder_name="student ViT", device=args.device)
    exporter = MotionEmbeddingExporter(
        state, vision_config, chunk_size=args.chunk_size,
        half_precision=not args.float32,
        compression=None if args.compression == "none" else args.compression,
        min_free_gb=args.min_free_gb, device=args.device,
    )
    exporter.export(videos, args.output, overwrite=args.overwrite,
                    resize_to=tuple(args.resize) if args.resize else None)


if __name__ == "__main__":
    main()
