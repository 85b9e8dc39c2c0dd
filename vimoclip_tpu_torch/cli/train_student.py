"""Stage-1 MoCLIP distillation CLI (the port's copy of
``vimoclip_tpu/cli/train_student.py``; the reference's ``python train.py`` /
``train_frame_diff.py`` / ``train_frame_diff_mn.py`` in one tool).

    python -m vimoclip_tpu_torch.cli.train_student \\
        --train-embeddings train.h5 --val-embeddings val.h5 \\
        --motion-videos-dir motion/ [--dataset mammalnet] [--device cpu]

It trains on the card (``--device``, default ``cuda``) and raises when there
is none; ``--device cpu`` runs on the CPU. ``best/best_model.pth`` under
``--checkpoint-dir`` is a reference-layout student state dict, which
``vimo-export-motion-torch --torch-checkpoint`` and
``vimo-predict-torch --student-torch-checkpoint`` read.
"""

from __future__ import annotations

import argparse
import logging

from vimoclip_tpu_torch.utils.logging import setup_logging


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="Train the MoCLIP motion student "
                                            "(PyTorch/CUDA port)")
    # reference defaults (train.py:178-216), batch 8 as in the JAX package
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--grad-accum", type=int, default=1,
                   help="accumulate gradients over N equal microbatches before each "
                        "Adam step: the --batch-size loss at batch_size/N activation memory")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--grad-clip", type=float, default=None)
    p.add_argument("--distill-mode", choices=["mse", "cosine"], default="cosine")
    p.add_argument("--num-classes", type=int, default=140)
    p.add_argument("--sequence-length", type=int, default=30)
    p.add_argument("--residual-alpha", type=float, default=0.1)
    p.add_argument("--class-pos-weight", type=float, default=9.0)
    p.add_argument("--seed", type=int, default=49)
    p.add_argument("--train-embeddings", required=True, help="teacher HDF5 (train)")
    p.add_argument("--val-embeddings", required=True, help="teacher HDF5 (val)")
    p.add_argument("--motion-videos-dir", required=True,
                   help="flow or frame-diff video directory")
    p.add_argument("--checkpoint-dir", default="checkpoints/student")
    p.add_argument("--log-dir", default="logs/student")
    p.add_argument("--clip-weights", default=None,
                   help="CLIP init for the backbone (safetensors/.pt/.pth/HF dir); "
                        "random init from --seed if omitted")
    p.add_argument("--dataset", choices=["ak", "mammalnet"], default="ak",
                   help="mammalnet = CE loss, nested trimmed_videos/ groups, 224x224 "
                        "frames (train_frame_diff_mn.py)")
    p.add_argument("--float32", action="store_true")
    p.add_argument("--checkpoint-every-steps", type=int, default=None,
                   help="also checkpoint mid-epoch every N steps")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint, mid-epoch ones included "
                        "(exact-batch resume)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card is an error")
    p.add_argument("--data-parallel", type=int, default=-1,
                   help="values above 1 need the multi-GPU slice (slice 7)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="values above 1 need the multi-GPU slice (slice 7)")
    args = p.parse_args(argv)
    if args.data_parallel > 1 or args.model_parallel > 1:
        p.error("--data-parallel / --model-parallel > 1 come with the multi-GPU "
                "slice of the port (ROADMAP slice 7)")

    setup_logging()
    from vimoclip_tpu_torch.data.segment_dataset import SegmentDataset
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig
    from vimoclip_tpu_torch.train.student_trainer import StudentTrainer

    nested = "trimmed_videos" if args.dataset == "mammalnet" else None
    spatial = (224, 224) if args.dataset == "mammalnet" else None
    train_ds, val_ds = (
        SegmentDataset(path, args.motion_videos_dir, sequence_length=args.sequence_length,
                       nested_prefix=nested, spatial_size=spatial)
        for path in (args.train_embeddings, args.val_embeddings))
    logging.info("train segments: %d, val segments: %d", len(train_ds), len(val_ds))

    pretrained = None
    if args.clip_weights:
        from vimoclip_tpu_torch.models.pretrained import load_clip_vision

        vision_config, pretrained = load_clip_vision(args.clip_weights)
    else:
        vision_config = ClipVisionConfig.vit_b_32()

    trainer = StudentTrainer(
        train_ds, val_ds, checkpoint_dir=args.checkpoint_dir, log_dir=args.log_dir,
        vision_config=vision_config, pretrained_state=pretrained,
        num_classes=args.num_classes, alpha=args.residual_alpha, lr=args.lr,
        batch_size=args.batch_size, num_workers=args.num_workers, epochs=args.epochs,
        distill_mode=args.distill_mode,
        class_loss="ce" if args.dataset == "mammalnet" else "bce",
        class_pos_weight=args.class_pos_weight, grad_clip=args.grad_clip, seed=args.seed,
        half_precision=not args.float32,
        checkpoint_every_steps=args.checkpoint_every_steps, resume=args.resume,
        grad_accum=args.grad_accum, device=args.device,
    )
    best = trainer.train()
    logging.info("best val total loss: %.4f", best)


if __name__ == "__main__":
    main()
