"""``vimo-pipeline-torch``: the whole cascade from one command (the port's
copy of ``vimoclip_tpu/cli/run_pipeline.py``).

    python -m vimoclip_tpu_torch.cli.run_pipeline --workdir run \\
        --data-root videos/ --train-annotations train.txt \\
        --val-annotations val.txt --class-file classes.csv \\
        --clip-weights clip.pt --tfam-config tfam.yaml [--device cpu]

Extract -> motion -> distil -> export -> fuse/eval, with a fixed artifact
layout under ``--workdir`` and stages that skip once done: rerun the same
command after a crash and only the missing stages run
(``vimoclip_tpu_torch/pipeline.py``). It runs on the card (``--device``,
default ``cuda``) and raises when there is none. A training stage with more
than one rank (``--data-parallel`` x ``--model-parallel`` for stage 1, the
YAML's for stage 2) runs under ``torchrun``.
"""

from __future__ import annotations

import argparse
import json
import logging

from vimoclip_tpu_torch.utils.logging import setup_logging


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(
        description="Run the full ViMoCLIP cascade (extract -> motion -> "
                    "distill -> export -> fuse/eval), PyTorch/CUDA port"
    )
    p.add_argument("--workdir", required=True,
                   help="artifact directory (fixed layout; reruns resume)")
    p.add_argument("--data-root", required=True, help="RGB video directory")
    p.add_argument("--train-annotations", required=True)
    p.add_argument("--val-annotations", required=True)
    p.add_argument("--class-file", required=True, help="id,name csv")
    p.add_argument("--clip-weights", required=True,
                   help="CLIP weights for teacher + student init")
    p.add_argument("--tfam-config", required=True,
                   help="stage-2 YAML (data paths are injected)")
    p.add_argument("--dataset", choices=["ak", "mammalnet"], default="ak",
                   help="mammalnet = CE-loss nested-group stage-1 (the "
                        "TFAM YAML must set training.loss: ce itself)")
    p.add_argument("--motion-kind", choices=["frame_diff", "flow"],
                   default="frame_diff")
    p.add_argument("--flow-backend", choices=["farneback", "raft"],
                   default="farneback")
    p.add_argument("--flow-weights", default=None)
    p.add_argument("--num-classes", type=int, default=140)
    p.add_argument("--extract-batch", type=int, default=256)
    p.add_argument("--student-epochs", type=int, default=10)
    p.add_argument("--student-batch", type=int, default=8)
    p.add_argument("--sequence-length", type=int, default=30)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--data-parallel", type=int, default=-1,
                   help="stage-0 tower replicas (when > 1) and the stage-1 mesh "
                        "data axis (-1 = every card); stage 2 reads its own "
                        "training.data_parallel")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="stage-1 mesh model axis")
    p.add_argument("--float32", action="store_true")
    p.add_argument("--force", action="store_true",
                   help="rerun every stage even when artifacts exist")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card is an error")
    args = p.parse_args(argv)

    setup_logging(log_file=None)
    from vimoclip_tpu_torch.pipeline import PipelineConfig, run_pipeline

    artifacts = run_pipeline(PipelineConfig(
        workdir=args.workdir, data_root=args.data_root,
        train_annotations=args.train_annotations,
        val_annotations=args.val_annotations,
        class_file=args.class_file, clip_weights=args.clip_weights,
        tfam_config=args.tfam_config, dataset=args.dataset,
        motion_kind=args.motion_kind,
        flow_backend=args.flow_backend, flow_weights=args.flow_weights,
        num_classes=args.num_classes, extract_batch=args.extract_batch,
        student_epochs=args.student_epochs, student_batch=args.student_batch,
        sequence_length=args.sequence_length, num_workers=args.num_workers,
        data_parallel=args.data_parallel, model_parallel=args.model_parallel,
        half_precision=not args.float32, force=args.force, device=args.device,
    ))
    logging.info("pipeline complete")
    print(json.dumps(artifacts, indent=2))


if __name__ == "__main__":
    main()
