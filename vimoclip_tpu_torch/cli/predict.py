"""Single-command inference: raw video file(s) -> top-k action predictions
(the port's copy of ``vimoclip_tpu/cli/predict.py``).

    python -m vimoclip_tpu_torch.cli.predict VIDEO... \\
        --teacher-weights clip.safetensors \\
        --student-torch-checkpoint student_best.pth \\
        --tfam-torch-checkpoint best_model.pth --tfam-config cfg.yaml

Weights are reference-format files: the CLIP visual tower (safetensors /
torch state dict / HF dir, ``models/pretrained.py``), the stage-1
``student_best.pth`` and the stage-2 ``best_model.pth``. Orbax checkpoint
directories are not read here: ``vimo-convert`` exports them to ``.pth``.
``--quantize int8`` (both towers) and ``--token-merge R`` (the teacher) are
opt-in approximations; ``--verify-fidelity N`` measures them on the first
video before any prediction and stops below ``--fidelity-threshold``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os

from vimoclip_tpu_torch.utils.logging import setup_logging


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--teacher-weights", required=True,
                   help="CLIP visual weights (safetensors/.pt/.pth/HF dir)")
    p.add_argument("--student-torch-checkpoint", default=None,
                   help="reference-format student_best.pth (DataParallel "
                        "'module.' prefix handled)")
    p.add_argument("--student-clip-weights", default=None,
                   help="vision config source for the student tower; default: "
                        "inferred from the checkpoint's shapes")
    p.add_argument("--student-checkpoint-dir", default=None,
                   help="not read by the port: export it to .pth with vimo-convert")
    p.add_argument("--tfam-config", required=True,
                   help="stage-2 YAML config (model geometry + class names)")
    p.add_argument("--tfam-torch-checkpoint", default=None,
                   help="reference-format best_model.pth")
    p.add_argument("--tfam-checkpoint-dir", default=None,
                   help="not read by the port: export it to .pth with vimo-convert")
    p.add_argument("--motion-videos-dir", default=None,
                   help="precomputed motion videos matched by filename; "
                        "default: frame-diff of the RGB frames on the device")
    p.add_argument("--top-k", type=int, default=5)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--output", default=None, help="write predictions JSON here")
    p.add_argument("--frame-batch", type=int, default=128)
    p.add_argument("--float32", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card is an error")
    p.add_argument("--quirk-batch-pooling", action="store_true",
                   help="restore the reference's batch-max pooling for "
                        "multi-video requests")
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="opt-in dynamic-int8 matmuls in both ViT towers "
                        "(ops/quant.py): approximate, not the default path")
    p.add_argument("--token-merge", type=int, default=0, metavar="R",
                   help="opt-in ToMe token merging in the teacher tower "
                        "(ops/tome.py): approximate, not the default path")
    p.add_argument("--verify-fidelity", type=int, default=0, metavar="N",
                   help="before predicting, run N frames sampled from the "
                        "first video through both the exact and the "
                        "--quantize/--token-merge towers and log the cosine "
                        "(fidelity.py); stops below --fidelity-threshold")
    p.add_argument("--fidelity-threshold", type=float, default=0.97,
                   help="minimum per-frame cosine the --verify-fidelity probe "
                        "must reach (default 0.97)")
    p.add_argument("--data-parallel", type=int, default=1,
                   help="one replica of each tower on each of N cards (cuda:0..N-1; "
                        "N times the CPU with --device cpu), each fixed-shape "
                        "frame batch split over them (--frame-batch must divide "
                        "by N)")


def validate_model_args(p: argparse.ArgumentParser, args) -> None:
    for flag in ("student_checkpoint_dir", "tfam_checkpoint_dir"):
        if getattr(args, flag):
            p.error(f"--{flag.replace('_', '-')}: Orbax checkpoint directories "
                    "are not read by the port; export them to reference .pth "
                    "files with `vimo-convert` and pass --*-torch-checkpoint")
    if args.tfam_torch_checkpoint is None:
        p.error("--tfam-torch-checkpoint is required")
    if args.student_torch_checkpoint is None:
        p.error("--student-torch-checkpoint is required")


def build_predictor(args, probe_video: str | None = None):
    """Load the three stages' weights and build the predictor (shared by
    vimo-predict-torch and vimo-serve-torch). ``probe_video`` feeds the
    --verify-fidelity guard."""
    from vimoclip_tpu_torch.config import load_experiment_config
    from vimoclip_tpu_torch.extraction import load_class_names
    from vimoclip_tpu_torch.models.convert import (
        student_visual_state_from_checkpoint,
        tfam_state_from_checkpoint,
    )
    from vimoclip_tpu_torch.models.pretrained import load_clip_vision
    from vimoclip_tpu_torch.parallel.mesh import replica_devices
    from vimoclip_tpu_torch.serving import ViMoCLIPPredictor

    cfg = load_experiment_config(args.tfam_config)
    teacher_config, teacher_state = load_clip_vision(args.teacher_weights)
    student_config = None
    if args.student_clip_weights:
        student_config, _ = load_clip_vision(args.student_clip_weights)
    student_config, student_state = student_visual_state_from_checkpoint(
        args.student_torch_checkpoint, student_config
    )
    if args.quantize or args.token_merge:
        # the flags add to, never clear, what the loaded configs carry; the
        # student's 50 tokens are too few for merging to pay (as in JAX)
        teacher_config = dataclasses.replace(
            teacher_config, matmul_quant=args.quantize or teacher_config.matmul_quant,
            token_merge_r=args.token_merge or teacher_config.token_merge_r)
        student_config = dataclasses.replace(
            student_config, matmul_quant=args.quantize or student_config.matmul_quant)
    tfam_state = tfam_state_from_checkpoint(args.tfam_torch_checkpoint)

    if args.verify_fidelity and probe_video is not None:
        from vimoclip_tpu_torch.fidelity import (
            check_encoder_fidelity,
            sample_motion_probe_frames,
        )

        common = dict(half_precision=not args.float32, device=args.device)
        if teacher_config.matmul_quant or teacher_config.token_merge_r:
            check_encoder_fidelity(teacher_state, teacher_config, probe_video,
                                   args.verify_fidelity, args.fidelity_threshold,
                                   encoder_name="teacher ViT", **common)
        if student_config.matmul_quant or student_config.token_merge_r:
            # the cascade feeds the student frame differences: probe on those
            check_encoder_fidelity(
                student_state, student_config, probe_video,
                args.verify_fidelity, args.fidelity_threshold,
                encoder_name="student ViT (frame-diff probe)",
                frames=sample_motion_probe_frames(probe_video, args.verify_fidelity,
                                                  device=args.device),
                **common)

    class_names: dict[int, str] = {}
    path = cfg.data.class_names_dir
    if path and os.path.exists(path):
        class_names = load_class_names(path)

    return ViMoCLIPPredictor(
        teacher_state=teacher_state, teacher_config=teacher_config,
        student_state=student_state, student_config=student_config,
        tfam_state=tfam_state, tfam_config=cfg.model,
        num_classes=cfg.num_classes, class_names=class_names,
        frame_batch=args.frame_batch,
        length_bucket=cfg.data.length_bucket,
        max_seq_len=cfg.data.max_seq_len,
        half_precision=not args.float32,
        batch_invariant=not args.quirk_batch_pooling,
        device=args.device,
        devices=(replica_devices(args.data_parallel, args.device)
                 if args.data_parallel > 1 else None),
    )


def find_motion_match(motion_videos_dir: str | None, video: str) -> str | None:
    """A precomputed motion video with the same filename stem."""
    if not motion_videos_dir:
        return None
    stem = os.path.splitext(os.path.basename(video))[0]
    for ext in (".mp4", ".avi", ".mkv", ".webm"):
        cand = os.path.join(motion_videos_dir, stem + ext)
        if os.path.exists(cand):
            return cand
    return None


def prediction_record(video: str, pred) -> dict:
    return {
        "video": video,
        "predictions": [
            {"class_id": cid, "class_name": name, "probability": round(prob, 4)}
            for cid, name, prob in pred.top_classes
        ],
    }


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(
        description="Predict actions for raw videos (full fused cascade, "
                    "PyTorch/CUDA port)"
    )
    p.add_argument("videos", nargs="+", help="video file(s)")
    add_model_args(p)
    args = p.parse_args(argv)
    validate_model_args(p, args)

    setup_logging(log_file=None)
    predictor = build_predictor(args, probe_video=args.videos[0])
    results = []
    for video in args.videos:
        pred = predictor.predict(
            video, motion_video_path=find_motion_match(args.motion_videos_dir, video),
            top_k=args.top_k, max_frames=args.max_frames,
        )
        results.append(prediction_record(video, pred))
        top = pred.top_classes[0]
        logging.info("%s -> %s (p=%.3f)", video, top[1], top[2])
        for _, name, prob in pred.top_classes:
            print(f"  {name:<30s} {prob:.4f}")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
        logging.info("predictions written to %s", args.output)


if __name__ == "__main__":
    main()
