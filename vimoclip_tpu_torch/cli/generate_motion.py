"""Offline motion-video generation CLI (the port's copy of
``vimoclip_tpu/cli/generate_motion.py``; the reference's
``utils/generate_frame_diff_video.py`` and ``utils/generate_of_videos.py``).

    python -m vimoclip_tpu_torch.cli.generate_motion \\
        --list-file videos.txt --input-dir videos/ --output-dir motion/ \\
        [--kind flow --flow-backend raft --flow-weights raft.pt] [--device cpu]

The frame difference and a ``raft`` flow model run on the card (``--device``,
default ``cuda``; an error without one), ``--device cpu`` on the CPU.
Farneback flow runs on the host with OpenCV.
"""

from __future__ import annotations

import argparse

from vimoclip_tpu_torch.utils.logging import setup_logging


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="Generate motion-modality videos "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--list-file", required=True, help="one relative video path per line")
    p.add_argument("--input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--kind", choices=["frame_diff", "flow"], default="frame_diff")
    p.add_argument("--flow-backend", choices=["farneback", "raft"],
                   default="farneback",
                   help="flow estimator for --kind flow (raft = ptlflow-style "
                        "torch model, the paper's backbone)")
    p.add_argument("--flow-weights", default=None,
                   help="raft backend: ptlflow checkpoint name/path, or a "
                        "serialized torch module when ptlflow is absent")
    p.add_argument("--flow-model", default="raft",
                   help="ptlflow architecture name for --flow-backend raft "
                        "(e.g. raft, gma, flowformer); used only when "
                        "ptlflow is installed")
    p.add_argument("--flow-device", default=None,
                   help="torch device of the raft backend (default: --device)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card is an error")
    p.add_argument("--no-skip-existing", action="store_true")
    args = p.parse_args(argv)

    setup_logging(log_file=None)
    from vimoclip_tpu_torch.motion import load_flow_backend, process_video_list

    flow_fn = None
    if args.kind == "flow":
        flow_fn = load_flow_backend(
            args.flow_backend, weights=args.flow_weights,
            device=args.flow_device or args.device, model_name=args.flow_model,
        )
    errors = process_video_list(
        args.list_file, args.input_dir, args.output_dir, kind=args.kind,
        skip_existing=not args.no_skip_existing, flow_fn=flow_fn,
        device=args.device,
    )
    if errors:
        print(f"{len(errors)} videos failed")


if __name__ == "__main__":
    main()
