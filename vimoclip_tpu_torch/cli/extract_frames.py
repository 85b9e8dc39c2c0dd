"""Sample aligned frames from RGB / flow / frame-diff videos to JPEGs (the
port's copy of ``vimoclip_tpu/cli/extract_frames.py``; the reference's
``utils/extract_paper_images.py``): N uniformly spaced frame indices, the
same for every modality given, so the saved images line up for figures.

    python -m vimoclip_tpu_torch.cli.extract_frames --rgb v.mp4 \\
        [--flow f.mp4] [--frame-diff d.mp4] [--out-dir paper_images]

Host-only (OpenCV): no device work.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from vimoclip_tpu_torch.data.video_reader import read_video


def save_aligned_frames(
    videos: dict[str, str], out_dir: str, num_frames: int = 4
) -> list[str]:
    """``videos`` maps a modality name to a video path; returns the saved paths."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    saved = []
    decoded = {name: read_video(path) for name, path in videos.items()}
    t_min = min(v.shape[0] for v in decoded.values())
    indices = np.linspace(0, t_min - 1, num_frames).astype(int)
    for name, frames in decoded.items():
        for j, idx in enumerate(indices):
            path = os.path.join(out_dir, f"{name}_{j:02d}_frame{idx:04d}.jpg")
            cv2.imwrite(path, cv2.cvtColor(frames[idx], cv2.COLOR_RGB2BGR))
            saved.append(path)
    return saved


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="Extract aligned figure frames "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--rgb", required=True)
    p.add_argument("--flow", default=None)
    p.add_argument("--frame-diff", default=None)
    p.add_argument("--out-dir", default="paper_images")
    p.add_argument("--num-frames", type=int, default=4)
    args = p.parse_args(argv)

    videos = {"rgb": args.rgb}
    if args.flow:
        videos["flow"] = args.flow
    if args.frame_diff:
        videos["frame_diff"] = args.frame_diff
    saved = save_aligned_frames(videos, args.out_dir, args.num_frames)
    print(f"saved {len(saved)} frames to {args.out_dir}")


if __name__ == "__main__":
    main()
