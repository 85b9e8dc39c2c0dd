"""Host-side video decode with OpenCV (the port's copy of
``vimoclip_tpu/data/video_reader.py::read_video``). ``cv2`` is imported
inside the function: the package imports without it. The native libav
backend of the JAX package is not ported in this slice."""

from __future__ import annotations

import numpy as np


def read_video(path: str, max_frames: int | None = None) -> np.ndarray:
    """Decode a whole video -> (T, H, W, 3) RGB uint8."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"could not open video {path}")
    frames = []
    try:
        while max_frames is None or len(frames) < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(frames)
