"""Host-side video decode and encode (the port's copy of
``vimoclip_tpu/data/video_reader.py``): OpenCV, or for whole videos and
windows the C++ libav data plane (``data/native.py``) when it is built and
``VIMO_NATIVE_DECODE=1`` opts in. ``cv2`` is imported inside each function:
the package imports without it. Frames are RGB uint8 NHWC numpy."""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np


def _native_backend():
    """``data/native.py`` when the library is built and opted in
    (``VIMO_NATIVE_DECODE=1``), else None. Opt-in: its decode pool wins on
    hosts with many cores, while OpenCV's SIMD colour conversion is faster
    per core; both give the same frames (tests/test_torch_native.py)."""
    if os.environ.get("VIMO_NATIVE_DECODE", "0") != "1":
        return None
    from vimoclip_tpu_torch.data import native

    return native if native.available() else None


def _open(path: str):
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"could not open video {path}")
    return cap


def _read_frames(cap, limit: int | None) -> list[np.ndarray]:
    import cv2

    frames = []
    while limit is None or len(frames) < limit:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    return frames


def video_frame_count(path: str) -> int:
    """The container's frame count (0 when it reports none)."""
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()
    return max(n, 0)


def read_video(path: str, max_frames: int | None = None) -> np.ndarray:
    """Decode a whole video -> (T, H, W, 3) RGB uint8."""
    native = _native_backend()
    if native is not None:
        return native.read_video(path, max_frames=max_frames)
    cap = _open(path)
    try:
        frames = _read_frames(cap, max_frames)
    finally:
        cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(frames)


def read_video_window(path: str, start: int, num_frames: int) -> np.ndarray:
    """Decode exactly ``[start, start + num_frames)`` -> (n, H, W, 3) RGB
    uint8 (n <= num_frames near the end), seeking instead of decoding the
    frames before ``start``."""
    native = _native_backend()
    if native is not None:
        return native.read_video_window(path, start, num_frames)
    import cv2

    cap = _open(path)
    try:
        if start > 0:
            cap.set(cv2.CAP_PROP_POS_FRAMES, start)
        frames = _read_frames(cap, num_frames)
    finally:
        cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path} at {start}")
    return np.stack(frames)


def iter_video_chunks(path: str, chunk_size: int = 64) -> Iterator[np.ndarray]:
    """Stream a video in chunks of (<= chunk_size, H, W, 3): the exporter's
    bounded-memory access pattern."""
    cap = _open(path)
    try:
        while True:
            chunk = _read_frames(cap, chunk_size)
            if not chunk:
                break
            yield np.stack(chunk)
            if len(chunk) < chunk_size:
                break
    finally:
        cap.release()


def write_video(path: str, frames: np.ndarray, fps: float = 30.0,
                is_color: bool | None = None) -> None:
    """Encode (T, H, W, 3) RGB or (T, H, W) gray uint8 frames to mp4."""
    import cv2

    gray = frames.ndim == 3
    if is_color is None:
        is_color = not gray
    h, w = frames.shape[1:3]
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h),
                          isColor=is_color)
    if not out.isOpened():
        raise IOError(f"could not open video writer for {path}")
    try:
        for f in frames:
            out.write(f if gray else cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    finally:
        out.release()
