"""Offline motion-modality generation (the port's copy of
``vimoclip_tpu/motion.py``).

- ``generate_frame_diff_video``: grayscale absolute difference of
  consecutive frames -> a single-channel video (the reference's
  utils/generate_frame_diff_video.py:7-60). The difference runs on
  ``device`` through ``ops/preprocess.py::frame_diff``, 128 differences per
  round trip; ``device=None`` takes OpenCV on the host.
- ``generate_optical_flow_video``: Farneback dense flow -> HSV(angle, 255,
  min-max normalised magnitude) -> BGR video (utils/generate_of_videos.py:
  8-74), on the host; a learned flow model (the paper's RAFT through
  ptlflow) plugs in as ``flow_fn`` via ``PtlflowAdapter``.
- ``process_video_list``: runs either over a list file, as both reference
  tools do.

``cv2`` is imported where it is used, so the module imports without it.
"""

from __future__ import annotations

import logging
import os
from typing import Callable

import numpy as np
import torch

from vimoclip_tpu_torch.ops.batching import upload
from vimoclip_tpu_torch.utils.device import resolve_device

DIFF_CHUNK = 129  # frames per device round trip: 128 differences


def generate_frame_diff_video(video_path: str, output_path: str,
                              device: str | torch.device | None = "cuda") -> int:
    """Write the frame-diff video of one input; returns its frame count.
    ``device`` (default ``cuda``, an error without a card) runs the
    difference there; ``None`` runs it on the host with OpenCV."""
    import cv2

    dev = None if device is None else resolve_device(device)
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"could not open video {video_path}")
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    out = cv2.VideoWriter(
        output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height),
        isColor=False,
    )
    n = 0
    try:
        ok, prev = cap.read()
        if not ok:
            raise IOError(f"could not read first frame of {video_path}")
        if dev is not None:
            from vimoclip_tpu_torch.ops.preprocess import frame_diff

            def write_diffs(chunk: list[np.ndarray]) -> int:
                frames = upload(np.stack(chunk), dev)
                with torch.inference_mode():
                    diffs = frame_diff(frames, replicate_channels=False).cpu().numpy()
                for d in diffs:
                    out.write(d)
                return len(diffs)

            chunk = [cv2.cvtColor(prev, cv2.COLOR_BGR2RGB)]
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                chunk.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
                if len(chunk) == DIFF_CHUNK:
                    n += write_diffs(chunk)
                    chunk = [chunk[-1]]
            if len(chunk) > 1:
                n += write_diffs(chunk)
        else:
            prev_gray = cv2.cvtColor(prev, cv2.COLOR_BGR2GRAY)
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
                out.write(cv2.absdiff(gray, prev_gray))
                prev_gray = gray
                n += 1
    finally:
        cap.release()
        out.release()
    return n


def farneback_flow(prev_gray: np.ndarray, gray: np.ndarray) -> np.ndarray:
    """The reference's Farneback parameters (generate_of_videos.py:51)."""
    import cv2

    return cv2.calcOpticalFlowFarneback(prev_gray, gray, None, 0.5, 3, 15, 3, 5, 1.2, 0)


def flow_to_hsv_bgr(flow: np.ndarray) -> np.ndarray:
    """HSV(angle/2, 255, min-max magnitude) -> BGR (generate_of_videos.py:53-63)."""
    import cv2

    magnitude, angle = cv2.cartToPolar(flow[..., 0], flow[..., 1])
    hsv = np.zeros(flow.shape[:2] + (3,), dtype=np.uint8)
    hsv[..., 0] = (angle * 180 / np.pi / 2).astype(np.uint8)
    hsv[..., 1] = 255
    hsv[..., 2] = cv2.normalize(magnitude, None, 0, 255, cv2.NORM_MINMAX).astype(np.uint8)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)


class PtlflowAdapter:
    """``flow_fn`` adapter for ptlflow-style torch optical-flow models, the
    way in for the paper's RAFT flow (reference README.md:81-162).

    The wrapped module follows ptlflow's inference interface:
    - input ``{"images": float32 (1, 2, 3, H', W')}``: two RGB frames scaled
      to [0, 1], zero-padded bottom/right to a multiple of ``divisor`` (RAFT
      needs /8 geometry);
    - output: a dict whose ``"flows"`` is (1, 1, 2, H', W'), in pixels.

    ``__call__(prev_bgr, curr_bgr) -> (H, W, 2) float32`` fills the
    ``flow_fn`` slot of ``generate_optical_flow_video``; ``wants_color``
    makes that function feed BGR frames instead of grayscale. The model runs on
    ``device`` (default ``cuda``, an error without a card).
    """

    wants_color = True

    def __init__(self, model, device: str | torch.device = "cuda", divisor: int = 8):
        self.device = resolve_device(device)
        self.divisor = divisor
        self.model = model.eval().to(self.device)

    @classmethod
    def from_weights(
        cls,
        weights: str | None = None,
        model_name: str = "raft",
        device: str | torch.device = "cuda",
        divisor: int = 8,
    ) -> "PtlflowAdapter":
        """From ptlflow (``model_name`` + a checkpoint name or path, the
        README's recipe) when it is installed, else from a whole serialized
        torch module (``torch.save(model)`` / ``torch.jit.save``)."""
        try:
            import ptlflow  # optional, not installed here

            model = ptlflow.get_model(model_name, ckpt_path=weights)
        except ImportError:
            if not weights:
                raise
            try:
                model = torch.jit.load(weights, map_location="cpu")
            except Exception:
                model = torch.load(weights, map_location="cpu", weights_only=False)
            if not hasattr(model, "eval"):
                raise TypeError(
                    f"{weights} is not a serialized torch module; without "
                    "ptlflow installed, --flow-weights must hold a full "
                    "module (torch.save(model) or torch.jit.save)"
                )
        return cls(model, device=device, divisor=divisor)

    def __call__(self, prev_frame: np.ndarray, frame: np.ndarray) -> np.ndarray:
        h, w = prev_frame.shape[:2]
        pair = np.stack([prev_frame[..., ::-1], frame[..., ::-1]])  # BGR -> RGB
        images = (
            torch.from_numpy(np.ascontiguousarray(pair))
            .permute(0, 3, 1, 2)
            .float()
            / 255.0
        )
        pad_h, pad_w = (-h) % self.divisor, (-w) % self.divisor
        if pad_h or pad_w:
            images = torch.nn.functional.pad(images, (0, pad_w, 0, pad_h))
        with torch.no_grad():
            preds = self.model({"images": images.unsqueeze(0).to(self.device)})
        flow = preds["flows"][0, 0].cpu().numpy().transpose(1, 2, 0)
        return np.ascontiguousarray(flow[:h, :w]).astype(np.float32)


def load_flow_backend(
    backend: str = "farneback",
    weights: str | None = None,
    device: str | torch.device = "cuda",
    model_name: str = "raft",
    divisor: int = 8,
) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """A ``flow_fn`` by name: ``farneback`` (OpenCV, on the host) or
    ``raft`` (any ptlflow model through ``PtlflowAdapter`` on ``device``;
    ``model_name`` picks the ptlflow architecture, ``divisor`` its stride)."""
    if backend == "farneback":
        return farneback_flow
    if backend == "raft":
        return PtlflowAdapter.from_weights(
            weights=weights, model_name=model_name, device=device,
            divisor=divisor,
        )
    raise ValueError(f"unknown flow backend {backend!r}")


def generate_optical_flow_video(
    video_path: str,
    output_path: str,
    flow_fn: Callable[[np.ndarray, np.ndarray], np.ndarray] = farneback_flow,
) -> int:
    """``flow_fn(prev, curr) -> (H, W, 2)``, fed grayscale frames, or BGR
    frames when it sets ``wants_color``; returns the frame count."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"could not open video {video_path}")
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    out = cv2.VideoWriter(
        output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height)
    )
    wants_color = bool(getattr(flow_fn, "wants_color", False))
    n = 0
    try:
        ok, first = cap.read()
        if not ok:
            raise IOError(f"could not read first frame of {video_path}")
        prev = first if wants_color else cv2.cvtColor(first, cv2.COLOR_BGR2GRAY)
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            cur = frame if wants_color else cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            out.write(flow_to_hsv_bgr(flow_fn(prev, cur)))
            prev = cur
            n += 1
    finally:
        cap.release()
        out.release()
    return n


def process_video_list(
    list_file: str,
    input_dir: str,
    output_dir: str,
    kind: str = "frame_diff",
    skip_existing: bool = True,
    flow_fn: Callable[[np.ndarray, np.ndarray], np.ndarray] | None = None,
    device: str | torch.device | None = "cuda",
) -> dict[str, str]:
    """Generate from a video-list file (one relative path per line,
    generate_frame_diff_video.py:63-93); ``device`` is the frame
    difference's. Returns {video: error} for the failures."""
    if kind == "frame_diff" and device is not None:
        device = resolve_device(device)  # no card: raise before any video
    os.makedirs(output_dir, exist_ok=True)
    errors: dict[str, str] = {}
    with open(list_file) as f:
        names = [l.strip() for l in f if l.strip()]
    for name in names:
        src = os.path.join(input_dir, name)
        dst = os.path.join(output_dir, name)
        os.makedirs(os.path.dirname(dst) or output_dir, exist_ok=True)
        if skip_existing and os.path.exists(dst):
            continue
        try:
            if kind == "frame_diff":
                generate_frame_diff_video(src, dst, device=device)
            else:
                generate_optical_flow_video(src, dst,
                                            flow_fn=flow_fn or farneback_flow)
        except Exception as e:
            errors[name] = str(e)
            logging.warning("%s: %s", name, e)
    return errors
