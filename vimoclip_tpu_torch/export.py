"""Motion-embedding export (the port's copy of ``vimoclip_tpu/export.py``):
run the trained student's CLIP tower over motion videos and write per-video
(T, P) embeddings to HDF5, the bridge from stage 1 to stage 2.

Reference parity (inference.py, inference_frame_diff.py):
- the RAW tower embeddings are written (the student's first output, not the
  distillation branch);
- groups are keyed by the video's basename without extension;
- videos stream in bounded chunks into resizable lzf/gzip datasets, flushed
  after every chunk;
- resume skips finished groups; a video that fails, or finds the host short
  of RAM between chunks, is recorded in its group's attrs and the run goes
  on.

On the card, frames go up as uint8 and are normalised there (kernel K5 when
they have the encoder's size). Every chunk has one shape (the tail is
zero-padded and the pad rows dropped), so cuBLAS keeps one algorithm and
the tail's embeddings do not depend on how full its chunk is. ``h5py`` and
``cv2`` are imported when called.
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Mapping

import numpy as np
import torch

from vimoclip_tpu_torch.data.video_reader import iter_video_chunks
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
from vimoclip_tpu_torch.models.convert import student_tower_state, to_tensors
from vimoclip_tpu_torch.ops.batching import pad_to_batch, upload
from vimoclip_tpu_torch.ops.preprocess import clip_preprocess
from vimoclip_tpu_torch.utils.device import resolve_device


class LowMemoryError(RuntimeError):
    """Free host RAM fell below the floor (inference_frame_diff.py:32-38)."""


def free_ram_gb() -> float:
    """Available host RAM in GB (psutil, else /proc/meminfo, else inf)."""
    try:
        import psutil

        return psutil.virtual_memory().available / 1e9
    except ImportError:
        pass
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return float("inf")


def memory_guard(min_free_gb: float) -> None:
    free = free_ram_gb()
    if free < min_free_gb:
        raise LowMemoryError(f"free RAM {free:.1f} GB < floor {min_free_gb} GB")


def find_motion_videos(videos_dir: str, extensions=(".mp4", ".avi", ".mkv")) -> list[str]:
    """Every motion video under ``videos_dir``, recursively (MammalNet nests
    its videos under ``trimmed_videos/``), sorted."""
    paths: list[str] = []
    for ext in extensions:
        paths.extend(glob.glob(os.path.join(videos_dir, "**", f"*{ext}"), recursive=True))
    return sorted(paths)


class MotionEmbeddingExporter:
    """``student_state``: a student state dict (reference layout, or just
    its tower in the ``ClipVisionEncoder`` layout); only the tower is used."""

    def __init__(self, student_state: Mapping, vision_config: ClipVisionConfig,
                 chunk_size: int = 128, half_precision: bool = True,
                 compression: str | None = "lzf", min_free_gb: float = 2.0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.vision_config = vision_config
        self.chunk_size = chunk_size
        self.compression = compression
        self.min_free_gb = min_free_gb
        self.dtype = torch.bfloat16 if half_precision else torch.float32
        encoder = ClipVisionEncoder(vision_config, dtype=self.dtype)
        encoder.load_state_dict(to_tensors(student_tower_state(student_state)), strict=True)
        self.encoder = encoder.to(self.device).eval().requires_grad_(False)

    @torch.inference_mode()
    def _embed_chunk(self, frames: np.ndarray) -> np.ndarray:
        """(n <= chunk_size, H, W, 3) uint8 -> (n, P) float32 embeddings."""
        n = frames.shape[0]
        x = upload(pad_to_batch(frames, self.chunk_size), self.device)
        pixels = clip_preprocess(x, self.vision_config.image_size, dtype=self.dtype)
        return self.encoder(pixels).float()[:n].cpu().numpy()

    def export(self, video_paths: list[str], output_h5: str, overwrite: bool = False,
               resize_to: tuple[int, int] | None = None) -> dict[str, int]:
        """Returns {"processed": n, "skipped": n, "errors": n}."""
        import h5py

        counts = {"processed": 0, "skipped": 0, "errors": 0}
        # groups are keyed by basename stem while the videos are found
        # recursively: a/clip.mp4 and b/clip.mp4 would collide, the second
        # read as a resume skip and never exported
        stems: dict[str, str] = {}
        for path in video_paths:
            stem = os.path.splitext(os.path.basename(path))[0]
            if stem in stems and stems[stem] != path:
                raise ValueError(
                    f"duplicate video id {stem!r}: {stems[stem]} and {path} would "
                    "overwrite each other in the HDF5 (groups are keyed by basename "
                    "stem, the reference scheme) — rename one or export the "
                    "subdirectories separately")
            stems[stem] = path
        with h5py.File(output_h5, "w" if overwrite else "a") as h5f:
            for path in video_paths:
                video_id = os.path.splitext(os.path.basename(path))[0]
                if video_id in h5f:
                    g = h5f[video_id]
                    # trusted on resume: complete=True, or a reference-written
                    # group (total_frames and no 'complete' attr); ours that a
                    # crash cut short say complete=False or carry neither
                    if "embeddings" in g and g.attrs.get("complete", "total_frames" in g.attrs):
                        counts["skipped"] += 1
                        continue
                    del h5f[video_id]  # retry an incomplete or failed group
                try:
                    self._export_one(h5f, video_id, path, resize_to)
                    counts["processed"] += 1
                except LowMemoryError as e:
                    g = h5f.require_group(video_id)
                    g.attrs["skipped_low_ram"] = str(e)
                    g.attrs["complete"] = False
                    counts["errors"] += 1
                    logging.warning("[%s] low RAM: %s", video_id, e)
                except Exception as e:  # recorded in the file; the run goes on
                    g = h5f.require_group(video_id)
                    g.attrs["error"] = str(e)
                    g.attrs["complete"] = False
                    counts["errors"] += 1
                    logging.warning("[%s] failed: %s", video_id, e, exc_info=True)
        logging.info("export done: %d processed, %d skipped (resume), %d errors",
                     counts["processed"], counts["skipped"], counts["errors"])
        return counts

    def _export_one(self, h5f, video_id: str, path: str,
                    resize_to: tuple[int, int] | None) -> None:
        group = h5f.create_group(video_id)
        # the marker goes in before any data: a crash mid-write (even a
        # SIGKILL, where no handler runs) leaves complete=False, retried on
        # resume instead of skipped with partial data
        group.attrs["complete"] = False
        h5f.flush()
        dset, total = None, 0
        for frames in iter_video_chunks(path, chunk_size=self.chunk_size):
            memory_guard(self.min_free_gb)
            if resize_to is not None and frames.shape[1:3] != tuple(resize_to):
                import cv2

                frames = np.stack([cv2.resize(f, (resize_to[1], resize_to[0]))
                                   for f in frames])
            emb = self._embed_chunk(frames)
            if dset is None:
                dset = group.create_dataset(
                    "embeddings", shape=(0, emb.shape[1]), maxshape=(None, emb.shape[1]),
                    chunks=(max(1, min(self.chunk_size, 1024)), emb.shape[1]),
                    dtype="float32", compression=self.compression)
            dset.resize((total + emb.shape[0], emb.shape[1]))
            dset[total:] = emb
            total += emb.shape[0]
            h5f.flush()
        if dset is None:
            raise IOError("no frames decoded")
        group.attrs["total_frames"] = total
        group.attrs["complete"] = True
