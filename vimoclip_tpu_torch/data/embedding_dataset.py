"""Paired RGB/motion embedding dataset for TFAM (the port's copy of
``vimoclip_tpu/data/embedding_dataset.py``).

- One item is the whole (T, D) RGB sequence and (T-1, D) motion sequence of
  one video, from two HDF5 files; the motion key is the RGB key without its
  file extension.
- ``num_frames`` subsamples sparsely (linspace, truncated); ``max_frames``
  drops videos with T >= max_frames.
- The flat AK layout and the nested MN layout (``trimmed_videos/<id>``
  groups, whose motion keys are the flat basenames) both load; the
  reference's own MN dataset sees one unusable group there (QUIRKS #24).
- ``collate_pad`` pads both streams to the batch max, rounded up to
  ``bucket``, and returns validity masks (True = real frame).

``h5py`` is imported when a dataset is built, so ``collate_pad`` and the
module import where it is not installed.
"""

from __future__ import annotations

import threading

import numpy as np

from vimoclip_tpu_torch.ops.batching import pad_sequences


def sparse_sample_indices(total_frames: int, num_frames: int) -> np.ndarray:
    """torch.linspace(0, T-1, n).long() semantics (truncation toward zero)."""
    return np.linspace(0, total_frames - 1, num_frames).astype(np.int64)


class PairedEmbeddingDataset:
    """Map-style dataset over (RGB embeddings h5, motion embeddings h5)."""

    def __init__(self, rgb_path: str, motion_path: str,
                 num_frames: int | None = None, max_frames: int | None = None):
        import h5py

        self.rgb_path = rgb_path
        self.motion_path = motion_path
        self.num_frames = num_frames
        with h5py.File(rgb_path, "r") as f:
            keys: list[str] = []
            for k, node in f.items():
                if not isinstance(node, h5py.Group):
                    continue
                if "embeddings" in node:
                    keys.append(k)
                else:  # MN: one level of nesting
                    keys.extend(
                        f"{k}/{c}" for c, sub in node.items()
                        if isinstance(sub, h5py.Group) and "embeddings" in sub
                    )
            if max_frames:
                keys = [k for k in keys if f[k]["embeddings"].shape[0] < max_frames]
            self.keys = keys
        # opened on first use; loader threads share the handles
        self._rgb_file = None
        self._motion_file = None
        self._open_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.keys)

    def _files(self):
        import h5py

        with self._open_lock:
            if self._motion_file is None:
                self._rgb_file = h5py.File(self.rgb_path, "r")
                self._motion_file = h5py.File(self.motion_path, "r")
        return self._rgb_file, self._motion_file

    def __getitem__(self, idx: int) -> dict:
        rgb_f, motion_f = self._files()
        video_id = self.keys[idx]
        g = rgb_f[video_id]
        embeddings = g["embeddings"][:].astype(np.float32)
        labels = g["labels"][:].astype(np.float32)
        motion_id = video_id.split(".")[0]
        if motion_id not in motion_f:
            # MN: nested rgb keys pair with flat motion basenames
            motion_id = motion_id.rsplit("/", 1)[-1]
        motion = motion_f[motion_id]["embeddings"][:].astype(np.float32)
        if self.num_frames:
            if embeddings.shape[0] > self.num_frames:
                embeddings = embeddings[
                    sparse_sample_indices(embeddings.shape[0], self.num_frames)]
            if motion.shape[0] > self.num_frames:
                motion = motion[sparse_sample_indices(motion.shape[0], self.num_frames)]
        return {"video_id": video_id, "embeddings": embeddings,
                "motion_embeddings": motion, "labels": labels}

    def close(self) -> None:
        with self._open_lock:
            for f in (self._rgb_file, self._motion_file):
                if f is not None:
                    f.close()
            self._rgb_file = self._motion_file = None


def collate_pad(items: list[dict], bucket: int | None = None,
                max_seq_len: int | None = None) -> dict:
    """Pad variable-length sequences and build validity masks (True =
    real); ``bucket`` rounds the padded length up, ``max_seq_len`` caps it
    (longer sequences are truncated): ``ops/batching.py::pad_sequences``."""
    rgb, mask_rgb = pad_sequences([it["embeddings"] for it in items], bucket, max_seq_len)
    motion, mask_motion = pad_sequences([it["motion_embeddings"] for it in items],
                                        bucket, max_seq_len)
    return {
        "video_id": [it["video_id"] for it in items],
        "embeddings": rgb,
        "motion_embeddings": motion,
        "labels": np.stack([it["labels"] for it in items]),
        "mask_rgb": mask_rgb,
        "mask_motion": mask_motion,
    }
