"""Stage-1 segment dataset (the port's copy of
``vimoclip_tpu/data/segment_dataset.py``): fixed-length windows of teacher
RGB embeddings and motion frames for MoCLIP distillation.

- Each video is cut into non-overlapping ``sequence_length`` windows; the
  index of (video_id, start, seg_len) comes from the HDF5 shapes alone.
- An item holds the RGB embedding slice padded by repeating its last frame,
  and ``seg_len - 1`` motion frames (the motion stream has T - 1 frames for
  T RGB frames; a padded segment asks for ``sequence_length - 1``), clamped
  at the end of the video and padded the same way.
- The MammalNet layout nests groups under ``trimmed_videos/`` and resizes
  the frames to ``spatial_size`` (``cv2.INTER_LINEAR``).

Only the needed window is decoded, by seeking. An opt-in LRU of whole
decoded videos (``decode_cache_videos``) serves sequential access; it is
off by default, since under a shuffled loader it would decode a whole video
to serve one window. ``cv2`` and ``h5py`` are imported when called.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

import numpy as np

from vimoclip_tpu_torch.data.hdf5_schema import read_embeddings, read_labels, sequence_lengths
from vimoclip_tpu_torch.data.video_reader import read_video, read_video_window, video_frame_count


def build_segment_index(lengths: dict[str, int],
                        sequence_length: int) -> list[tuple[str, int, int]]:
    """(video_id, start, seg_len) of non-overlapping windows; a short
    remainder becomes one padded segment."""
    segments = []
    for vid, t in lengths.items():
        start = 0
        while start < t:
            seg_len = min(sequence_length, t - start)
            segments.append((vid, start, seg_len))
            start += seg_len
    return segments


def _pad_repeat_last(x: np.ndarray, target: int) -> np.ndarray:
    if x.shape[0] >= target:
        return x[:target]
    if x.shape[0] == 0:
        return np.zeros((target,) + x.shape[1:], dtype=x.dtype)
    return np.concatenate([x, np.repeat(x[-1:], target - x.shape[0], axis=0)], axis=0)


class SegmentDataset:
    """Map-style dataset of distillation segments."""

    def __init__(self, embeddings_path: str, motion_videos_dir: str,
                 sequence_length: int = 30, nested_prefix: str | None = None,
                 spatial_size: tuple[int, int] | None = None,
                 decode_cache_videos: int = 0):
        self.embeddings_path = embeddings_path
        self.motion_videos_dir = motion_videos_dir
        self.sequence_length = sequence_length
        self.nested_prefix = nested_prefix
        self.spatial_size = spatial_size
        self.segments = build_segment_index(
            sequence_lengths(embeddings_path, nested_prefix), sequence_length)
        self._cache: OrderedDict[str, np.ndarray] = OrderedDict()
        self._cache_size = decode_cache_videos
        # the loader calls __getitem__ from worker threads: the cache is
        # changed under the lock, and a reader keeps its own reference
        self._cache_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.segments)

    def _h5_key(self, video_id: str) -> str:
        return f"{self.nested_prefix}/{video_id}" if self.nested_prefix else video_id

    def _cached_video(self, video_id: str, path: str) -> np.ndarray:
        with self._cache_lock:
            video = self._cache.get(video_id)
            if video is not None:
                self._cache.move_to_end(video_id)
                return video
        try:
            video = read_video(path)  # decoded outside the lock
        except IOError as e:
            raise ValueError(f"motion video for {video_id!r} decoded 0 frames ({path}) — "
                             "regenerate it or drop the video") from e
        with self._cache_lock:
            self._cache[video_id] = video
            self._cache.move_to_end(video_id)
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)
        return video

    def _motion_window(self, video_id: str, start: int, n: int) -> np.ndarray:
        path = os.path.join(self.motion_videos_dir, video_id)
        if self._cache_size > 0:
            video = self._cached_video(video_id, path)
            t = video.shape[0]
            start = min(start, max(t - 1, 0))
            return video[start:min(start + n, t)]
        # the final padded segment asks for motion frames past the T - 1 of
        # the motion stream: clamp the start as the cached path does
        total = video_frame_count(path)
        if total > 0:
            start = min(start, total - 1)
        try:
            return read_video_window(path, start, n)
        except IOError as e:
            if start > 0:
                # no frame count from the container, so no clamp: the last
                # padded segment can ask for exactly one past the end
                try:
                    return read_video_window(path, start - 1, n)
                except IOError:
                    pass
            raise ValueError(f"motion video for {video_id!r} decoded 0 frames at window "
                             f"start {start} ({path}) — regenerate it or drop the video") from e

    def __getitem__(self, idx: int) -> dict:
        video_id, start, seg_len = self.segments[idx]
        key = self._h5_key(video_id)
        rgb = _pad_repeat_last(
            read_embeddings(self.embeddings_path, key, start, start + seg_len),
            self.sequence_length)
        labels = read_labels(self.embeddings_path, key)
        motion_len = (self.sequence_length - 1 if seg_len < self.sequence_length
                      else seg_len - 1)
        motion = self._motion_window(video_id, start, motion_len)
        if self.spatial_size is not None and motion.size:
            import cv2

            h, w = self.spatial_size
            motion = np.stack([cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR)
                               for f in motion])
        motion = _pad_repeat_last(motion, motion_len)
        return {"video_id": video_id, "rgb_emb": rgb.astype(np.float32),
                "motion_frames": motion, "labels": labels.astype(np.float32)}


def collate_segments(items: list[dict]) -> dict:
    """Stack fixed-shape segments into a batch."""
    return {
        "video_id": [it["video_id"] for it in items],
        "rgb_emb": np.stack([it["rgb_emb"] for it in items]),
        "motion_frames": np.stack([it["motion_frames"] for it in items]),
        "labels": np.stack([it["labels"] for it in items]),
    }
