r"""End-to-end serving: raw video in, action predictions out (the port's
copy of ``vimoclip_tpu/serving.py``).

  RGB video --> CLIP teacher ViT  --------------------\
      \--> frame-diff (on the device)                  +--> TFAM fusion
           --> MoCLIP student ViT  -------------------/       --> sigmoid top-k

- frames go to the device once, as uint8, and are preprocessed there;
- the motion stream is the frame difference of the RGB frames, computed on
  the device; precomputed motion videos can be passed instead;
- TFAM runs the hand-written flash-attention kernel by default;
- sequence lengths round up to ``length_bucket`` (capped at ``max_seq_len``)
  so a request sees one of a handful of shapes;
- data parallelism (``devices``, JAX: ``mesh``): one replica of each tower
  per device, each fixed-shape frame window split into contiguous row
  blocks, one per replica (``parallel/mesh.py::Replicas``); the fusion runs
  once, on the first device.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from vimoclip_tpu_torch.config import TFAMModelConfig
from vimoclip_tpu_torch.data.video_reader import read_video
from vimoclip_tpu_torch.models.convert import student_tower_state, to_tensors
from vimoclip_tpu_torch.models.tfam import TFAM
from vimoclip_tpu_torch.models.towers import VisionConfig, preprocess, tower_state, vision_tower
from vimoclip_tpu_torch.ops.batching import (
    embed_in_fixed_batches,
    round_up_bucket,
    upload,
)
from vimoclip_tpu_torch.ops.preprocess import frame_diff
from vimoclip_tpu_torch.parallel.mesh import Replicas
from vimoclip_tpu_torch.utils.device import resolve_device
from vimoclip_tpu_torch.utils.profiling import annotate


class _Clips:
    """Clips of one resolution read as one stack along time without joining
    them: ``clips[a:b]`` inside one clip is a view of it; a slice across a
    clip boundary gathers only its own frames, counted through ``count``."""

    def __init__(self, clips: Sequence, count):
        self.clips, self.count = clips, count
        self.starts = np.cumsum([0] + [len(c) for c in clips])

    def __len__(self) -> int:
        return int(self.starts[-1])

    def __getitem__(self, window: slice):
        start, stop, _ = window.indices(len(self))
        parts = [clip[max(start - s, 0) : stop - s]
                 for clip, s in zip(self.clips, self.starts)
                 if max(start, s) < min(stop, s + len(clip))]
        if len(parts) == 1:
            return parts[0]
        self.count(gathered_windows=1, gathered_frames=stop - start)
        if isinstance(parts[0], torch.Tensor):
            return torch.cat(parts)
        return np.concatenate(parts)


@dataclasses.dataclass
class Prediction:
    video_id: str
    top_classes: list[tuple[int, str, float]]  # (class_id, name, probability)
    probabilities: np.ndarray  # (num_classes,)


class ViMoCLIPPredictor:
    """The fused cascade in one process.

    ``teacher_config`` / ``student_config`` are vision towers' configs of
    either kind (``models/towers.py``: CLIP or SigLIP), and
    ``teacher_state`` / ``student_state`` their state dicts in the tower's
    layout (a reference student state with ``visual_encoder.*`` keys, and
    HF's names for a SigLIP tower, are accepted too); ``tfam_state`` is an
    AMO_CLIP state dict whose width is the towers' ``embed_dim``; values are
    tensors or numpy arrays. ``device`` is ``cuda`` unless the caller asks
    for the CPU. ``devices``: one replica of each tower per entry
    (``frame_batch`` must divide by their number); the first is where the
    fusion runs. ``stats()``: frame windows embedded, those gathered across
    clips, and the frames each tower embedded.
    """

    def __init__(
        self,
        teacher_state: Mapping,
        teacher_config: VisionConfig,
        student_state: Mapping,
        student_config: VisionConfig,
        tfam_state: Mapping,
        tfam_config: TFAMModelConfig | None = None,
        num_classes: int = 140,
        class_names: dict[int, str] | None = None,
        frame_batch: int = 128,
        length_bucket: int = 128,
        max_seq_len: int | None = 2048,
        half_precision: bool = True,
        batch_invariant: bool = True,
        device: str | torch.device = "cuda",
        devices: Sequence[str | torch.device] | None = None,
    ):
        self.device = resolve_device(device if devices is None else devices[0])
        self.num_classes = num_classes
        self.embed_dim = teacher_config.embed_dim
        self.class_names = class_names or {}
        self.frame_batch = frame_batch
        self.length_bucket = length_bucket
        self.max_seq_len = max_seq_len
        self.dtype = torch.bfloat16 if half_precision else torch.float32
        self._stats_lock = threading.Lock()
        self._stats = {
            "windows": 0,           # frame windows uploaded and embedded
            "gathered_windows": 0,  # windows across a clip boundary, copied
            "gathered_frames": 0,   # the frames those windows copied
            "teacher_frames": 0,    # frames the teacher embedded (padding aside)
            "student_frames": 0,    # frames the student embedded (padding aside)
        }
        tfam_config = tfam_config or TFAMModelConfig(attention_impl="flash")
        if batch_invariant and not tfam_config.masked_pooling:
            # A prediction must not depend on what a clip is co-batched
            # with: the reference pools over the BATCH-max length. Masked
            # pooling equals it for one video and makes pooled == serial.
            logging.getLogger(__name__).info(
                "serving: masked pooling enabled for batch-invariant "
                "predictions (batch_invariant=False restores the "
                "reference's batch-max pooling)"
            )
            tfam_config = dataclasses.replace(tfam_config, masked_pooling=True)

        self.teacher = self._place(vision_tower(teacher_config, self.dtype),
                                   tower_state(teacher_config, teacher_state))
        self.student = self._place(
            vision_tower(student_config, self.dtype),
            tower_state(student_config, student_tower_state(student_state)))
        self.tfam = self._place(TFAM(tfam_config, num_classes, self.dtype),
                                tfam_state)
        devices = devices or [self.device]
        self._teacher_embed = self._make_embed(Replicas(self.teacher, devices),
                                               teacher_config)
        self._student_embed = self._make_embed(Replicas(self.student, devices),
                                               student_config)

    def stats(self) -> dict:
        with self._stats_lock:
            return dict(self._stats)

    def _count(self, **added: int) -> None:
        with self._stats_lock:
            for key, n in added.items():
                self._stats[key] += n

    def _place(self, module: nn.Module, state: Mapping) -> nn.Module:
        module.load_state_dict(to_tensors(state), strict=True)
        return module.to(self.device).eval().requires_grad_(False)

    def _make_embed(self, replicas: Replicas, config: VisionConfig):
        replicas.check_divides(self.frame_batch, "frame_batch")

        def run(enc: nn.Module, frames: torch.Tensor) -> torch.Tensor:
            return enc(preprocess(frames, config, self.dtype)).float()

        def embed(frames: torch.Tensor) -> torch.Tensor:  # (N, H, W, 3) uint8
            return replicas(run, frames)
        return embed

    # ------------------------------------------------------------------
    def _embed_frames(self, embed_fn, frames) -> np.ndarray:
        return embed_in_fixed_batches(embed_fn, frames, self.frame_batch,
                                      self.embed_dim, self.device)

    def _embed_window_device(self, embed_fn, frames_dev: torch.Tensor):
        """One <= frame_batch window through the encoder, padded to the
        fixed batch, NOT fetched: returns (device embeddings, valid rows)."""
        n = frames_dev.shape[0]
        if n < self.frame_batch:
            frames_dev = torch.cat([frames_dev, frames_dev.new_zeros(
                (self.frame_batch - n,) + tuple(frames_dev.shape[1:]))])
        return embed_fn(frames_dev), n

    def _dispatch_window(self, chunk: torch.Tensor, nxt: torch.Tensor | None):
        with annotate("vimo.serve.embed"):
            rgb_dev, rn = self._embed_window_device(self._teacher_embed, chunk)
            window = chunk if nxt is None else torch.cat([chunk, nxt])
            mot_dev = mot_n = None
            if window.shape[0] >= 2:
                mot_dev, mot_n = self._embed_window_device(
                    self._student_embed, frame_diff(window))
            self._count(teacher_frames=rn, student_frames=mot_n or 0)
            return rgb_dev, rn, mot_dev, mot_n

    @torch.inference_mode()
    def embed_video(self, frames) -> tuple[np.ndarray, np.ndarray]:
        """(T, H, W, 3) uint8 -> (rgb_emb (T, D), motion_emb (T-1, D)).
        ``frames`` is an array, a tensor or a ``_Clips``, sliced window by
        window.

        Streams ``frame_batch``-frame windows; each window's diffs reach one
        frame into the next window, so the frame difference crosses window
        boundaries. Every frame is uploaded once: a window is dispatched
        once the next chunk (whose first frame it needs) is on the device,
        and its embeddings are fetched only after the next window has been
        enqueued, so one window stays in flight."""
        bs = self.frame_batch
        rgb_out: list[np.ndarray] = []
        mot_out: list[np.ndarray] = []

        def flush(p):
            with annotate("vimo.serve.fetch"):
                rgb_dev, rn, mot_dev, mn = p
                rgb_out.append(rgb_dev[:rn].cpu().numpy())
                if mot_dev is not None:
                    mot_out.append(mot_dev[:mn].cpu().numpy())

        pending = prev = None
        for i in range(0, len(frames), bs):
            with annotate("vimo.serve.upload"):
                chunk = upload(frames[i : i + bs], self.device)
            self._count(windows=1)
            if prev is not None:
                dispatched = self._dispatch_window(prev, chunk[:1])
                if pending is not None:
                    flush(pending)
                pending = dispatched
            prev = chunk
        if prev is not None:
            dispatched = self._dispatch_window(prev, None)
            if pending is not None:
                flush(pending)
            pending = dispatched
        if pending is not None:
            flush(pending)
        empty = np.zeros((0, self.embed_dim), np.float32)
        rgb_emb = np.concatenate(rgb_out) if rgb_out else empty
        motion_emb = np.concatenate(mot_out) if mot_out else empty
        return rgb_emb, motion_emb

    @torch.inference_mode()
    def _fuse(self, rgb, mot, mask_r, mask_m) -> np.ndarray:
        put = lambda a: torch.from_numpy(a).to(self.device)
        logits = self.tfam(put(rgb), put(mot), put(mask_r), put(mask_m))
        return torch.sigmoid(logits).cpu().numpy()

    def _top(self, probs: np.ndarray, top_k: int):
        order = np.argsort(probs)[::-1][:top_k]
        return [(int(c), self.class_names.get(int(c), f"class_{c}"),
                 float(probs[c])) for c in order]

    def predict_embeddings(
        self, rgb_emb: np.ndarray, motion_emb: np.ndarray, video_id: str = "",
        top_k: int = 5,
    ) -> Prediction:
        t_r = round_up_bucket(len(rgb_emb), self.length_bucket, self.max_seq_len)
        t_m = round_up_bucket(len(motion_emb), self.length_bucket, self.max_seq_len)
        rgb = np.zeros((1, t_r, rgb_emb.shape[1]), np.float32)
        mot = np.zeros((1, t_m, motion_emb.shape[1]), np.float32)
        rgb[0, : len(rgb_emb)] = rgb_emb[:t_r]
        mot[0, : len(motion_emb)] = motion_emb[:t_m]
        mask_r = np.arange(t_r)[None, :] < min(len(rgb_emb), t_r)
        mask_m = np.arange(t_m)[None, :] < min(len(motion_emb), t_m)
        probs = self._fuse(rgb, mot, mask_r, mask_m)[0]
        return Prediction(video_id, self._top(probs, top_k), probs)

    def predict(
        self, video_path: str, motion_video_path: str | None = None,
        top_k: int = 5, max_frames: int | None = None,
    ) -> Prediction:
        """Full cascade on one video file."""
        frames = read_video(video_path, max_frames=max_frames)
        if motion_video_path is None:
            if len(frames) < 2:
                raise ValueError(
                    f"{video_path}: {len(frames)} frame(s) decoded — the "
                    "fused cascade needs >= 2 (motion = consecutive-frame "
                    "diffs); raise max_frames or supply motion_video_path"
                )
            rgb_emb, motion_emb = self.embed_video(frames)
        else:
            with torch.inference_mode():
                rgb_emb = self._embed_frames(self._teacher_embed, frames)
                motion = read_video(motion_video_path, max_frames=max_frames)
                motion_emb = self._embed_frames(self._student_embed, motion)
            self._count(teacher_frames=len(rgb_emb), student_frames=len(motion_emb))
        return self.predict_embeddings(rgb_emb, motion_emb, video_path, top_k)

    def _embed_videos_pooled(self, videos) -> list[tuple[np.ndarray, np.ndarray]]:
        """Embed several clips through shared frame windows: clips of one
        resolution are streamed as one stack along time, read in place
        (``_Clips``), so only the group's tail window is padded and only a
        window across two clips is copied on the host. Per-clip arrays are
        slices; the one cross-clip diff between consecutive clips is
        dropped. Each frame's embedding is independent of its neighbours,
        so results equal the per-clip path."""
        out: list = [None] * len(videos)
        groups: dict[tuple, list[int]] = {}
        with annotate("vimo.serve.pool"):
            for i, frames in enumerate(videos):
                groups.setdefault(tuple(frames.shape[1:3]), []).append(i)
        for idxs in groups.values():
            with annotate("vimo.serve.pool"):
                clips = _Clips([v.to(self.device) if isinstance(v, torch.Tensor) else v
                                for v in (videos[i] for i in idxs)], self._count)
            rgb_all, diff_all = self.embed_video(clips)
            ofs = 0
            for i in idxs:
                n = len(videos[i])
                out[i] = (rgb_all[ofs : ofs + n], diff_all[ofs : ofs + max(n - 1, 0)])
                ofs += n
        return out

    def predict_batch(self, video_paths: list[str], top_k: int = 5,
                      max_frames: int | None = None) -> list[Prediction]:
        """Several video files: the frames of all clips share the embedding
        windows (pooled per resolution) and fusion runs once over the padded
        batch."""
        videos = [read_video(p, max_frames=max_frames) for p in video_paths]
        return self.predict_videos(videos, video_paths, top_k=top_k)

    def predict_videos(self, videos: list, video_ids: list[str] | None = None,
                       top_k: int = 5) -> list[Prediction]:
        """In-memory (T, H, W, 3) uint8 stacks (numpy, or tensors on any
        device) through the pooled embedding path and one batched fusion.
        Spans: ``vimo.serve.request`` around the call; inside it
        ``vimo.serve.pool``, ``vimo.serve.upload``, ``vimo.serve.embed``,
        ``vimo.serve.fetch`` and ``vimo.serve.fuse``."""
        with annotate("vimo.serve.request"):
            video_ids = video_ids or [f"video_{i}" for i in range(len(videos))]
            for vid, frames in zip(video_ids, videos):
                if len(frames) < 2:
                    raise ValueError(
                        f"{vid}: {len(frames)} frame(s) — the fused cascade "
                        "needs >= 2 (motion = consecutive-frame diffs)"
                    )
            embs = self._embed_videos_pooled(videos)
            with annotate("vimo.serve.fuse"):
                t_r = round_up_bucket(max(len(r) for r, _ in embs),
                                      self.length_bucket, self.max_seq_len)
                t_m = round_up_bucket(max(len(m) for _, m in embs),
                                      self.length_bucket, self.max_seq_len)
                b, d = len(embs), embs[0][0].shape[1]
                rgb = np.zeros((b, t_r, d), np.float32)
                mot = np.zeros((b, t_m, d), np.float32)
                mask_r = np.zeros((b, t_r), bool)
                mask_m = np.zeros((b, t_m), bool)
                for i, (r, m) in enumerate(embs):
                    nr, nm = min(len(r), t_r), min(len(m), t_m)
                    rgb[i, :nr], mot[i, :nm] = r[:nr], m[:nm]
                    mask_r[i, :nr] = mask_m[i, :nm] = True
                probs = self._fuse(rgb, mot, mask_r, mask_m)
            return [Prediction(vid, self._top(probs[i], top_k), probs[i])
                    for i, vid in enumerate(video_ids)]
