r"""End-to-end serving: raw video in, action predictions out (the port's
copy of ``vimoclip_tpu/serving.py``).

  RGB video --> CLIP teacher ViT  --------------------\
      \--> frame-diff (on the device)                  +--> TFAM fusion
           --> MoCLIP student ViT  -------------------/       --> sigmoid top-k

- frames go to the device once, as uint8, and are preprocessed there;
- the motion stream is the frame difference of the RGB frames, computed on
  the device; precomputed motion videos can be passed instead;
- one request path: ``predict`` on a file is ``predict_videos`` on its
  frames; every frame stack goes through one window loop (``_windows``)
  and every batch of embeddings through one padded fusion
  (``_predictions``);
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
from vimoclip_tpu_torch.ops.batching import pad_sequences, upload
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
    def _embed_window_device(self, embed_fn, frames_dev: torch.Tensor):
        """One <= frame_batch window through the encoder, padded to the
        fixed batch, NOT fetched: returns (device embeddings, valid rows)."""
        n = frames_dev.shape[0]
        if n < self.frame_batch:
            frames_dev = torch.cat([frames_dev, frames_dev.new_zeros(
                (self.frame_batch - n,) + tuple(frames_dev.shape[1:]))])
        return embed_fn(frames_dev), n

    def _dispatch_window(self, chunk: torch.Tensor, nxt: torch.Tensor | None):
        """The cascade's window: the teacher on ``chunk``, the student on
        its frame differences, which reach into ``nxt``."""
        with annotate("vimo.serve.embed"):
            rgb_dev, rn = self._embed_window_device(self._teacher_embed, chunk)
            window = chunk if nxt is None else torch.cat([chunk, nxt])
            mot_dev = mot_n = None
            if window.shape[0] >= 2:
                mot_dev, mot_n = self._embed_window_device(
                    self._student_embed, frame_diff(window))
            self._count(teacher_frames=rn, student_frames=mot_n or 0)
            return (rgb_dev, rn), (mot_dev, mot_n)

    def _tower_dispatch(self, embed_fn, counted: str):
        """One tower's window: ``embed_fn`` on the frames as they come."""
        def dispatch(chunk: torch.Tensor, _nxt):
            with annotate("vimo.serve.embed"):
                dev, n = self._embed_window_device(embed_fn, chunk)
                self._count(**{counted: n})
                return ((dev, n),)
        return dispatch

    @torch.inference_mode()
    def _windows(self, frames, dispatch, streams: int) -> list[np.ndarray]:
        """The window loop of every frame stack: ``frames`` (an array, a
        tensor or a ``_Clips``) in ``frame_batch``-frame windows, each
        uploaded once. ``dispatch(chunk, nxt)`` enqueues a window (``nxt``:
        the next window's first frame, None for the last) and returns
        ``streams`` (device embeddings, valid rows) pairs, embeddings None
        for none. A window is dispatched once the next is on the device,
        and fetched only after the next has been enqueued, so one window
        stays in flight. Returns each stream's rows, (N, D) float32."""
        bs = self.frame_batch
        outs: list[list[np.ndarray]] = [[] for _ in range(streams)]

        def windows():
            prev = None
            for i in range(0, len(frames), bs):
                with annotate("vimo.serve.upload"):
                    chunk = upload(frames[i : i + bs], self.device)
                self._count(windows=1)
                if prev is not None:
                    yield prev, chunk[:1]
                prev = chunk
            if prev is not None:
                yield prev, None

        def flush(dispatched):
            with annotate("vimo.serve.fetch"):
                for out, (dev, n) in zip(outs, dispatched):
                    if dev is not None:
                        out.append(dev[:n].cpu().numpy())

        pending = None
        for chunk, nxt in windows():
            dispatched = dispatch(chunk, nxt)
            if pending is not None:
                flush(pending)
            pending = dispatched
        if pending is not None:
            flush(pending)
        return [np.concatenate(out) if out else np.zeros((0, self.embed_dim), np.float32)
                for out in outs]

    def embed_video(self, frames) -> tuple[np.ndarray, np.ndarray]:
        """(T, H, W, 3) uint8 -> (rgb_emb (T, D), motion_emb (T-1, D)).
        ``frames`` is an array, a tensor or a ``_Clips``. Each window's
        diffs reach one frame into the next window, so the frame
        difference crosses window boundaries."""
        rgb_emb, motion_emb = self._windows(frames, self._dispatch_window, 2)
        return rgb_emb, motion_emb

    @torch.inference_mode()
    def _fuse(self, rgb, mot, mask_r, mask_m) -> np.ndarray:
        put = lambda a: torch.from_numpy(a).to(self.device)
        logits = self.tfam(put(rgb), put(mot), put(mask_r), put(mask_m))
        return torch.sigmoid(logits).cpu().numpy()

    def _predictions(self, embs, video_ids, top_k: int) -> list[Prediction]:
        """(rgb_emb, motion_emb) pairs -> one padded batch through TFAM ->
        each video's sigmoid top-k."""
        rgb, mask_r = pad_sequences([r for r, _ in embs], self.length_bucket,
                                    self.max_seq_len)
        mot, mask_m = pad_sequences([m for _, m in embs], self.length_bucket,
                                    self.max_seq_len)
        probs = self._fuse(rgb, mot, mask_r, mask_m)
        return [Prediction(vid, self._top(p, top_k), p) for vid, p in zip(video_ids, probs)]

    def _top(self, probs: np.ndarray, top_k: int):
        order = np.argsort(probs)[::-1][:top_k]
        return [(int(c), self.class_names.get(int(c), f"class_{c}"),
                 float(probs[c])) for c in order]

    def predict_embeddings(
        self, rgb_emb: np.ndarray, motion_emb: np.ndarray, video_id: str = "",
        top_k: int = 5,
    ) -> Prediction:
        pair = (np.asarray(rgb_emb, np.float32), np.asarray(motion_emb, np.float32))
        return self._predictions([pair], [video_id], top_k)[0]

    def predict(
        self, video_path: str, motion_video_path: str | None = None,
        top_k: int = 5, max_frames: int | None = None,
    ) -> Prediction:
        """Full cascade on one video file: ``predict_videos`` on its frames,
        or, with a motion video, the teacher on the frames and the student
        on the motion video's."""
        frames = read_video(video_path, max_frames=max_frames)
        if motion_video_path is None:
            if len(frames) < 2:
                raise ValueError(
                    f"{video_path}: {len(frames)} frame(s) decoded — the "
                    "fused cascade needs >= 2 (motion = consecutive-frame "
                    "diffs); raise max_frames or supply motion_video_path"
                )
            return self.predict_videos([frames], [video_path], top_k)[0]
        motion = read_video(motion_video_path, max_frames=max_frames)
        with annotate("vimo.serve.request"):
            (rgb_emb,) = self._windows(
                frames, self._tower_dispatch(self._teacher_embed, "teacher_frames"), 1)
            (motion_emb,) = self._windows(
                motion, self._tower_dispatch(self._student_embed, "student_frames"), 1)
            with annotate("vimo.serve.fuse"):
                return self._predictions([(rgb_emb, motion_emb)], [video_path], top_k)[0]

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
                return self._predictions(embs, video_ids, top_k)
