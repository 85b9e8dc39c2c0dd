"""Teacher-embedding extraction, the cascade's stage 0 (the port's copy of
``vimoclip_tpu/extraction.py``; the reference's ``extract_embeddings.py`` and
``extract_embeddings_mammalNet.py``).

The reference decodes a video, preprocesses each frame with PIL, runs the
frozen CLIP ViT and writes the video's HDF5 group, one video after another.
Here the four phases overlap:

  decode threads (OpenCV) or the native decode pool  ->  frame queue
  -> fixed-size uint8 batches packed across videos -> pinned upload
  -> CLIP preprocessing + bf16 ViT forward on the card (one batch shape)
  -> embeddings copied back to pinned host memory -> HDF5 writer thread

Every batch has ``batch_size`` frames (the tail zero-padded), so cuBLAS keeps
one algorithm and a frame's embedding does not depend on how full its batch
is; the host scatters the rows back to their videos. One batch stays in
flight: batch N's embeddings are waited for only once batch N+1 is enqueued.

``h5py``, ``cv2`` and ``pandas`` are imported where they are used, so the
module imports without them.
"""

from __future__ import annotations

import collections
import csv
import logging
import os
import queue
import threading
from dataclasses import dataclass
from typing import Callable, Mapping

import numpy as np
import torch

from vimoclip_tpu_torch.data.hdf5_schema import AsyncWriter, EmbeddingWriter
from vimoclip_tpu_torch.data.video_reader import _native_backend, iter_video_chunks
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
from vimoclip_tpu_torch.models.convert import to_tensors
from vimoclip_tpu_torch.ops.batching import pad_to_batch, upload
from vimoclip_tpu_torch.ops.preprocess import clip_preprocess
from vimoclip_tpu_torch.utils.device import resolve_device


def load_annotations(annotation_file: str) -> list[tuple[str, list[int]]]:
    """``<video_id> label1 label2 ...`` lines (extract_embeddings.py:46-47);
    also the MN form ``trimmed_videos/<id>.mp4 label``."""
    out = []
    with open(annotation_file, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            out.append((parts[0], [int(x) for x in parts[1:]]))
    return out


def load_class_map(class_file: str) -> dict[int, str]:
    """``id,name`` csv with a header (ak_action.csv, extract_embeddings.py:40-43)."""
    import pandas as pd

    df = pd.read_csv(class_file)
    return {int(r["id"]): r["name"] for _, r in df.iterrows()}


def load_class_names(class_file: str) -> dict[int, str]:
    """Class names for the stage-2 and serving reports: ``id,name`` rows,
    headered or not. The reference reads the file with ``header=None``
    (TFAM/train_and_eval.py:183) though ak_action.csv has a header; rows
    whose id is not an integer (the header) are skipped, so both layouts
    give one mapping."""
    out: dict[int, str] = {}
    with open(class_file, newline="") as f:
        for row in csv.reader(f):
            if len(row) < 2:
                continue
            try:
                out[int(row[0])] = row[1]
            except ValueError:
                continue
    return out


def multi_hot(labels: list[int], num_classes: int) -> np.ndarray:
    mh = np.zeros(num_classes, dtype=np.float32)
    for l in labels:
        if 0 <= l < num_classes:
            mh[l] = 1.0
        else:
            logging.warning("label %d outside class map", l)
    return mh


def uniform_indices(total_frames: int, max_frames: int | None) -> np.ndarray:
    """The reference's subsampling: step = T // max, the first max indices
    (extract_embeddings.py:77-81)."""
    if max_frames is None or total_frames <= max_frames:
        return np.arange(total_frames)
    step = total_frames // max_frames
    return np.arange(0, total_frames, step)[:max_frames]


@dataclass
class _FrameBlock:
    video_id: str
    frames: np.ndarray  # (n, H, W, 3) uint8
    final: bool  # last block of this video


class ClipExtractor:
    """Batched CLIP embedding extractor over a video corpus.

    ``state``: the ``ClipVisionEncoder`` layout (``models/pretrained.py::
    load_clip_vision``, or ``models/convert.py::clip_vision_state_from_jax``
    with ``prefix=""``). It runs on ``device`` (default ``cuda``, an error
    without a card).

    ``dedup_threshold``: opt-in temporal-redundancy gating. A frame whose
    mean absolute pixel delta (uint8 units, on a 4x subsampled probe) to the
    last embedded frame of its video is below the threshold reuses that
    frame's embedding instead of running the ViT. Outputs deviate from the
    exact per-frame embeddings, hence opt-in.

    ``decode_fn(path, chunk_size=n)`` yields a video's (<= n, H, W, 3) RGB
    uint8 chunks; it defaults to ``data/video_reader.py::iter_video_chunks``
    (OpenCV), which the native decode pool replaces when the data plane is
    built and ``VIMO_NATIVE_DECODE=1``. Only tests and ``chip_smoke.py``
    pass another.
    """

    def __init__(
        self,
        state: Mapping,
        config: ClipVisionConfig,
        batch_size: int = 256,
        half_precision: bool = True,
        decode_workers: int = 4,
        frame_queue_blocks: int = 32,
        dedup_threshold: float | None = None,
        mesh=None,
        device: str | torch.device = "cuda",
        decode_fn: Callable | None = None,
    ):
        if mesh is not None:
            raise NotImplementedError("multi-GPU extraction (mesh) comes with the "
                                      "multi-GPU slice of the port (ROADMAP slice 7)")
        self.device = resolve_device(device)
        self.config = config
        self.batch_size = batch_size
        self.decode_workers = decode_workers
        self.frame_queue_blocks = frame_queue_blocks
        self.dedup_threshold = dedup_threshold
        self.dtype = torch.bfloat16 if half_precision else torch.float32
        encoder = ClipVisionEncoder(config, dtype=self.dtype)
        encoder.load_state_dict(to_tensors(state), strict=True)
        self.encoder = encoder.to(self.device).eval().requires_grad_(False)
        self._decode = decode_fn if decode_fn is not None else iter_video_chunks

    @torch.inference_mode()
    def _embed(self, frames: torch.Tensor) -> torch.Tensor:
        """(batch_size, H, W, 3) uint8 on the device -> (batch_size, P) float32."""
        pixels = clip_preprocess(frames, self.config.image_size, dtype=self.dtype)
        return self.encoder(pixels).float()

    def _dispatch(self, stack: np.ndarray) -> tuple:
        """Enqueue one fixed-shape batch: pinned upload, forward, and the
        copy of its embeddings into pinned host memory, with an event after
        it. Waits for nothing. The pinned source of the upload may be freed
        at once: PyTorch's pinned pool reuses a block only after the copies
        from it are done."""
        emb = self._embed(upload(stack, self.device))
        if self.device.type != "cuda":
            return emb, None
        host = torch.empty(emb.shape, dtype=emb.dtype, pin_memory=True)
        host.copy_(emb, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _fetch(dispatched: tuple) -> np.ndarray:
        host, done = dispatched
        if done is not None:
            done.synchronize()
        return host.numpy().copy()  # the pinned buffer goes back to its pool

    # ------------------------------------------------------------------
    def _decode_into(
        self,
        jobs: "queue.Queue[tuple[str, str] | None]",
        blocks: "queue.Queue[_FrameBlock]",
        errors: dict,
        chunk: int,
    ):
        while True:
            job = jobs.get()
            if job is None:
                return
            video_id, path = job
            try:
                last = None
                for frames in self._decode(path, chunk_size=chunk):
                    if last is not None:
                        blocks.put(_FrameBlock(video_id, last, final=False))
                    last = frames
                if last is None:
                    raise IOError("no frames decoded")
                blocks.put(_FrameBlock(video_id, last, final=True))
            except Exception as e:  # per-video fault tolerance
                # (extract_embeddings.py:113-115)
                errors[video_id] = str(e)
                blocks.put(_FrameBlock(video_id, np.zeros((0, 1, 1, 3), np.uint8), True))

    def _start_decoders(self, videos, blocks, errors) -> list[threading.Thread]:
        """Start the decode backend that feeds ``blocks``.

        With the default decoder, the native data plane built and
        ``VIMO_NATIVE_DECODE=1``, the C++ corpus pool (``data/native.py``
        ``DecodePool``) decodes the videos concurrently with no Python in
        the decode path, and one pump thread drains its bounded queue into
        ``blocks``. Otherwise ``decode_workers`` threads run the decoder
        (OpenCV releases the GIL while it decodes). Either way each video's
        blocks arrive in frame order, with exactly one final block, and a
        failure lands in ``errors``."""
        native = _native_backend() if self._decode is iter_video_chunks else None
        if native is not None:
            t = threading.Thread(target=self._pump_native,
                                 args=(native, videos, blocks, errors), daemon=True)
            t.start()
            return [t]
        jobs: queue.Queue = queue.Queue()
        for v in videos:
            jobs.put(v)
        workers = []
        for _ in range(self.decode_workers):
            jobs.put(None)
            t = threading.Thread(
                target=self._decode_into,
                args=(jobs, blocks, errors, self.batch_size),
                daemon=True,
            )
            t.start()
            workers.append(t)
        return workers

    def _pump_native(self, native, videos, blocks, errors) -> None:
        """Drain the native pool into ``blocks``. The consumer waits for one
        final block per video, so if the pool fails, every video without
        its final block gets an error final."""
        finals_sent: set[str] = set()
        empty = np.zeros((0, 1, 1, 3), np.uint8)
        try:
            # a small native queue: ``blocks`` is the real buffer, and two
            # full-size queues would double the decoded frames held
            with native.DecodePool(workers=self.decode_workers,
                                   chunk_frames=self.batch_size, max_ready=4) as pool:
                for vid, path in videos:
                    pool.submit(vid, path)
                pool.seal()
                for vid, frames, final, error in pool:
                    if error is not None:
                        errors[vid] = error
                        finals_sent.add(vid)
                        blocks.put(_FrameBlock(vid, empty, True))
                        continue
                    if final:
                        finals_sent.add(vid)
                    blocks.put(_FrameBlock(vid, frames, final))
        except Exception as e:  # noqa: BLE001 — the pool died: fail the rest
            for vid, _ in videos:
                if vid not in finals_sent:
                    errors[vid] = f"native decode pool failed: {e}"
                    blocks.put(_FrameBlock(vid, empty, True))

    def extract(
        self,
        videos: list[tuple[str, str]],  # (video_id, path)
        on_video_done,  # callback(video_id, embeddings (T, D) | None)
        frame_shape: tuple[int, int] | None = None,
        frame_filter: dict[str, set] | None = None,
        on_video_chunk=None,  # callback(video_id, chunk (n, D)): streaming
        on_video_abort=None,  # callback(video_id): a streamed video failed
        stream_rows: int = 2048,
        stream_ok: set[str] | None = None,
    ) -> dict[str, str]:
        """Run the pipeline; returns {video_id: error} for failed videos.

        ``frame_shape`` fixes (H, W): frames of another size are resized on
        the host (OpenCV). Without it every resolution is preprocessed at its
        native size in batches of its own.
        ``frame_filter`` maps video_id -> allowed frame indices; other frames
        are dropped before embedding (the reference subsamples before it runs
        CLIP, extract_embeddings.py:77-84).

        Streaming (``on_video_chunk``): once a video has ``stream_rows``
        embedded frames they are handed out as an in-order chunk and dropped
        from host memory. A video that streamed a chunk ends with
        ``on_video_done(vid, None)`` after its last rows, or with
        ``on_video_abort(vid)`` if it fails later. ``stream_ok`` limits
        streaming to those ids. Temporal dedup expands whole videos through
        its slot map at the end, so it switches streaming off.
        """
        if self.dedup_threshold is not None:
            on_video_chunk = None  # dedup needs the whole-video slot expansion
        blocks: queue.Queue = queue.Queue(maxsize=self.frame_queue_blocks)
        errors: dict[str, str] = {}
        workers = self._start_decoders(videos, blocks, errors)

        pending: dict[str, list[np.ndarray]] = {}  # vid -> embedded frames
        positions: dict[str, int] = {}  # vid -> decoded-frame offset
        # temporal dedup: per-video slot map (frame -> embedded index) and
        # the last embedded frame's probe
        slots: dict[str, list[int]] = {}
        last_kept: dict[str, np.ndarray] = {}
        final_seen: set[str] = set()
        finished = 0
        # one frame buffer per resolution: (H, W) -> (frames, owners)
        buffers: dict[tuple, tuple[list, list]] = {}
        inflight: collections.deque = collections.deque()  # (dispatched, owners, n)
        streamed_rows: dict[str, int] = {}  # vid -> rows already handed out

        def _can_stream(vid: str) -> bool:
            return on_video_chunk is not None and (
                stream_ok is None or vid in stream_ok
            )

        def drain_one() -> None:
            dispatched, owners, n = inflight.popleft()
            emb = self._fetch(dispatched)[:n]
            touched = []
            for vid, e in zip(owners, emb):
                if vid in errors:
                    continue  # failed mid-decode: drop its dispatched frames
                pending.setdefault(vid, []).append(e)
                touched.append(vid)
            for vid in dict.fromkeys(touched):
                if _can_stream(vid) and len(pending[vid]) >= stream_rows:
                    rows = pending[vid]
                    pending[vid] = []
                    streamed_rows[vid] = streamed_rows.get(vid, 0) + len(rows)
                    on_video_chunk(vid, np.stack(rows))

        def flush(shape_key) -> None:
            """Dispatch one resolution's buffered frames as a fixed-size
            batch, then fetch the batch before it."""
            frames_l, owners = buffers.get(shape_key, ([], []))
            if not frames_l:
                return
            stack = np.stack(frames_l)
            n = stack.shape[0]
            stack = pad_to_batch(stack, self.batch_size)
            inflight.append((self._dispatch(stack), list(owners), n))
            buffers[shape_key] = ([], [])
            while len(inflight) > 1:
                drain_one()

        def drop_errored(vid: str) -> None:
            """Release all state of a failed video."""
            pending.pop(vid, None)
            slots.pop(vid, None)
            last_kept.pop(vid, None)
            final_seen.discard(vid)
            if streamed_rows.pop(vid, None) is not None and on_video_abort:
                on_video_abort(vid)  # partial chunks were already handed out

        def finish_ready() -> None:
            """Complete every video whose frames are all embedded."""
            nonlocal finished
            in_buffer = {o for _, owners in buffers.values() for o in owners}
            in_buffer |= {o for _, owners, _ in inflight for o in owners}
            for vid in [v for v in final_seen if v not in in_buffer]:
                final_seen.discard(vid)
                if vid in errors:
                    drop_errored(vid)
                    continue
                if vid in streamed_rows:  # streaming: hand out the remainder
                    rows = pending.pop(vid, [])
                    if rows:
                        streamed_rows[vid] += len(rows)
                        on_video_chunk(vid, np.stack(rows))
                    streamed_rows.pop(vid)
                    on_video_done(vid, None)
                    finished += 1
                    continue
                chunks = pending.pop(vid, [])
                emb = (
                    np.stack(chunks)
                    if chunks
                    else np.zeros((0, self.config.projection_dim), np.float32)
                )
                vid_slots = slots.pop(vid, None)
                last_kept.pop(vid, None)
                if vid_slots is not None and len(emb):
                    emb = emb[vid_slots]  # expand dedup reuse to full length
                on_video_done(vid, emb)
                finished += 1

        finals_received = 0
        while finals_received < len(videos):
            block = blocks.get()
            if block.final:
                finals_received += 1
            if block.video_id in errors:
                drop_errored(block.video_id)
                continue
            if block.frames.size:
                frames = block.frames
                offset = positions.get(block.video_id, 0)
                positions[block.video_id] = offset + len(frames)
                if frame_filter is not None and block.video_id in frame_filter:
                    allowed = frame_filter[block.video_id]
                    keep = [
                        i for i in range(len(frames)) if offset + i in allowed
                    ]
                    if not keep:
                        if block.final:
                            final_seen.add(block.video_id)
                            finish_ready()
                        continue
                    frames = frames[keep]
                if frame_shape is not None and frames.shape[1:3] != tuple(frame_shape):
                    import cv2

                    frames = np.stack(
                        [cv2.resize(f, (frame_shape[1], frame_shape[0]))
                         for f in frames]
                    )
                if self.dedup_threshold is not None:
                    vid = block.video_id
                    vslots = slots.setdefault(vid, [])
                    n_emb = (vslots[-1] + 1) if vslots else 0
                    keep_idx = []
                    for j, f in enumerate(frames):
                        probe = f[::4, ::4].astype(np.int16)
                        prev = last_kept.get(vid)
                        if (prev is not None and prev.shape == probe.shape
                                and float(np.mean(np.abs(probe - prev)))
                                < self.dedup_threshold):
                            vslots.append(n_emb - 1)  # reuse the previous embedding
                        else:
                            keep_idx.append(j)
                            vslots.append(n_emb)
                            n_emb += 1
                            last_kept[vid] = probe
                    if not keep_idx:
                        if block.final:
                            final_seen.add(block.video_id)
                            finish_ready()
                        continue
                    frames = frames[keep_idx]
                key = frames.shape[1:3]
                buf_frames, buf_owner = buffers.setdefault(key, ([], []))
                buf_frames.extend(frames)
                buf_owner.extend([block.video_id] * len(frames))
                while len(buf_frames) >= self.batch_size:
                    buffers[key] = (
                        buf_frames[: self.batch_size],
                        buf_owner[: self.batch_size],
                    )
                    keep_f = buf_frames[self.batch_size:]
                    keep_o = buf_owner[self.batch_size:]
                    flush(key)
                    buffers[key] = (keep_f, keep_o)
                    buf_frames, buf_owner = keep_f, keep_o
            if block.final:
                final_seen.add(block.video_id)
            finish_ready()
        for key in list(buffers):
            flush(key)
        while inflight:
            drain_one()
        finish_ready()
        for t in workers:
            t.join()
        return errors


def shard_annotations(annotations: list, num_shards: int, shard_index: int) -> list:
    """The strided slice of the annotation list that shard ``shard_index``
    of ``num_shards`` extracts (and probes, under --verify-fidelity)."""
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
    return annotations[shard_index::num_shards]


def create_hdf5_dataset(
    data_root: str,
    annotation_file: str,
    class_file: str,
    output_hdf5: str,
    state: Mapping,
    config: ClipVisionConfig,
    max_frames: int | None = None,
    batch_size: int = 256,
    split: str = "val",
    dataset_name: str = "AnimalKingdom",
    clip_model_name: str = "ViT-B/16",
    compression: str | None = "gzip",
    dedup_threshold: float | None = None,
    stream_rows: int = 2048,
    mesh=None,
    half_precision: bool = True,
    num_shards: int = 1,
    shard_index: int = 0,
    device: str | torch.device = "cuda",
) -> dict[str, str]:
    """Extraction to the reference HDF5 layout, the public surface of
    extract_embeddings.py:23. Returns {video_id: error}.

    ``num_shards``/``shard_index`` take a strided slice of the annotation
    list (one job per shard, each writing its own file; ``cli/h5_merge.py``
    joins them). A shard's ``video_ids`` lists its own annotated ids, so the
    merged shards give the reference's whole index.
    """
    class_map = load_class_map(class_file)
    num_classes = len(class_map)
    annotations = shard_annotations(load_annotations(annotation_file), num_shards,
                                    shard_index)

    videos, labels_by_vid, skipped = [], {}, {}
    for vid, labels in annotations:
        path = os.path.join(data_root, vid)
        if not os.path.exists(path):
            logging.warning("video not found: %s", path)
            skipped[vid] = "not found"
            continue
        videos.append((vid, path))
        labels_by_vid[vid] = multi_hot(labels, num_classes)

    # the extractor first: a missing card raises before the file is opened
    extractor = ClipExtractor(state, config, batch_size=batch_size,
                              dedup_threshold=dedup_threshold, mesh=mesh,
                              half_precision=half_precision, device=device)

    # Subsample before embedding where the container reports a frame count
    # (the reference computes its indices first, extract_embeddings.py:77-84);
    # videos with no count are subsampled afterwards.
    frame_filter: dict[str, set] = {}
    container_total: dict[str, int] = {}
    if max_frames is not None:
        from concurrent.futures import ThreadPoolExecutor

        from vimoclip_tpu_torch.data import video_reader

        # one container open per video, over the decode-worker count
        with ThreadPoolExecutor(
            max_workers=max(extractor.decode_workers, 1)
        ) as ex:
            totals = ex.map(video_reader.video_frame_count, [p for _, p in videos])
            for (vid, _), total in zip(videos, totals):
                if total > 0:
                    container_total[vid] = total
                    if total > max_frames:
                        frame_filter[vid] = set(
                            uniform_indices(total, max_frames).tolist()
                        )

    # With max_frames set, only pre-filtered videos stream: a container that
    # claims total <= max_frames may decode more (CAP_PROP_FRAME_COUNT is
    # metadata), and the whole-video path keeps the len(emb) > max_frames
    # backstop. The filter admits at most max_frames indices whatever decodes.
    stream_ok: set[str] | None = None
    if max_frames is not None:
        stream_ok = set(frame_filter)

    os.makedirs(os.path.dirname(output_hdf5) or ".", exist_ok=True)
    writer = AsyncWriter(
        EmbeddingWriter(
            output_hdf5, num_classes=num_classes, dataset_name=dataset_name,
            split=split, clip_model=clip_model_name, compression=compression,
            embed_dim=config.projection_dim,
        )
    )

    def done(vid, emb):
        if emb is None:  # fully streamed: labels and attrs
            writer.finalize_video(
                vid, labels=labels_by_vid[vid],
                original_frames=container_total.get(vid),
            )
            return
        total = container_total.get(vid, len(emb))
        if max_frames is not None and vid not in frame_filter and len(emb) > max_frames:
            emb = emb[uniform_indices(len(emb), max_frames)]
        writer.submit(vid, emb, labels_by_vid[vid], original_frames=total)

    try:
        errors = extractor.extract(
            videos, done, frame_filter=frame_filter or None,
            on_video_chunk=writer.submit_chunk,
            on_video_abort=writer.abort_video,
            stream_rows=stream_rows,
            stream_ok=stream_ok,
        )
        # AK index semantics: every annotated id, failed and missing ones
        # included (extract_embeddings.py:118-119)
        writer.writer.set_video_ids([vid for vid, _ in annotations])
    finally:
        writer.close()
    errors.update(skipped)
    return errors
