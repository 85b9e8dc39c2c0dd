"""HDF5 embedding storage, the contract between the cascade's stages (the
port's copy of ``vimoclip_tpu/data/hdf5_schema.py``).

Per-video groups hold ``embeddings`` (T, D) and ``labels`` (C,): flat groups
keyed by ``<video_id>`` in the AK layout (gzip chunks (1, D), group attrs
``total_frames``/``original_frames``, file attrs ``num_classes``/
``dataset_name``/``type``/``clip_model``, a top-level ``video_ids`` string
dataset), groups nested under ``trimmed_videos/`` with resizable embeddings
in the MN layout.

- Readers: ``list_video_keys``, ``read_embeddings``, ``read_labels``,
  ``sequence_lengths``.
- Writers: ``EmbeddingWriter`` (whole-video and streaming appends, resume,
  error attrs, rollback) and ``AsyncWriter``, which runs one on its own
  thread so HDF5 and gzip stay off the device loop.
- Structure checks: ``analyze_structure`` / ``compare_structures``, the
  library form of the reference's ``utils/h5_structure_checker.py``.

``h5py`` is imported inside each function and constructor, so the package
imports where it is not installed.
"""

from __future__ import annotations

import queue
import threading
from typing import Any

import numpy as np


def list_video_keys(path: str, nested_prefix: str | None = None) -> list[str]:
    """Video group keys; ``nested_prefix`` reads the MN layout
    (``trimmed_videos/<id>``)."""
    import h5py

    with h5py.File(path, "r") as f:
        root = f[nested_prefix] if nested_prefix else f
        return [k for k in root.keys() if isinstance(root[k], h5py.Group)]


def read_embeddings(path: str, video_id: str, start: int = 0,
                    stop: int | None = None) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        ds = f[video_id]["embeddings"]
        return ds[start:stop] if stop is not None else ds[start:]


def read_labels(path: str, video_id: str) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        return f[video_id]["labels"][:]


def sequence_lengths(path: str, nested_prefix: str | None = None) -> dict[str, int]:
    """{video_id: T} from dataset shapes, without reading the data."""
    import h5py

    with h5py.File(path, "r") as f:
        root = f[nested_prefix] if nested_prefix else f
        out = {}
        for k in root.keys():
            if isinstance(root[k], h5py.Group) and "embeddings" in root[k]:
                out[k] = int(root[k]["embeddings"].shape[0])
        return out


class EmbeddingWriter:
    """Writer for both reference layouts, with resumable streaming appends::

        with EmbeddingWriter(path, num_classes=140, dataset_name="AnimalKingdom",
                             split="train", clip_model="ViT-B/16") as w:
            for vid, emb, labels in results:
                w.write_video(vid, emb, labels, original_frames=T)
    """

    def __init__(
        self,
        path: str,
        num_classes: int | None = None,
        dataset_name: str = "AnimalKingdom",
        split: str = "val",
        clip_model: str = "ViT-B/16",
        mode: str = "w",
        compression: str | None = "gzip",
        nested_prefix: str | None = None,
        embed_dim: int = 512,
        chunk_rows: int = 1,
    ):
        import h5py

        self._h5py = h5py
        self._file = h5py.File(path, mode)
        self.compression = compression
        self.embed_dim = embed_dim
        self.chunk_rows = chunk_rows
        self._explicit_ids: list[str] | None = None
        self.root = (
            self._file.require_group(nested_prefix) if nested_prefix else self._file
        )
        if mode == "w" or "num_classes" not in self._file.attrs:
            # file attrs of extract_embeddings.py:52-55
            if num_classes is not None:
                self._file.attrs["num_classes"] = num_classes
            self._file.attrs["dataset_name"] = dataset_name
            self._file.attrs["type"] = split
            self._file.attrs["clip_model"] = clip_model

    def write_video(
        self,
        video_id: str,
        embeddings: np.ndarray,
        labels: np.ndarray | None = None,
        original_frames: int | None = None,
    ) -> None:
        """One whole video (the AK extractor's layout)."""
        g = self.root.create_group(video_id)
        g.create_dataset(
            "embeddings",
            data=np.asarray(embeddings, dtype=np.float32),
            compression=self.compression,
            chunks=(min(self.chunk_rows, max(1, len(embeddings))), embeddings.shape[1]),
        )
        if labels is not None:
            g.create_dataset("labels", data=np.asarray(labels, dtype=np.float32))
        g.attrs["total_frames"] = len(embeddings)
        g.attrs["original_frames"] = (
            original_frames if original_frames is not None else len(embeddings)
        )

    def has_video(self, video_id: str) -> bool:
        """Resume: whether a group was already written."""
        return video_id in self.root

    def open_stream(self, video_id: str, chunk_rows: int = 2048) -> "_StreamingVideo":
        """A resizable (0, D) embeddings dataset to append chunks to."""
        g = self.root.create_group(video_id)
        ds = g.create_dataset(
            "embeddings",
            shape=(0, self.embed_dim),
            maxshape=(None, self.embed_dim),
            dtype=np.float32,
            compression=self.compression,
            chunks=(chunk_rows, self.embed_dim),
        )
        return _StreamingVideo(self._file, g, ds)

    def delete_video(self, video_id: str) -> None:
        """Remove a (possibly partial) group: a streamed video that failed
        mid-decode leaves no group, as the reference skips failed videos
        (extract_embeddings.py:113-115)."""
        if video_id in self.root:
            del self.root[video_id]

    def annotate_error(self, video_id: str, error: str, key: str = "error") -> None:
        """Record a per-video failure without ending the run."""
        g = self.root.require_group(video_id)
        g.attrs[key] = error

    def set_video_ids(self, ids: list[str]) -> None:
        """Explicit index: the AK extractor lists every annotated id, failed
        ones included (extract_embeddings.py:118-119)."""
        self._explicit_ids = list(ids)

    def close(self) -> None:
        """Close, rebuilding the top-level ``video_ids`` index from the
        file's live groups (unless ``set_video_ids`` gave one), so an
        append-mode resume indexes old and new groups and replaces a stale
        index."""
        if not self._file.id:
            return  # already closed
        ids = self._explicit_ids
        if ids is None:
            ids = [k for k in self.root.keys()
                   if isinstance(self.root[k], self._h5py.Group)]
        if ids:
            if "video_ids" in self._file:
                del self._file["video_ids"]
            self._file.create_dataset(
                "video_ids", data=np.array(ids, dtype=self._h5py.string_dtype())
            )
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _StreamingVideo:
    """Resize-append handle for one video's embeddings."""

    def __init__(self, file, group, ds):
        self._file, self._group, self._ds = file, group, ds

    def append(self, chunk: np.ndarray) -> None:
        chunk = np.asarray(chunk, dtype=np.float32)
        n = self._ds.shape[0]
        self._ds.resize(n + len(chunk), axis=0)
        self._ds[n:] = chunk
        self._file.flush()

    def finalize(self, labels: np.ndarray | None = None,
                 original_frames: int | None = None) -> None:
        if labels is not None:
            self._group.create_dataset("labels", data=np.asarray(labels, np.float32))
        t = self._ds.shape[0]
        self._group.attrs["total_frames"] = t
        # only None falls back: an explicit 0 (a header that reported no
        # frames) is kept, as in write_video
        self._group.attrs["original_frames"] = (
            t if original_frames is None else original_frames
        )


class AsyncWriter:
    """An ``EmbeddingWriter`` on its own thread, fed by a bounded queue:
    whole videos (``submit``) and streamed chunks (``submit_chunk`` +
    ``finalize_video``, or ``abort_video``). An error on the writer thread
    is raised by the next ``submit*`` call or by ``close``."""

    _DONE = object()

    def __init__(self, writer: EmbeddingWriter, max_queue: int = 16):
        self.writer = writer
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._error: Exception | None = None
        self._streams: dict[str, _StreamingVideo] = {}
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                return
            op, args = item
            try:
                if op == "video":
                    self.writer.write_video(*args)
                elif op == "chunk":
                    vid, chunk = args
                    stream = self._streams.get(vid)
                    if stream is None:
                        stream = self._streams[vid] = self.writer.open_stream(vid)
                    stream.append(chunk)
                elif op == "final":
                    vid, labels, original_frames = args
                    stream = self._streams.pop(vid, None)
                    if stream is None:  # no chunk was streamed: an empty video
                        stream = self.writer.open_stream(vid)
                    stream.finalize(labels=labels, original_frames=original_frames)
                elif op == "abort":
                    (vid,) = args
                    self._streams.pop(vid, None)
                    self.writer.delete_video(vid)
            except Exception as e:  # raised again by the next submit or close
                self._error = e

    def _put(self, op, args):
        if self._error:
            raise self._error
        self._q.put((op, args))

    def submit(self, video_id, embeddings, labels=None, original_frames=None):
        self._put("video", (video_id, embeddings, labels, original_frames))

    def submit_chunk(self, video_id, chunk):
        self._put("chunk", (video_id, chunk))

    def finalize_video(self, video_id, labels=None, original_frames=None):
        self._put("final", (video_id, labels, original_frames))

    def abort_video(self, video_id):
        self._put("abort", (video_id,))

    def close(self):
        self._q.put(self._DONE)
        self._thread.join()
        self.writer.close()
        if self._error:
            raise self._error


def _group_structure(g) -> dict[str, Any]:
    import h5py

    datasets = {k: v for k, v in g.items() if isinstance(v, h5py.Dataset)}
    subgroups = [k for k, v in g.items() if isinstance(v, h5py.Group)]
    return {
        "dataset_names": sorted(datasets),
        "dataset_dtypes": {k: str(v.dtype) for k, v in datasets.items()},
        "dataset_ndims": {k: v.ndim for k, v in datasets.items()},
        "num_datasets": len(datasets),
        "has_subgroups": bool(subgroups),
        "subgroup_names": sorted(subgroups),
    }


def analyze_structure(path: str) -> dict[str, Any]:
    """Structural fingerprint of an embeddings HDF5 file."""
    import h5py

    with h5py.File(path, "r") as f:
        groups = [k for k, v in f.items() if isinstance(v, h5py.Group)]
        root_datasets = [k for k, v in f.items() if isinstance(v, h5py.Dataset)]
        sample = _group_structure(f[groups[0]]) if groups else None
        consistent = all(
            _group_structure(f[g]) == sample for g in groups[1:]
        ) if groups else True
        return {
            "path": path,
            "num_groups": len(groups),
            "num_datasets": len(root_datasets),
            "root_dataset_names": sorted(root_datasets),
            "file_attrs": sorted(f.attrs),
            "all_groups_same_structure": consistent,
            "sample_group_structure": sample,
        }


def compare_structures(a: dict[str, Any], b: dict[str, Any]) -> tuple[bool, list[str]]:
    """(True, []) when two files share the structural pattern, else (False,
    the issues) (h5_structure_checker.py:97-147, returned instead of
    printed)."""
    issues = []
    if a["num_datasets"] != b["num_datasets"]:
        issues.append(
            f"root-level dataset count differs: {a['num_datasets']} vs {b['num_datasets']}"
        )
    if a["all_groups_same_structure"] != b["all_groups_same_structure"]:
        issues.append("group structure consistency differs")
    sa, sb = a["sample_group_structure"], b["sample_group_structure"]
    if (sa is None) != (sb is None):
        issues.append("one file has groups while the other doesn't")
    elif sa is not None:
        for field in ("dataset_names", "dataset_dtypes", "num_datasets",
                      "has_subgroups", "subgroup_names"):
            if sa[field] != sb[field]:
                issues.append(f"group {field} differs: {sa[field]} vs {sb[field]}")
    return (not issues, issues)
