"""HDF5 embedding storage, readers only (the port's copy of the reading half
of ``vimoclip_tpu/data/hdf5_schema.py``).

Per-video groups hold ``embeddings`` (T, D) and ``labels`` (C,): flat groups
keyed by ``<video_id>`` in the AK layout, groups nested under
``trimmed_videos/`` in the MN layout. ``h5py`` is imported inside each
function, so the package imports where it is not installed.
"""

from __future__ import annotations

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
