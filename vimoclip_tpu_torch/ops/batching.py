"""Fixed-shape batching helpers for the serving path (the port's copy of
``vimoclip_tpu/ops/batching.py``).

Frame stacks go through the encoders in fixed ``batch_size`` chunks, the
tail padded: one shape per encoder keeps cuBLAS on one algorithm (results
do not depend on how full the last chunk is) and is what a CUDA-graph
capture would replay. CUDA work is asynchronous until a result is copied
to the host, so chunk ``i+1`` is uploaded and enqueued before chunk ``i``'s
embeddings are fetched: one chunk stays in flight.
"""

from __future__ import annotations

import numpy as np
import torch


def round_up_bucket(n: int, bucket: int | None, cap: int | None = None) -> int:
    """Round ``n`` up to a multiple of ``bucket``, optionally capped."""
    if bucket:
        n = ((n + bucket - 1) // bucket) * bucket
    if cap is not None:
        n = min(n, cap)
    return n


def pad_to_batch(arr: np.ndarray, batch_size: int) -> np.ndarray:
    """Zero-pad the leading axis up to ``batch_size`` (no-op when full)."""
    n = arr.shape[0]
    if n >= batch_size:
        return arr
    pad = np.zeros((batch_size - n,) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([arr, pad])


def upload(frames, device: torch.device) -> torch.Tensor:
    """Host numpy (or a tensor anywhere) -> tensor on ``device``. Host data
    to a card goes through pinned memory with ``non_blocking`` so the copy
    overlaps work already queued on the stream."""
    if isinstance(frames, torch.Tensor):
        return frames.to(device)
    t = torch.from_numpy(np.ascontiguousarray(frames))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def embed_in_fixed_batches(
    embed_fn, frames: np.ndarray, batch_size: int, out_dim: int,
    device: torch.device,
) -> np.ndarray:
    """Run ``embed_fn`` (exactly ``batch_size`` frames in, (batch_size, D)
    float32 out) over an arbitrary-length host frame stack; returns
    (len(frames), out_dim) float32 numpy. Frames are uploaded chunk by
    chunk, so device residency stays bounded by two chunks."""
    out = []
    pending: tuple | None = None  # (device embeddings, valid row count)
    for i in range(0, frames.shape[0], batch_size):
        chunk = np.asarray(frames[i : i + batch_size])
        n = chunk.shape[0]
        dev = embed_fn(upload(pad_to_batch(chunk, batch_size), device))  # enqueued
        if pending is not None:
            out.append(pending[0][: pending[1]].cpu().numpy())
        pending = (dev, n)
    if pending is not None:
        out.append(pending[0][: pending[1]].cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, out_dim), np.float32)
