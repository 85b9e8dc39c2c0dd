"""Fixed-shape batching helpers (the port's copy of
``vimoclip_tpu/ops/batching.py``).

Frame stacks go through the encoders in fixed ``batch_size`` chunks, the
tail padded: one shape per encoder keeps cuBLAS on one algorithm (results
do not depend on how full the last chunk is) and is what a CUDA-graph
capture would replay. Embedding sequences reach TFAM padded by one rule,
``pad_sequences``, in training's collate and in serving alike.
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


def pad_sequences(seqs: list[np.ndarray], bucket: int | None,
                  cap: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """TFAM's input layout: (T_i, D) arrays -> the zero-padded (B, T, D)
    array in their dtype and the (B, T) mask (True = real step). T is the
    longest T_i rounded up to ``bucket`` and capped at ``cap``; longer
    sequences are truncated. One allocation, filled in place."""
    t = round_up_bucket(max(len(s) for s in seqs), bucket, cap)
    out = np.zeros((len(seqs), t) + seqs[0].shape[1:], seqs[0].dtype)
    mask = np.zeros((len(seqs), t), bool)
    for i, s in enumerate(seqs):
        n = min(len(s), t)
        out[i, :n] = s[:n]
        mask[i, :n] = True
    return out, mask


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
