"""The port's documented random streams, re-derived for the reference.

- ``stream_seed``: the stage-2 trainer draws step ``i``'s dropout from a
  ``torch.Generator`` seeded with the first 8 bytes (big endian, top bit
  cleared) of SHA-256 over ``"<seed>/dropout/<i>"``.
- ``philox_keep``: attention dropout keeps weight (b, h, row, key) where
  word key % 4 of Philox4x32-10 at counter (row, key // 4, 0, 0) and key
  (seed[b, h] as uint32, 0) is below round((1 - p) 2^32).
- ``epoch_order``: the loader shuffles epoch ``e`` with
  ``numpy.random.default_rng((seed, e))``."""

from __future__ import annotations

import hashlib

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_M = (0xD2511F53, 0xCD9E8D57)
_W = (0x9E3779B9, 0xBB67AE85)


def stream_seed(seed: int, name: str, index: int) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{name}/{int(index)}".encode()).digest()
    return int.from_bytes(digest[:8], "big") & (2**63 - 1)


def stream(seed: int, name: str, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, name, index))


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    idx = np.arange(n)
    np.random.default_rng((seed, epoch)).shuffle(idx)
    return idx


def _mulhilo(m: int, x: torch.Tensor):
    lo = m * (x & 0xFFFF)
    hi = m * (x >> 16)
    s = lo + ((hi & 0xFFFF) << 16)
    return ((s >> 32) + (hi >> 16)) & _MASK32, s & _MASK32


def _philox(c0, c1, k0):
    """The four words of Philox4x32-10 at counter (c0, c1, 0, 0), key (k0, 0)."""
    zero = torch.zeros((), dtype=torch.int64, device=c0.device)
    c = [c0, c1, zero, zero]
    k1 = zero
    for i in range(10):
        if i:
            k0 = (k0 + _W[0]) & _MASK32
            k1 = (k1 + _W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_M[0], c[0])
        hi1, lo1 = _mulhilo(_M[1], c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def philox_keep(seed: torch.Tensor, tq: int, tk: int, rate: float) -> torch.Tensor:
    """(H,) int32 seeds of one batch row -> (H, tq, tk) bool keep mask."""
    dev = seed.device
    groups = (tk + 3) // 4
    rows = torch.arange(tq, device=dev, dtype=torch.int64).view(1, tq, 1)
    cols = torch.arange(groups, device=dev, dtype=torch.int64).view(1, 1, groups)
    key = (seed.to(torch.int64) & _MASK32).view(-1, 1, 1)
    words = _philox(rows, cols, key)
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    bits = bits.reshape(*bits.shape[:2], groups * 4)[..., :tk]
    threshold = min(2**32 - 1, int(round((1.0 - rate) * 2.0**32)))
    return bits < threshold
