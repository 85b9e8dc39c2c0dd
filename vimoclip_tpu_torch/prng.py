"""Seeding (the port's copy of ``vimoclip_tpu/prng.py``).

The reference seeds python, numpy and torch globally (``set_seed``). Dropout
and other per-step randomness come from named streams: ``KeyChain(seed)
("dropout", step)`` always gives the same ``torch.Generator`` for the same
(seed, name, index), across processes, so a run resumed in mid-epoch draws
the same dropout masks as the run it continues.
"""

from __future__ import annotations

import hashlib
import random

import numpy as np
import torch


def set_seed(seed: int = 0) -> None:
    """Seed python, numpy and torch (every device)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class KeyChain:
    """Deterministic named streams derived from one experiment seed.

    ``seed(name, index)`` is a stable 63-bit integer taken from a SHA-256
    digest of (seed, name, index) (``hash()`` is randomised per process);
    ``chain(name, index, device)`` is a ``torch.Generator`` on ``device``
    seeded with it. JAX folds the same triple into a PRNG key; the two
    streams differ, as any two frameworks' do."""

    def __init__(self, seed: int):
        self.root = int(seed)

    def seed(self, name: str, index: int = 0) -> int:
        digest = hashlib.sha256(f"{self.root}/{name}/{int(index)}".encode()).digest()
        return int.from_bytes(digest[:8], "big") & (2**63 - 1)

    def __call__(self, name: str, index: int = 0,
                 device: torch.device | str = "cpu") -> torch.Generator:
        return torch.Generator(device=device).manual_seed(self.seed(name, index))
