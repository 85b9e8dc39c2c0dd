"""Weights from the seed, made on the device in one draw: every parameter
the reference lists as ``normal`` is cut from one ``torch.randn`` of their
total size (scaled by ``std``), LayerNorm weights are 1 and biases 0."""

from __future__ import annotations

import math

import torch

STD = 0.02


def make_params(shapes, generator: torch.Generator, std: float = STD) -> dict:
    """{name: float32 tensor on the generator's device} for ``shapes``, the
    (name, shape, init) list of a reference module."""
    dev = generator.device
    sizes = [math.prod(s) for _, s, init in shapes if init == "normal"]
    flat = torch.randn(sum(sizes), generator=generator, device=dev).mul_(std)
    parts = iter(flat.split(sizes))
    out = {}
    for name, shape, init in shapes:
        if init == "normal":
            out[name] = next(parts).view(shape)
        else:
            out[name] = torch.full(shape, 1.0 if init == "one" else 0.0, device=dev)
    return out


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on ``device`` for stream ``salt`` of run ``seed``."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + salt) % 2**63)
