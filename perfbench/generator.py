"""The general traffic generator. A mix is a JSON file of parameters,
``perfbench/traffic/<name>.json``; this module turns its ``lengths`` into
clip lengths, finds the lengths that warm every padded shape, and makes
the host frames the drivers hand to the program.

Lengths are the distribution's quantiles at (i + 0.5) / count, rounded:
every seed gets the same set of lengths, in its own order, so the seed
changes which clip comes when and the pixels, never the amount of work."""

from __future__ import annotations

import math

import numpy as np


def quantiles(spec: dict) -> np.ndarray:
    """The ``count`` stratified lengths of ``{"dist": "loguniform" |
    "uniform", "low", "high", "count"}`` or ``{"dist": "exponential",
    "mean", "low", "high", "count"}``, ascending (ints, inclusive bounds).
    An exponential length past ``high`` is ``high``, as a loader that caps
    clips at ``high`` frames makes it."""
    lo, hi, n = float(spec["low"]), float(spec["high"]), int(spec["count"])
    u = (np.arange(n) + 0.5) / n
    if spec["dist"] == "loguniform":
        x = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif spec["dist"] == "uniform":
        x = lo + u * (hi - lo)
    elif spec["dist"] == "exponential":
        x = -float(spec["mean"]) * np.log1p(-u)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def lengths(spec: dict, rng: np.random.Generator) -> np.ndarray:
    """The stratified lengths in the order ``rng`` gives them."""
    return rng.permutation(quantiles(spec))


def make_frames(n: int, h: int = 360, w: int = 640, seed: int = 0) -> np.ndarray:
    """(n, h, w, 3) uint8 frames: random 1/24 x 1/32 scale images, linearly
    upscaled, so neighbouring pixels correlate as in a video."""
    import cv2

    rng = np.random.default_rng(seed)
    low = rng.integers(0, 256, (n, h // 24, w // 32, 3), dtype=np.uint8)
    return np.stack([cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR) for f in low])


def warm_lengths(spec: dict, bucket: int, cap: int | None) -> list[int]:
    """One length for every (RGB, motion) pair of padded lengths the
    stratified lengths reach: a clip of n frames pads n and n - 1 up to
    multiples of ``bucket``, capped at ``cap``."""
    pad = lambda n: min(-(-n // bucket) * bucket, cap or n + bucket)
    pairs = {}
    for n in quantiles(spec):
        pairs.setdefault((pad(int(n)), pad(int(n) - 1)), int(n))
    return sorted(pairs.values())
