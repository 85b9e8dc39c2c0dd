"""What the drivers share: the port's configuration objects from a
configuration file, weights from the seed, the window's loop and clock, and
the port's kernel launch counters."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from perfbench import weights
from perfbench.reference import vit as ref_vit

def vision_config(spec: dict, int8: bool = False):
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig

    fields = {f.name for f in dataclasses.fields(ClipVisionConfig)}
    cfg = ClipVisionConfig(**{k: v for k, v in spec.items() if k in fields})
    return dataclasses.replace(cfg, matmul_quant="int8") if int8 else cfg


def tfam_config(spec: dict):
    from vimoclip_tpu_torch.config import TFAMModelConfig

    return TFAMModelConfig(**spec)


def tower_params(spec: dict, seed: int, salt: int, device) -> dict:
    return weights.make_params(ref_vit.param_shapes(spec), weights.generator(seed, salt, device))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def launches() -> dict:
    """The port's kernel launches so far, by kind."""
    from vimoclip_tpu_torch.ops.kernels.flash_attention import flash_attention
    from vimoclip_tpu_torch.ops.kernels.normalize import fused_normalize

    return {**flash_attention.launches, "fused_normalize": fused_normalize.launches}


def launches_per_unit(before: dict, units: int) -> dict:
    return {k: (n - before[k]) / max(units, 1) for k, n in launches().items()
            if n != before[k]}


def frame_pool(traffic: dict, seed: int) -> np.ndarray:
    from perfbench.generator import make_frames

    h, w = traffic["frame_hw"]
    return make_frames(traffic["pool_frames"], h, w, seed=seed % 2**63)


def cos_and_rel(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    """The worst row's cosine distance and relative L2 error."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    dot = (got * want).sum(axis=1)
    norms = np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1)
    cos_d = 1.0 - dot / np.maximum(norms, 1e-300)
    rel = np.linalg.norm(got - want, axis=1) / np.maximum(np.linalg.norm(want, axis=1), 1e-300)
    return float(cos_d.max()), float(rel.max())


class Clock:
    """The window's host clock; a run of work ends in a device sync."""

    def __init__(self, device):
        self.device = device
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def stop(self) -> float:
        sync(self.device)
        return self.elapsed()

# a check's reading where no answer came to compare: fails every limit
NO_ANSWER = 1e30
