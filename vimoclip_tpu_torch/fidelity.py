"""Fidelity probe for the opt-in encoder approximations (the port's copy of
``vimoclip_tpu/fidelity.py``).

``--quantize int8`` (``ops/quant.py``) and ``--token-merge R``
(``ops/tome.py``) change the embeddings by an amount that depends on the
weights and the inputs. So every CLI that takes them also takes
``--verify-fidelity N``: before the long run starts, N frames sampled from
the user's own input go through the exact tower and the approximate one
with the same weights, on the run's device and in its dtype, and the
per-frame cosine is logged. Below ``--fidelity-threshold`` the run stops
with ``FidelityError``: the reference writes exact embeddings, and an
approximation is kept only when the user has seen what it costs.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Mapping

import numpy as np
import torch

from vimoclip_tpu_torch.utils.device import resolve_device


class FidelityError(RuntimeError):
    """The approximate encoder fell below the requested cosine threshold."""


def sample_video_frames(video_path: str, n: int) -> np.ndarray:
    """``n`` frames sampled uniformly from a video (fewer if it is shorter)."""
    from vimoclip_tpu_torch.data.video_reader import read_video

    frames = read_video(video_path)
    if len(frames) == 0:
        raise ValueError(f"no frames decoded from {video_path}")
    idx = np.unique(np.linspace(0, len(frames) - 1, n).astype(int))
    return frames[idx]


def sample_motion_probe_frames(video_path: str, n: int,
                               device: str | torch.device = "cuda") -> np.ndarray:
    """``n`` frame differences of consecutive decoded pairs, sampled
    uniformly: the student's input in the serving cascade (``frame_diff``,
    run on ``device``), whose sparse, near-black frames stress int8 scales
    and merges unlike RGB frames do."""
    from vimoclip_tpu_torch.data.video_reader import read_video
    from vimoclip_tpu_torch.ops.preprocess import frame_diff

    frames = read_video(video_path)
    if len(frames) < 2:
        raise ValueError(
            f"need >= 2 frames for a motion probe, got {len(frames)} from {video_path}"
        )
    idx = np.unique(np.linspace(0, len(frames) - 2, n).astype(int))
    pairs = np.stack([frames[idx], frames[idx + 1]], axis=1)  # (n, 2, H, W, 3)
    x = torch.from_numpy(pairs.reshape(-1, *pairs.shape[2:])).to(resolve_device(device))
    # consecutive rows of the flattened pairs: every other difference is a pair's
    return frame_diff(x)[0::2].cpu().numpy()


@torch.inference_mode()
def encoder_fidelity_probe(
    state: Mapping,
    approx_config,
    frames: np.ndarray,
    *,
    half_precision: bool = True,
    device: str | torch.device = "cuda",
) -> dict:
    """Per-frame cosine of the exact and the approximate tower, same
    weights, same preprocessing.

    ``state``: the tower's state dict (``ClipVisionEncoder`` layout);
    ``approx_config``: a ``ClipVisionConfig`` carrying the approximations,
    whose exact twin clears them; ``frames``: (N, H, W, 3) uint8. Returns
    ``cosine_min``, ``cosine_mean`` (float64 on the host), ``n_frames`` and
    ``config`` (a tag of what was approximated)."""
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionEncoder
    from vimoclip_tpu_torch.models.convert import to_tensors
    from vimoclip_tpu_torch.ops.preprocess import clip_preprocess

    exact_config = dataclasses.replace(approx_config, matmul_quant=None, token_merge_r=0)
    if exact_config == approx_config:
        raise ValueError(
            "encoder_fidelity_probe called with no approximation active "
            "(matmul_quant is None and token_merge_r is 0)"
        )
    dev = resolve_device(device)
    dtype = torch.bfloat16 if half_precision else torch.float32
    raw = torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
    pixels = clip_preprocess(raw, approx_config.image_size, dtype=dtype)
    tensors = to_tensors(state)

    def run(config) -> np.ndarray:
        enc = ClipVisionEncoder(config, dtype=dtype)
        enc.load_state_dict(tensors, strict=True)
        enc = enc.to(dev).eval()
        return enc(pixels).float().cpu().numpy().astype(np.float64)

    exact, approx = run(exact_config), run(approx_config)
    denom = np.linalg.norm(exact, axis=-1) * np.linalg.norm(approx, axis=-1)
    cos = (exact * approx).sum(-1) / np.maximum(denom, 1e-12)
    tags = []
    if approx_config.matmul_quant:
        tags.append(approx_config.matmul_quant)
    if approx_config.token_merge_r:
        tags.append(f"tome{approx_config.token_merge_r}")
    return {
        "cosine_min": float(cos.min()),
        "cosine_mean": float(cos.mean()),
        "n_frames": int(len(frames)),
        "config": "+".join(tags),
    }


def check_encoder_fidelity(
    state: Mapping,
    approx_config,
    probe_video: str,
    n_frames: int,
    threshold: float,
    *,
    half_precision: bool = True,
    encoder_name: str = "encoder",
    frames: np.ndarray | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """The CLIs' guard: sample ``n_frames`` from ``probe_video`` (unless
    ``frames`` are given), probe, log, and raise ``FidelityError`` below
    ``threshold``."""
    if frames is None:
        frames = sample_video_frames(probe_video, n_frames)
    report = encoder_fidelity_probe(state, approx_config, frames,
                                    half_precision=half_precision, device=device)
    logging.info(
        "fidelity probe (%s, %s, %d frames from %s): cosine min %.4f mean %.4f "
        "(threshold %.3f)",
        encoder_name, report["config"], report["n_frames"], probe_video,
        report["cosine_min"], report["cosine_mean"], threshold,
    )
    if report["cosine_min"] < threshold:
        raise FidelityError(
            f"{encoder_name} with {report['config']} reached cosine "
            f"{report['cosine_min']:.4f} on {report['n_frames']} sampled frames of "
            f"{probe_video} — below --fidelity-threshold {threshold}. Drop the "
            f"approximation flags (the default path is exact) or lower the "
            f"threshold if this fidelity is acceptable for your use."
        )
    return report
