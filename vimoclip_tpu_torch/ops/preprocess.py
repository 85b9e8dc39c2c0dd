"""On-device image and video preprocessing (the port's copy of
``vimoclip_tpu/ops/preprocess.py``).

- ``clip_preprocess``: uint8 NHWC -> bicubic antialiased resize -> the
  tower's normalisation, as two small matrix products. The resize rule is
  CLIP's (``"crop"``: the short edge to S, then a center crop) or SigLIP's
  (``"squash"``: each axis to S on its own, no crop); mean and std are the
  tower's (CLIP's by default). The crop is folded into the resize weight
  matrices, and input pixels the crop never samples are sliced off before
  the contraction.
- ``frame_diff``: BT.601 grayscale absolute difference of consecutive frames,
  replicated to 3 channels (what a saved grayscale video decodes back as).

The resize matrices are the ones JAX's ``jax.image.resize`` contracts with
(``compute_weight_mat`` with the Keys cubic kernel, antialiased), rebuilt
here in numpy float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# OpenAI CLIP normalisation constants.
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# ITU-R BT.601 luma weights used by cv2.cvtColor(..., COLOR_*2GRAY).
_BT601 = (0.299, 0.587, 0.114)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys cubic convolution kernel (a = -0.5), as JAX evaluates it."""
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    far = ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x \
        + np.float32(2.0)
    out = np.where(x >= 1.0, far, out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def compute_weight_mat(input_size: int, output_size: int) -> np.ndarray:
    """(input_size, output_size) float32 weights of an antialiased Keys-cubic
    resize with no translation: the matrix JAX's ``compute_weight_mat``
    builds for ``jax.image.resize(..., method="bicubic", antialias=True)``."""
    f32 = np.float32
    # JAX takes 1/scale in double precision, then works in float32
    inv_scale = f32(1.0 / (output_size / input_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(output_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(input_size, dtype=f32)[:, None]) \
        / kernel_scale
    weights = _keys_cubic(x.astype(f32))
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    )
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def normalize(images: torch.Tensor, mean=CLIP_MEAN, std=CLIP_STD) -> torch.Tensor:
    """(x/255 - mean) / std for float images already in [0, 255]; the result
    is float32 whatever the input's float type (the constants are f32)."""
    mean = torch.tensor(mean, dtype=torch.float32, device=images.device) * 255.0
    std = torch.tensor(std, dtype=torch.float32, device=images.device) * 255.0
    return (images - mean) / std


RESIZE_RULES = ("crop", "squash")


@functools.lru_cache(maxsize=32)
def _crop_resize_weights(h: int, w: int, size: int, resize: str = "crop"):
    """Host weight matrices for ``resize``: ``"crop"`` resizes the shortest
    edge to ``size`` and center-crops, the crop folded into the resize;
    ``"squash"`` resizes each axis to ``size`` on its own. Returns ((wh, h0,
    h1), (ww, w0, w1)): per axis a weight matrix (None for a no-op axis)
    over the input window [x0, x1)."""
    if resize not in RESIZE_RULES:
        raise ValueError(f"unknown resize rule {resize!r}; known: {RESIZE_RULES}")
    if resize == "squash":
        new_h = new_w = size
    elif h <= w:
        new_h, new_w = size, max(size, int(round(w * size / h)))
    else:
        new_h, new_w = max(size, int(round(h * size / w))), size

    def axis(m: int, n: int):
        if m == n == size:
            return None, 0, m
        mat = compute_weight_mat(m, n)
        if n != size:  # fold the center crop into the columns
            lo = int(round((n - size) / 2.0))
            mat = mat[:, lo : lo + size]
        nz = np.nonzero(np.abs(mat).sum(axis=1))[0]
        x0, x1 = int(nz[0]), int(nz[-1]) + 1
        return np.ascontiguousarray(mat[x0:x1]), x0, x1

    return axis(h, new_h), axis(w, new_w)


@functools.lru_cache(maxsize=32)
def _weights_on(h: int, w: int, size: int, device: str, dtype: torch.dtype,
                resize: str = "crop"):
    (wh, h0, h1), (ww, w0, w1) = _crop_resize_weights(h, w, size, resize)
    put = lambda m: None if m is None else torch.from_numpy(m).to(device, dtype)
    return (put(wh), h0, h1), (put(ww), w0, w1)


def clip_preprocess(
    frames: torch.Tensor, image_size: int = 224, dtype: torch.dtype = torch.float32,
    resize: str = "crop", mean=CLIP_MEAN, std=CLIP_STD,
) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, S, S, 3) normalised ``dtype`` images:
    Resize(S, bicubic) -> CenterCrop(S) -> ToTensor -> Normalize(mean, std)
    with ``resize="crop"`` (CLIP's), Resize((S, S), bicubic) -> ToTensor ->
    Normalize with ``"squash"`` (SigLIP's: every pixel row and column kept,
    the aspect ratio not).

    The contraction runs in the output's precision: float32 output uses a
    float32 contraction, bfloat16 output a bfloat16 one (bf16 operands,
    f32 accumulation inside the matmul, bf16 result).

    Frames that already have the encoder's size need neither resize nor
    crop: they go through ``fused_normalize`` (kernel K5 on a card), the
    same function as ``normalize`` up to one float32 ulp (it multiplies by
    1/(255 std) where ``normalize`` divides by 255 std)."""
    if frames.dtype != torch.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(
            f"expected (B, H, W, 3) uint8 frames, got {tuple(frames.shape)} "
            f"{frames.dtype}"
        )
    cdtype = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    (wh, h0, h1), (ww, w0, w1) = _weights_on(
        frames.shape[1], frames.shape[2], image_size, str(frames.device), cdtype, resize
    )
    if wh is None and ww is None:
        # imported here: the kernel's module takes its constants from this one
        from vimoclip_tpu_torch.ops.kernels.normalize import fused_normalize

        return fused_normalize(frames, mean, std, dtype=cdtype).to(dtype)
    x = frames[:, h0:h1, w0:w1, :].to(cdtype)
    if ww is not None:  # (B, h, w, C) x (w, W) -> (B, h, W, C)
        x = torch.einsum("bhwc,wW->bhWc", x, ww)
    if wh is not None:  # (B, h, W, C) x (h, H) -> (B, H, W, C)
        x = torch.einsum("bhwc,hH->bHwc", x, wh)
    return normalize(x, mean, std).to(dtype)


def rgb_to_gray(frames: torch.Tensor) -> torch.Tensor:
    """BT.601 luma, uint8-rounded like cv2.cvtColor: (B, H, W, 3) -> (B, H, W).

    The weighted sum is the fused multiply-add chain
    fma(b, w2, fma(g, w1, r * w0)) in float32, each step rounded once. It is
    evaluated in float64, where every product and sum here is exact, and
    rounded to float32 after each step, so the result is the same on any
    device (pixels at an exact .5 luma round the same way everywhere)."""
    x = frames.to(torch.float64)
    w = [float(np.float32(c)) for c in _BT601]
    y = (x[..., 0] * w[0]).to(torch.float32).to(torch.float64)
    y = (y + x[..., 1] * w[1]).to(torch.float32).to(torch.float64)
    y = (y + x[..., 2] * w[2]).to(torch.float32)
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


def frame_diff(frames: torch.Tensor, replicate_channels: bool = True) -> torch.Tensor:
    """(T, H, W, 3) uint8 RGB -> (T-1, H, W, 3) uint8 absolute grayscale
    differences of consecutive frames ((T-1, H, W) without replication)."""
    gray = rgb_to_gray(frames).to(torch.int16)
    diff = (gray[1:] - gray[:-1]).abs().to(torch.uint8)
    if replicate_channels:
        diff = diff[..., None].expand(*diff.shape, 3).contiguous()
    return diff
