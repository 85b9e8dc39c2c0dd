"""Plain CLIP ViT (OpenAI's visual tower) and the port's frame preprocessing,
float32, for the benchmark's checks.

- ``preprocess``: uint8 (B, H, W, 3) -> Resize(short edge, bicubic Keys
  a = -0.5, antialiased, as ``jax.image.resize`` weighs it) ->
  CenterCrop -> (x / 255 - mean) / std.
- ``tower``: patchify (conv as a matmul) -> CLS + positions -> ln_pre ->
  pre-norm blocks (MHA, QuickGELU MLP) -> ln_post on CLS -> proj.
- ``frame_diff``: BT.601 luma of each frame (OpenCV's float32 steps,
  rounded to uint8), absolute difference of consecutive frames, replicated
  to 3 channels.
Parameters use OpenAI's ``visual.*`` names without the prefix."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.precision import linear, matmul

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
BT601 = (0.299, 0.587, 0.114)


def param_shapes(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter; init is ``one`` (LayerNorm
    weights), ``zero`` (biases) or ``normal``."""
    e, p, f = cfg["hidden_size"], cfg["patch_size"], cfg["intermediate_size"]
    n = (cfg["image_size"] // p) ** 2 + 1
    ln = lambda k: [(f"{k}.weight", (e,), "one"), (f"{k}.bias", (e,), "zero")]
    out = [("conv1.weight", (e, 3, p, p), "normal"), ("class_embedding", (e,), "normal"),
           ("positional_embedding", (n, e), "normal"), *ln("ln_pre")]
    for i in range(cfg["num_layers"]):
        b = f"transformer.resblocks.{i}"
        out += [*ln(f"{b}.ln_1"),
                (f"{b}.attn.in_proj_weight", (3 * e, e), "normal"),
                (f"{b}.attn.in_proj_bias", (3 * e,), "zero"),
                (f"{b}.attn.out_proj.weight", (e, e), "normal"),
                (f"{b}.attn.out_proj.bias", (e,), "zero"),
                *ln(f"{b}.ln_2"),
                (f"{b}.mlp.c_fc.weight", (f, e), "normal"),
                (f"{b}.mlp.c_fc.bias", (f,), "zero"),
                (f"{b}.mlp.c_proj.weight", (e, f), "normal"),
                (f"{b}.mlp.c_proj.bias", (e,), "zero")]
    return out + [*ln("ln_post"), ("proj", (e, cfg["projection_dim"]), "normal")]


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    f = np.float32
    near = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    far = ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x + f(2.0)
    out = np.where(x >= 1.0, far, near)
    return np.where(x >= 2.0, f(0.0), out).astype(np.float32)


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) antialiased Keys-cubic weights (jax.image.resize's)."""
    f = np.float32
    inv = f(1.0 / (n_out / n_in))
    kscale = max(inv, f(1.0))
    sample = (np.arange(n_out, dtype=f) + f(0.5)) * inv - f(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f)[:, None]) / kscale
    w = _keys_cubic(x.astype(f))
    total = np.sum(w, axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f(0.0)).astype(f)


def preprocess(frames: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, size, size, 3) float32 CLIP inputs."""
    _, h, w, _ = frames.shape
    if h <= w:
        nh, nw = size, max(size, int(round(w * size / h)))
    else:
        nh, nw = max(size, int(round(h * size / w))), size
    x = frames.float()
    dev = frames.device
    if (h, w) != (nh, nw):
        ww = torch.from_numpy(resize_weights(w, nw)).to(dev)
        wh = torch.from_numpy(resize_weights(h, nh)).to(dev)
        x = torch.einsum("bhwc,wW->bhWc", x, ww)
        x = torch.einsum("bhwc,hH->bHwc", x, wh)
    top, left = int(round((nh - size) / 2.0)), int(round((nw - size) / 2.0))
    x = x[:, top:top + size, left:left + size, :]
    mean = torch.tensor(CLIP_MEAN, device=dev) * 255.0
    std = torch.tensor(CLIP_STD, device=dev) * 255.0
    return (x - mean) / std


def _ln(x, p, name, eps):
    return torch.nn.functional.layer_norm(x, x.shape[-1:], p[f"{name}.weight"].float(),
                                          p[f"{name}.bias"].float(), eps)


def _attention(x, p, name, heads, mode):
    b, t, e = x.shape
    q, k, v = linear(x, p[f"{name}.in_proj_weight"], p[f"{name}.in_proj_bias"],
                     mode).split(e, dim=-1)
    split = lambda z: z.view(b, t, heads, -1).transpose(1, 2)
    q, k, v = split(q), split(k), split(v)
    s = matmul(q / (e // heads) ** 0.5, k.transpose(-1, -2), mode)
    o = matmul(torch.softmax(s, dim=-1), v, mode).transpose(1, 2).reshape(b, t, e)
    return linear(o, p[f"{name}.out_proj.weight"], p[f"{name}.out_proj.bias"], mode)


def tower(params: dict, cfg: dict, pixels: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
    """(B, S, S, 3) float32 CLIP inputs -> (B, projection_dim) embeddings."""
    e, p, eps = cfg["hidden_size"], cfg["patch_size"], cfg["layer_norm_eps"]
    b, g = pixels.shape[0], cfg["image_size"] // p
    patches = pixels.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 5, 2, 4).reshape(b, g * g, -1)
    x = matmul(patches, params["conv1.weight"].reshape(e, -1).t(), mode)
    cls = params["class_embedding"].float().expand(b, 1, e)
    x = torch.cat([cls, x], dim=1) + params["positional_embedding"].float()
    x = _ln(x, params, "ln_pre", eps)
    for i in range(cfg["num_layers"]):
        n = f"transformer.resblocks.{i}"
        x = x + _attention(_ln(x, params, f"{n}.ln_1", eps), params, f"{n}.attn",
                           cfg["num_heads"], mode)
        h = linear(_ln(x, params, f"{n}.ln_2", eps), params[f"{n}.mlp.c_fc.weight"],
                   params[f"{n}.mlp.c_fc.bias"], mode)
        h = h * torch.sigmoid(1.702 * h)
        x = x + linear(h, params[f"{n}.mlp.c_proj.weight"], params[f"{n}.mlp.c_proj.bias"],
                       mode)
    return matmul(_ln(x[:, 0], params, "ln_post", eps), params["proj"], mode)


def embed(params: dict, cfg: dict, frames: torch.Tensor, mode: str = "fp32",
          block: int = 32) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, projection_dim), ``block`` frames at a time."""
    with torch.no_grad():
        return torch.cat([tower(params, cfg, preprocess(frames[i:i + block],
                                                        cfg["image_size"]), mode)
                          for i in range(0, frames.shape[0], block)])


def frame_diff(frames: torch.Tensor) -> torch.Tensor:
    """(T, H, W, 3) uint8 -> (T - 1, H, W, 3) uint8 grey differences; the
    luma is OpenCV's chain of fused multiply-adds, rounded to float32 once
    a step (exact in float64 before each rounding), then to uint8."""
    x = frames.double()
    w = [float(np.float32(c)) for c in BT601]
    f32 = lambda t: t.float().double()
    y = f32(f32(f32(x[..., 0] * w[0]) + x[..., 1] * w[1]) + x[..., 2] * w[2])
    gray = torch.round(y.float()).clamp(0, 255).double()
    diff = (gray[1:] - gray[:-1]).abs().to(torch.uint8)
    return diff[..., None].expand(*diff.shape, 3).contiguous()
