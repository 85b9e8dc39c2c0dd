"""Plain SigLIP vision tower (``transformers``' ``SiglipVisionModel``, whose
``pooler_output`` is the embedding) and its frame preprocessing, float32,
for the benchmark's checks.

- ``preprocess``: uint8 (B, H, W, 3) -> Resize((S, S)), each axis on its own
  (no crop) -> (x / 255 - 0.5) / 0.5.
- ``tower``: patchify (the k = stride = p conv as a matmul, plus its bias;
  pixels past the last whole patch unused) + positions (no CLS, no pre-LN)
  -> pre-norm blocks (separate q/k/v/out projections with biases,
  GELU-tanh MLP) -> post-LN over every token -> attention-pooling head (a
  learned probe attends over every token with a packed ``in_proj``, then
  ``h + fc2(gelu_tanh(fc1(LN(h))))``) -> the probe's row. No projection.

Parameters use HF's ``SiglipVisionModel`` names without ``vision_model.``.

Departures from HF's ``SiglipImageProcessor``: the resize is the antialiased
Keys-cubic (a = -0.5) of ``reference/vit.py`` (``jax.image.resize``'s
weights), not PIL's bicubic, and runs on the frames as floats, with no
rounding back to uint8 before the normalisation; the same departure as
``reference/vit.py``'s CLIP preprocessing."""

from __future__ import annotations

import math

import torch

from perfbench.reference.precision import linear, matmul
from perfbench.reference.vit import resize_weights

MEAN = STD = 0.5


def param_shapes(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter; init is ``one`` (LayerNorm
    weights), ``zero`` (biases) or ``normal`` (the probe too)."""
    e, p, f = cfg["hidden_size"], cfg["patch_size"], cfg["intermediate_size"]
    n = (cfg["image_size"] // p) ** 2
    ln = lambda k: [(f"{k}.weight", (e,), "one"), (f"{k}.bias", (e,), "zero")]
    lin = lambda k, o, i: [(f"{k}.weight", (o, i), "normal"), (f"{k}.bias", (o,), "zero")]
    out = [("embeddings.patch_embedding.weight", (e, 3, p, p), "normal"),
           ("embeddings.patch_embedding.bias", (e,), "zero"),
           ("embeddings.position_embedding.weight", (n, e), "normal")]
    for i in range(cfg["num_layers"]):
        b = f"encoder.layers.{i}"
        out += [*ln(f"{b}.layer_norm1")]
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            out += lin(f"{b}.self_attn.{proj}", e, e)
        out += [*ln(f"{b}.layer_norm2"), *lin(f"{b}.mlp.fc1", f, e), *lin(f"{b}.mlp.fc2", e, f)]
    return out + [*ln("post_layernorm"), ("head.probe", (1, 1, e), "normal"),
                  ("head.attention.in_proj_weight", (3 * e, e), "normal"),
                  ("head.attention.in_proj_bias", (3 * e,), "zero"),
                  *lin("head.attention.out_proj", e, e), *ln("head.layernorm"),
                  *lin("head.mlp.fc1", f, e), *lin("head.mlp.fc2", e, f)]


def preprocess(frames: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, size, size, 3) float32 SigLIP inputs."""
    _, h, w, _ = frames.shape
    x = frames.float()
    dev = frames.device
    if w != size:
        x = torch.einsum("bhwc,wW->bhWc", x, torch.from_numpy(resize_weights(w, size)).to(dev))
    if h != size:
        x = torch.einsum("bhwc,hH->bHwc", x, torch.from_numpy(resize_weights(h, size)).to(dev))
    return (x - MEAN * 255.0) / (STD * 255.0)


def _ln(x, p, name, eps):
    return torch.nn.functional.layer_norm(x, x.shape[-1:], p[f"{name}.weight"].float(),
                                          p[f"{name}.bias"].float(), eps)


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _mlp(x, p, name, mode):
    h = _gelu_tanh(linear(x, p[f"{name}.fc1.weight"], p[f"{name}.fc1.bias"], mode))
    return linear(h, p[f"{name}.fc2.weight"], p[f"{name}.fc2.bias"], mode)


def _attend(q, k, v, heads, mode):
    """softmax(q k^T / sqrt(d)) v over (B, T, E) projections, per head."""
    b, tq, e = q.shape
    split = lambda z: z.reshape(b, z.shape[1], heads, -1).transpose(1, 2)
    q, k, v = split(q), split(k), split(v)
    s = matmul(q, k.transpose(-1, -2), mode) / math.sqrt(e // heads)
    return matmul(torch.softmax(s, dim=-1), v, mode).transpose(1, 2).reshape(b, tq, e)


def tower(params: dict, cfg: dict, pixels: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
    """(B, S, S, 3) float32 SigLIP inputs -> (B, hidden_size) embeddings."""
    e, p, eps, heads = cfg["hidden_size"], cfg["patch_size"], cfg["layer_norm_eps"], \
        cfg["num_heads"]
    b, g = pixels.shape[0], cfg["image_size"] // p
    patches = pixels[:, :g * p, :g * p].reshape(b, g, p, g, p, 3).permute(0, 1, 3, 5, 2, 4)
    x = linear(patches.reshape(b, g * g, -1),
               params["embeddings.patch_embedding.weight"].reshape(e, -1),
               params["embeddings.patch_embedding.bias"], mode)
    x = x + params["embeddings.position_embedding.weight"].float()
    for i in range(cfg["num_layers"]):
        n = f"encoder.layers.{i}"
        h = _ln(x, params, f"{n}.layer_norm1", eps)
        q, k, v = (linear(h, params[f"{n}.self_attn.{t}_proj.weight"],
                          params[f"{n}.self_attn.{t}_proj.bias"], mode) for t in "qkv")
        x = x + linear(_attend(q, k, v, heads, mode), params[f"{n}.self_attn.out_proj.weight"],
                       params[f"{n}.self_attn.out_proj.bias"], mode)
        x = x + _mlp(_ln(x, params, f"{n}.layer_norm2", eps), params, f"{n}.mlp", mode)
    x = _ln(x, params, "post_layernorm", eps)
    w, bias = params["head.attention.in_proj_weight"], params["head.attention.in_proj_bias"]
    probe = params["head.probe"].float().expand(b, 1, e)
    q = linear(probe, w[:e], bias[:e], mode)
    k = linear(x, w[e:2 * e], bias[e:2 * e], mode)
    v = linear(x, w[2 * e:], bias[2 * e:], mode)
    h = linear(_attend(q, k, v, heads, mode), params["head.attention.out_proj.weight"],
               params["head.attention.out_proj.bias"], mode)
    h = h + _mlp(_ln(h, params, "head.layernorm", eps), params, "head.mlp", mode)
    return h[:, 0]


def embed(params: dict, cfg: dict, frames: torch.Tensor, mode: str = "fp32",
          block: int = 32) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, hidden_size), ``block`` frames at a time."""
    with torch.no_grad():
        return torch.cat([tower(params, cfg, preprocess(frames[i:i + block],
                                                        cfg["image_size"]), mode)
                          for i in range(0, frames.shape[0], block)])
