"""CLIP ViT visual encoder (the port's copy of
``vimoclip_tpu/models/clip_vit.py``).

patchify (no bias) -> prepend CLS -> learned position embeddings -> pre-LN ->
N pre-norm blocks (MHA + QuickGELU MLP) -> post-LN on CLS -> projection.

The module's ``state_dict`` is OpenAI CLIP's ``visual.*`` layout without the
``visual.`` prefix (``conv1``, ``class_embedding``, ``positional_embedding``,
``ln_pre``, ``transformer.resblocks.{i}.{ln_1,attn,ln_2,mlp.c_fc,mlp.c_proj}``,
``ln_post``, ``proj``), so OpenAI CLIP and reference student checkpoints load
with ``strict=True``.

The public input is NHWC, as in JAX. Patchify is a reshape plus one matmul
(no cuDNN convolution, so no TF32 rounding of float32 inputs). Linear layers
run in the compute ``dtype`` and LayerNorms in float32, mirroring flax's
type promotion: the residual stream is float32.

Two opt-in approximations, off by default (``fidelity.py`` measures them):
``matmul_quant="int8"`` runs the blocks' attention projections and both MLP
linears in dynamic int8 (``ops/quant.py``; the patch embedding and ``proj``
stay in ``dtype``, as in JAX), and ``token_merge_r`` merges that many tokens
after every block but the last (``ops/tome.py``). With merging off the
schedule is all zeros: one layer loop for both paths, as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from vimoclip_tpu_torch.ops.attention import MultiHeadAttention, dense
from vimoclip_tpu_torch.ops.quant import make_dense
from vimoclip_tpu_torch.ops.tome import bipartite_merge, merge_schedule


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    attention_impl: str = "xla"
    head_proj: str = "fused"
    matmul_quant: str | None = None  # None | "int8" (ops/quant.py), opt-in
    token_merge_r: int = 0  # tokens merged after each block (ops/tome.py), opt-in

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @staticmethod
    def vit_b_16() -> "ClipVisionConfig":
        return ClipVisionConfig(patch_size=16)

    @staticmethod
    def vit_b_32() -> "ClipVisionConfig":
        return ClipVisionConfig(patch_size=32)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm in float32 (flax promotes a bf16 input with f32 params)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)


class _MLP(nn.Module):
    def __init__(self, cfg: ClipVisionConfig):
        super().__init__()
        linear = make_dense(cfg.matmul_quant)
        self.c_fc = linear(cfg.hidden_size, cfg.intermediate_size)
        self.c_proj = linear(cfg.intermediate_size, cfg.hidden_size)


class _Transformer(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, dtype: torch.dtype):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ClipEncoderLayer(cfg, dtype) for _ in range(cfg.num_layers)
        )


class ClipEncoderLayer(nn.Module):
    """Pre-norm transformer block (OpenAI ``ResidualAttentionBlock`` keys)."""

    def __init__(self, cfg: ClipVisionConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.act = quick_gelu if cfg.hidden_act == "quick_gelu" else (
            lambda t: F.gelu(t, approximate="none")
        )
        self.ln_1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.attn = MultiHeadAttention(
            cfg.hidden_size, cfg.num_heads, dtype=dtype,
            implementation=cfg.attention_impl, quant=cfg.matmul_quant,
            head_proj=cfg.head_proj,
        )
        self.ln_2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = _MLP(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(layer_norm(x, self.ln_1))
        h = dense(layer_norm(x, self.ln_2), self.mlp.c_fc, self.dtype)
        h = dense(self.act(h), self.mlp.c_proj, self.dtype)
        return x + h


class ClipVisionEncoder(nn.Module):
    """CLIP visual tower: NHWC CLIP-normalised images -> (B, projection_dim)
    image embeddings in the compute dtype."""

    def __init__(self, config: ClipVisionConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        e, p = cfg.hidden_size, cfg.patch_size
        self.conv1 = nn.Conv2d(3, e, kernel_size=p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(e))
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.num_patches + 1, e))
        self.ln_pre = nn.LayerNorm(e, eps=cfg.layer_norm_eps)
        self.transformer = _Transformer(cfg, dtype)
        self.ln_post = nn.LayerNorm(e, eps=cfg.layer_norm_eps)
        self.proj = nn.Parameter(torch.zeros(e, cfg.projection_dim))

    def patchify(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) -> (B, N, E): non-overlapping p x p patches flattened
        in (C, kh, kw) order against conv1's (E, C, kh, kw) weight."""
        cfg, dt = self.config, self.dtype
        b, p, g = pixels.shape[0], cfg.patch_size, cfg.image_size // cfg.patch_size
        x = pixels.to(dt).reshape(b, g, p, g, p, 3).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(b, g * g, 3 * p * p)
        return x @ self.conv1.weight.to(dt).reshape(cfg.hidden_size, -1).t()

    def forward(self, pixels: torch.Tensor, return_hidden: bool = False):
        cfg, dt = self.config, self.dtype
        if tuple(pixels.shape[1:]) != (cfg.image_size, cfg.image_size, 3):
            raise ValueError(
                f"expected NHWC ({cfg.image_size},{cfg.image_size},3) input, "
                f"got {tuple(pixels.shape[1:])}"
            )
        b = pixels.shape[0]
        patches = self.patchify(pixels)
        cls = self.class_embedding.to(dt).expand(b, 1, cfg.hidden_size)
        x = torch.cat([cls, patches], dim=1) + self.positional_embedding.to(dt)
        x = layer_norm(x, self.ln_pre)
        schedule = [0] * (cfg.num_layers - 1)
        sizes = None
        if cfg.token_merge_r:
            schedule = merge_schedule(cfg.num_patches + 1, cfg.num_layers, cfg.token_merge_r)
            sizes = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
        for i, block in enumerate(self.transformer.resblocks):
            x = block(x)
            if i < cfg.num_layers - 1 and schedule[i]:
                x, sizes = bipartite_merge(x, sizes, schedule[i])
        pooled = layer_norm(x[:, 0, :], self.ln_post)
        embeds = pooled.to(dt) @ self.proj.to(dt)
        if return_hidden:
            return embeds, x
        return embeds
