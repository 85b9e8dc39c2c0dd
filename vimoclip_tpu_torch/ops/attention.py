"""Masked multi-head attention with ``torch.nn.MultiheadAttention`` numerics
(the port's copy of ``vimoclip_tpu/ops/attention.py``).

- scale = 1/sqrt(head_dim) applied to q,
- key-padding mask: masked key columns get a large negative bias,
- q/k/v projections packed in ``in_proj_weight`` / ``in_proj_bias`` and an
  ``out_proj`` Linear: the state-dict layout of both torch's
  ``nn.MultiheadAttention`` (TFAM's AMO_CLIP) and OpenAI CLIP's visual
  blocks, so reference checkpoints load as they are.

Linear layers run in the module's compute ``dtype`` (weights are cast at
the call, kept float32), as the JAX modules do with ``nn.Dense(dtype=...)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vimoclip_tpu_torch.ops.kernels.flash_attention import flash_attention

# Additive mask value. Large-finite (not -inf) so a fully masked row comes
# out uniform instead of NaN; the flash kernel uses the same constant.
_MASK_VALUE = -1e9

IMPLEMENTATIONS = ("xla", "flash", "auto")


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` with input, weight and bias cast to ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Eager scaled dot-product attention in the inputs' dtype: matmul ->
    softmax -> matmul (the JAX package's "xla" path).

    q (B, H, Tq, Dh), k/v (B, H, Tk, Dh); key_padding_mask (B, Tk) bool,
    True = IGNORE the key. Returns (B, H, Tq, Dh)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q * scale, k.transpose(-1, -2))
    if key_padding_mask is not None:
        bias = torch.where(key_padding_mask[:, None, None, :], _MASK_VALUE, 0.0)
        scores = scores + bias.to(scores.dtype)
    weights = torch.softmax(scores, dim=-1)
    return torch.matmul(weights, v)


class MultiHeadAttention(nn.Module):
    """torch-compatible MHA over (B, T, E) inputs.

    ``implementation``:
    - "xla": ``dot_product_attention`` (the name is the JAX package's);
    - "flash": the hand-written CUDA kernel on a card, its plain version on
      the CPU (``ops/kernels/flash_attention.py``);
    - "auto": flash for CUDA tensors once the key length reaches the
      crossover, the eager path otherwise.
    ``head_proj`` ("split" | "fused" | "fused_qkv") only rescheduled XLA's
    transposes in JAX; the math is one, and the port runs one layout.
    """

    # Crossover lengths carried over from the JAX package as they are: they
    # were measured on a TPU v5e (vimoclip_tpu/ops/attention.py:229-237). An
    # H100 measurement of the eager path against the kernel is still owed
    # (ROADMAP.md); until then "auto" keeps these values.
    _AUTO_FLASH_MIN_T_DROPOUT = 256
    _AUTO_FLASH_MIN_T_NODROP = 2048

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        dropout: float = 0.0,
        dtype: torch.dtype = torch.float32,
        implementation: str = "xla",
        quant: str | None = None,
        head_proj: str = "split",
    ):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(
                f"embed_dim {embed_dim} not divisible by heads {num_heads}"
            )
        if implementation in ("ring", "ring_inner"):
            raise NotImplementedError(
                f"implementation={implementation!r} (sequence-parallel ring "
                "attention) comes with the multi-GPU slice of the port"
            )
        if implementation not in IMPLEMENTATIONS:
            raise ValueError(f"unknown attention implementation {implementation!r}")
        if quant is not None:
            raise NotImplementedError(
                f"quant={quant!r}: int8 matmuls come with the opt-in "
                "accelerators slice of the port"
            )
        if head_proj not in ("split", "fused", "fused_qkv"):
            raise ValueError(f"unknown head_proj {head_proj!r}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = dropout
        self.dtype = dtype
        self.implementation = implementation
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def _split_heads(self, t: torch.Tensor) -> torch.Tensor:
        b, s, _ = t.shape
        return t.view(b, s, self.num_heads, -1).transpose(1, 2)

    def forward(
        self,
        x: torch.Tensor,
        kv: torch.Tensor | None = None,
        key_padding_mask: torch.Tensor | None = None,
    ) -> torch.Tensor:
        if self.training and self.dropout > 0.0:
            raise NotImplementedError(
                "attention dropout in train mode comes with the TFAM training "
                "slice of the port; call .eval() for inference"
            )
        e, dt = self.embed_dim, self.dtype
        w, bias = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        if kv is None:  # self-attention: one packed projection
            q, k, v = F.linear(x.to(dt), w, bias).split(e, dim=-1)
        else:
            q = F.linear(x.to(dt), w[:e], bias[:e])
            k, v = F.linear(kv.to(dt), w[e:], bias[e:]).split(e, dim=-1)
        q, k, v = self._split_heads(q), self._split_heads(k), self._split_heads(v)

        impl = self.implementation
        if impl == "auto":
            impl = ("flash" if k.shape[2] >= self._AUTO_FLASH_MIN_T_NODROP
                    and q.is_cuda else "xla")
        if impl == "flash":
            out = flash_attention(q, k, v, key_padding_mask=key_padding_mask)
        else:
            out = dot_product_attention(q, k, v, key_padding_mask)
        b, _, s, _ = out.shape
        out = out.transpose(1, 2).reshape(b, s, e)
        return dense(out, self.out_proj, dt)
