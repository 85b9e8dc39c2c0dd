"""Masked multi-head attention with ``torch.nn.MultiheadAttention`` numerics
(the port's copy of ``vimoclip_tpu/ops/attention.py``).

- scale = 1/sqrt(head_dim) applied to q,
- key-padding mask: masked key columns get a large negative bias,
- q/k/v projections packed in ``in_proj_weight`` / ``in_proj_bias`` and an
  ``out_proj`` Linear: the state-dict layout of both torch's
  ``nn.MultiheadAttention`` (TFAM's AMO_CLIP) and OpenAI CLIP's visual
  blocks, so reference checkpoints load as they are;
- attention-weight dropout in ``train()`` mode, from a ``generator`` the
  caller passes: one int32 seed per (batch row, head) is drawn from it, and
  both paths drop the weights where the kernels' Philox bits for those seeds
  say so (``ops/kernels/flash_attention.py``), so the flash and eager paths
  agree to rounding with dropout on too.

Linear layers run in the module's compute ``dtype`` (weights are cast at
the call, kept float32), as the JAX modules do with ``nn.Dense(dtype=...)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vimoclip_tpu_torch.ops.kernels.flash_attention import (
    dropout_keep_mask,
    expand_seed,
    flash_attention,
)

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
    dropout_rate: float = 0.0,
    dropout_seed: torch.Tensor | int | None = None,
) -> torch.Tensor:
    """Eager scaled dot-product attention in the inputs' dtype: matmul ->
    softmax -> (dropout) -> matmul (the JAX package's "xla" path).

    q (B, H, Tq, Dh), k/v (B, H, Tk, Dh); key_padding_mask (B, Tk) bool,
    True = IGNORE the key. With ``dropout_rate`` > 0 the weights are kept
    where the flash kernels' Philox bits for ``dropout_seed`` (expanded as
    ``expand_seed``) say so, and divided by 1 - rate. Returns (B, H, Tq, Dh)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q * scale, k.transpose(-1, -2))
    if key_padding_mask is not None:
        bias = torch.where(key_padding_mask[:, None, None, :], _MASK_VALUE, 0.0)
        scores = scores + bias.to(scores.dtype)
    weights = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        b, h, tq, tk = weights.shape
        seed = expand_seed(dropout_seed, b, h, device=q.device)
        keep = dropout_keep_mask(seed, tq, tk, dropout_rate)
        weights = torch.where(keep, weights / (1.0 - dropout_rate), 0.0).to(v.dtype)
    return torch.matmul(weights, v)


class MultiHeadAttention(nn.Module):
    """torch-compatible MHA over (B, T, E) inputs.

    ``implementation``:
    - "xla": ``dot_product_attention`` (the name is the JAX package's);
    - "flash": the hand-written CUDA kernel on a card, its plain version on
      the CPU (``ops/kernels/flash_attention.py``);
    - "auto": flash for CUDA tensors with attention dropout active, or
      once the key length reaches the no-dropout crossover; the eager path
      otherwise.
    ``head_proj`` ("split" | "fused" | "fused_qkv") only rescheduled XLA's
    transposes in JAX; the math is one, and the port runs one layout.
    """

    # With dropout the kernels win at every length: the eager path builds its
    # Philox mask from int64 elementwise ops. chip_smoke.py phase 6 on an
    # NVIDIA H100 80GB HBM3 (700 W) timed a full-width train step at the
    # 128-frame bucket at 66.6 ms eager against 32.9 ms on the kernels.
    # Without dropout they win from the shortest bucket measured on: the same
    # phase timed TFAM's eval step (d512, 8 heads, 4 layers, batch 8) at
    # 8.94 ms eager against 6.79 ms on the kernels at 128 frames, and
    # 18.62 against 5.18 ms at 2048 (same card and limit; the run PERF.md
    # quotes). Shorter keys were not measured; the TFAM pipelines pad to
    # multiples of 128.
    _AUTO_FLASH_MIN_T_NODROP = 128

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
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """``generator``: required in ``train()`` mode with dropout > 0;
        one int32 seed per (batch row, head) is drawn from it."""
        dropping = self.training and self.dropout > 0.0
        if dropping and generator is None:
            raise ValueError("attention dropout in train() mode needs a generator")
        e, dt = self.embed_dim, self.dtype
        w, bias = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        if kv is None:  # self-attention: one packed projection
            q, k, v = F.linear(x.to(dt), w, bias).split(e, dim=-1)
        else:
            q = F.linear(x.to(dt), w[:e], bias[:e])
            k, v = F.linear(kv.to(dt), w[e:], bias[e:]).split(e, dim=-1)
        q, k, v = self._split_heads(q), self._split_heads(k), self._split_heads(v)

        rate, seed = 0.0, None
        if dropping:
            rate = self.dropout
            seed = torch.randint(0, 2**31 - 1, (q.shape[0], self.num_heads),
                                 generator=generator, device=generator.device,
                                 dtype=torch.int32).to(q.device)
        impl = self.implementation
        if impl == "auto":
            long_keys = k.shape[2] >= self._AUTO_FLASH_MIN_T_NODROP
            impl = "flash" if q.is_cuda and (dropping or long_keys) else "xla"
        if impl == "flash":
            out = flash_attention(q, k, v, key_padding_mask=key_padding_mask,
                                  dropout_rate=rate, dropout_seed=seed)
        else:
            out = dot_product_attention(q, k, v, key_padding_mask, rate, seed)
        b, _, s, _ = out.shape
        out = out.transpose(1, 2).reshape(b, s, e)
        return dense(out, self.out_proj, dt)
