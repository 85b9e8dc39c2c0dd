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
- under data and tensor parallelism (``shard``, ``parallel/partition.py``)
  the packed projection holds this rank's heads of q, k and v, the input
  enters through ``copy_to_model``, ``out_proj`` is row-parallel, and the
  seeds are drawn for the global (batch row, head) grid and cut to this
  rank's rows and heads, so a sharded step drops what the one-process step
  drops.
- ``"ring"`` / ``"ring_inner"`` (sequence parallelism): x and the mask are
  this rank's time shard and attention runs as ring attention over the
  ``seq`` group of the module's ``shard`` (``parallel/sequence.py``), with
  the kernels in every ring step on a card. JAX's ``ring_inner`` is the
  body it calls inside a pipeline stage's ``shard_map``; the port has no
  ``shard_map`` to nest, so both names run the same ring, and the pipeline
  stages (``parallel/pipelining.py``) use ``ring_inner``.

Linear layers run in the module's compute ``dtype`` (weights are cast at
the call, kept float32), as the JAX modules do with ``nn.Dense(dtype=...)``.
With ``quant="int8"`` the q/k/v and out projections run in dynamic int8
from the float32 weights (``ops/quant.py``); the attention products stay in
``dtype``.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from vimoclip_tpu_torch.ops.kernels.flash_attention import (
    WIDE_ABOVE_HEAD_DIM,
    dropout_keep_mask,
    expand_seed,
    flash_attention,
)
from vimoclip_tpu_torch.ops.quant import Int8Linear, int8_linear, make_dense
from vimoclip_tpu_torch.parallel.mesh import Shard, draw
from vimoclip_tpu_torch.parallel.partition import _ShardedLinear, copy_to_model
from vimoclip_tpu_torch.parallel.sequence import ring_attention
from vimoclip_tpu_torch.utils.profiling import annotate

# Additive mask value. Large-finite (not -inf) so a fully masked row comes
# out uniform instead of NaN; the flash kernel uses the same constant.
_MASK_VALUE = -1e9

IMPLEMENTATIONS = ("xla", "flash", "auto", "ring", "ring_inner")


# With dropout the kernels win at every length: the eager path builds its
# Philox mask from int64 elementwise ops. chip_smoke.py phase 6 on an
# NVIDIA H100 80GB HBM3 (700 W) timed a full-width train step at the
# 128-frame bucket at 66.6 ms eager against 32.9 ms on the kernels.
# Without dropout they win from the shortest bucket measured on: the same
# phase timed TFAM's eval step (d512, 8 heads, 4 layers, batch 8) at
# 8.94 ms eager against 6.79 ms on the kernels at 128 frames, and
# 18.62 against 5.18 ms at 2048 (same card and limit; the run PERF.md
# quotes). Shorter keys were not measured; the TFAM pipelines pad to
# multiples of 128. Those steps ran bf16; in float32 (phase 17, 8 heads, the
# three-pass TF32 kernels) the kernels won every bucket from 128 to 2048
# frames as well (train 20.0 against 61.1 ms at 128, 128.0 against 886.2 at
# 2048; eval 3.75 against 5.39 at 128; same card and limit).
AUTO_FLASH_MIN_T_NODROP = 128
# Above head dim 128 (the wide kernels) the crossover depends on the dtype
# and on dropout. chip_smoke.py phase 17 timed TFAM's steps (d512, 4 layers,
# batch 8) at 2 heads (head dim 256) and 1 (512), eager against the kernels,
# on an NVIDIA H100 80GB HBM3 (700.00 W). In bf16 the kernels won every
# bucket from 128 to 2048 frames, with dropout and without, but the 1-head
# eval step at 2048 (9.12 against 8.49 ms eager). In float32, the stage-2
# trainer's default, on the three-pass TF32 kernels (K3 among them since
# the float32 dq sweep left the FMA units): with dropout 0.1 the kernels'
# train step won every bucket at 2 heads (57.5 against 103.5 ms eager at
# 1024, 148.3 against 296.8 at 2048) and every bucket but 2048 at 1 head
# (67.1 against 73.3 at 1024; 202.4 against 196.8 at 2048), so a train
# step takes the kernels at every length: a cut at 2048 keys would have
# doubled the 2-head step there to save 3% of the 1-head one. Without
# dropout the eval step (K1 alone) won up to 512 frames at 2 heads (5.96
# against 7.70 ms), tied at 1024 (12.12 against 12.28) and lost at 2048
# (32.65 against 29.79); at 1 head it lost from 512 (5.86 against 5.39) and
# by 40% at 1024 (14.72 against 10.50).
AUTO_WIDE_FLASH_MAX_T_NODROP = 1024


def _auto_impl(is_cuda: bool, dropping: bool, tk: int, head_dim: int,
               dtype: torch.dtype) -> str:
    """``auto``'s route on CUDA tensors, by the crossovers measured for
    each head dim and dtype: up to ``WIDE_ABOVE_HEAD_DIM`` the kernels
    ("flash") when dropout is active or the keys reach
    ``AUTO_FLASH_MIN_T_NODROP``; above it the kernels in bf16 and, in
    float32, with dropout, and without dropout in float32 while the keys
    stay below ``AUTO_WIDE_FLASH_MAX_T_NODROP``. Eager attention ("xla")
    otherwise, and on the CPU."""
    if not is_cuda:
        return "xla"
    if head_dim > WIDE_ABOVE_HEAD_DIM:
        if dtype == torch.bfloat16 or dropping:
            return "flash"
        return "flash" if tk < AUTO_WIDE_FLASH_MAX_T_NODROP else "xla"
    return "flash" if dropping or tk >= AUTO_FLASH_MIN_T_NODROP else "xla"


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` with input, weight and bias cast to ``dtype``; an
    ``Int8Linear`` quantises ``x`` as it comes and its float32 weight, and
    returns ``dtype``; a column- or row-parallel layer adds its collective."""
    if isinstance(layer, Int8Linear):
        return int8_linear(x, layer.weight, layer.bias, dtype)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    if isinstance(layer, _ShardedLinear):
        return layer.product(x.to(dtype), layer.weight.to(dtype), bias)
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
    - "auto": on CUDA tensors, flash or the eager path by the crossovers
      measured for the head dim, the key length and dropout
      (``_auto_impl``); the eager path on the CPU;
    - "ring" / "ring_inner": ring attention over the ``seq`` group of
      ``shard`` (module docstring); without one it raises.
    ``span``: a span name (``utils/profiling.py::annotate``) around the
    attention core alone (scores, softmax and the value product, whichever
    route runs; the projections outside it): the vision towers' blocks open
    ``vimo.tower.attn``; TFAM names none (``flash_attention`` opens
    ``vimo.attn.fwd`` on its route).
    ``quant="int8"``: the projections in dynamic int8. The packed
    ``in_proj_weight``'s per-row scales are JAX's per-column scales of its
    q/k/v kernels, and every projection of a token shares its activation
    scale, so the result equals JAX's in each of its head-projection
    layouts (its fused int8 paths are bit-identical to Int8Dense-then-split).
    """

    shard: Shard | None = None  # set by parallel.partition.parallelize_

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        dropout: float = 0.0,
        dtype: torch.dtype = torch.float32,
        implementation: str = "xla",
        quant: str | None = None,
        span: str | None = None,
    ):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(
                f"embed_dim {embed_dim} not divisible by heads {num_heads}"
            )
        if implementation not in IMPLEMENTATIONS:
            raise ValueError(f"unknown attention implementation {implementation!r}")
        linear = make_dense(quant)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = dropout
        self.dtype = dtype
        self.implementation = implementation
        self.span = span
        self.quantized = linear is Int8Linear
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    @staticmethod
    def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
        b, s, _ = t.shape
        return t.view(b, s, heads, -1).transpose(1, 2)

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
        dt, shard = self.dtype, self.shard
        # this rank's width and heads: all of them unless tensor parallel
        e = self.in_proj_weight.shape[0] // 3
        heads = self.num_heads * e // self.embed_dim
        if e != self.embed_dim:
            x = copy_to_model(x, shard.model_group)
            kv = None if kv is None else copy_to_model(kv, shard.model_group)
        if not self.quantized:
            w, bias = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
            proj = lambda t, w_, b_: F.linear(t.to(dt), w_, b_)
        else:  # from the float32 weight and the activations as they come
            w, bias = self.in_proj_weight, self.in_proj_bias
            proj = lambda t, w_, b_: int8_linear(t, w_, b_, dt)
        if kv is None:  # self-attention: one packed projection
            q, k, v = proj(x, w, bias).split(e, dim=-1)
        else:
            q = proj(x, w[:e], bias[:e])
            k, v = proj(kv, w[e:], bias[e:]).split(e, dim=-1)
        q, k, v = (self._split_heads(t, heads) for t in (q, k, v))

        rate, seed = 0.0, None
        if dropping:
            rate = self.dropout
            sample = lambda s: torch.randint(0, 2**31 - 1, s, generator=generator,
                                             device=generator.device, dtype=torch.int32)
            seed = draw(sample, (q.shape[0], heads), shard, split_last=True).to(q.device)
        impl = self.implementation
        if impl == "auto":
            impl = _auto_impl(q.is_cuda, dropping, k.shape[2], q.shape[-1], q.dtype)
        with annotate(self.span) if self.span else contextlib.nullcontext():
            if impl in ("ring", "ring_inner"):
                ring = None if shard is None else shard.seq_ring
                if ring is None:
                    raise ValueError(
                        f'implementation="{impl}" needs a seq group (a mesh with a "seq" '
                        "axis, parallel/mesh.py): it is a runtime object, given to the "
                        "model by parallel.partition.parallelize_ under "
                        "training.parallelism.seq")
                out = ring_attention(q, k, v, key_padding_mask, ring, rate, seed)
            elif impl == "flash":
                out = flash_attention(q, k, v, key_padding_mask=key_padding_mask,
                                      dropout_rate=rate, dropout_seed=seed)
            else:
                out = dot_product_attention(q, k, v, key_padding_mask, rate, seed)
        b, _, s, _ = out.shape
        out = out.transpose(1, 2).reshape(b, s, e)
        return dense(out, self.out_proj, dt)
