"""TFAM — Temporal Fusion of Appearance and Motion (the port's copy of
``vimoclip_tpu/models/tfam.py``).

- ``AttentionLayer``: post-norm block — self-attn -> +residual -> LN,
  cross-attn -> +residual -> LN, FFN -> +residual -> LN (eps 1e-5).
- Four fusion modes: rgb-only / motion-only self-attention; cross-attention
  (queries RGB, keys/values the original motion embeddings at every layer);
  self-attention over a temporal (concat_dim=1) or channel (concat_dim=-1,
  projection 2d -> d) concatenation with RGB truncated by one frame.
- Optional sinusoidal positional encoding.
- Head: mean-pool (the reference's unmasked pooling limited to the
  batch-max layout via ``pool_limits``, or ``masked_pooling``), then
  LN -> Linear(d->d/2) -> exact GELU -> Dropout -> Linear(d/2->C), in float32.

The ``state_dict`` is the reference AMO_CLIP layout (packed ``in_proj_weight``,
``ffn.0/3``, ``classifier.0/1/4``, ``projection_layer``), and like the
reference every layer owns ``cross_attn``/``norm_cross`` and the model owns
``projection_layer`` whatever the fusion mode, so reference ``best_model.pth``
files load with ``strict=True``.

Masks use the collate convention True = real frame.

In ``train()`` mode with dropout > 0 every random draw comes from the
``generator`` argument, which is then required: per layer the attention
dropout of both attention blocks, and five 8-bit-mask dropouts
(``ops/dropout.py``) as in JAX: on the two attention outputs, after the FFN
activation, after the second FFN linear and once more on the residual branch
(the reference's doubled FFN dropout, QUIRKS #13); and a Bernoulli dropout
(``mlp_dropout``) in the head.

Under data parallelism (``parallel/partition.py::parallelize_``) the batch
is this rank's rows of a global batch collated once: the pooling length of
the reference's batch-max pooling is taken over every data rank, and each
dropout draws the global mask and keeps its rows. Under a ``seq`` axis the
inputs stay whole in time; after the fusion mode's prologue (PE on the
global positions, the RGB[:-1] truncation, the concatenations) each rank
keeps its block of the trunk's time, the layers run ring attention over the
``seq`` group (``attention_impl: ring``), and the pooling sums the blocks
over the group. Under a ``pipe`` axis the layers run as GPipe stages
(``parallel/pipelining.py``), which reuses ``prologue``, ``cut_time``,
``pool`` and ``head``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from vimoclip_tpu_torch.config import TFAMModelConfig, check_model_config
from vimoclip_tpu_torch.models.clip_vit import layer_norm
from vimoclip_tpu_torch.ops.attention import MultiHeadAttention, dense
from vimoclip_tpu_torch.ops.dropout import Dropout, bernoulli_dropout
from vimoclip_tpu_torch.parallel.mesh import Shard
from vimoclip_tpu_torch.parallel.sequence import seq_sum

_LN_EPS = 1e-5


def sinusoidal_positional_encoding(
    seq_len: int, d_model: int, device: torch.device | str | None = None
) -> torch.Tensor:
    """Sinusoidal PE table, (seq_len, d_model) float32."""
    position = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / d_model)
    )
    angles = position * div_term
    pe = torch.zeros(seq_len, d_model, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles)
    return pe


def _activation(name: str):
    return nn.GELU() if name == "gelu" else nn.ReLU()


class AttentionLayer(nn.Module):
    """Post-norm transformer block with optional cross-attention."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attention_impl: str = "xla", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        mha = lambda: MultiHeadAttention(d_model, num_heads, dropout=dropout, dtype=dtype,
                                         implementation=attention_impl)
        self.self_attn = mha()
        self.cross_attn = mha()
        self.norm_self = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.norm_cross = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.ffn = nn.Sequential(
            nn.Linear(d_model, dim_feedforward), _activation(activation),
            Dropout(dropout, model_split=True, time_split=True),
            nn.Linear(dim_feedforward, d_model), Dropout(dropout, time_split=True),
        )
        self.norm_ffn = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.drop = Dropout(dropout, time_split=True)

    def forward(self, x, cross_src=None, src_key_padding_mask=None,
                cross_key_padding_mask=None, generator=None):
        g = generator
        attn = self.self_attn(x, key_padding_mask=src_key_padding_mask, generator=g)
        x = layer_norm(x + self.drop(attn, g), self.norm_self)
        if cross_src is not None:
            attn = self.cross_attn(x, kv=cross_src,
                                   key_padding_mask=cross_key_padding_mask, generator=g)
            x = layer_norm(x + self.drop(attn, g), self.norm_cross)
        h = self.ffn[2](self.ffn[1](dense(x, self.ffn[0], self.dtype)), g)
        h = self.ffn[4](dense(h, self.ffn[3], self.dtype), g)
        # the reference drops the FFN branch twice (QUIRKS #13)
        return layer_norm(x + self.ffn[4](h, g), self.norm_ffn)


class TFAM(nn.Module):
    """Fusion transformer over paired RGB / motion embedding sequences."""

    shard: Shard | None = None  # set by parallel.partition.parallelize_

    def __init__(self, config: TFAMModelConfig, num_classes: int = 140,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = check_model_config(config)
        self.num_classes = num_classes
        self.dtype = dtype
        d = cfg.d_model
        self.layers = nn.ModuleList(
            AttentionLayer(d, cfg.nhead, cfg.dim_feedforward, dropout=cfg.dropout,
                           activation=cfg.activation,
                           attention_impl=cfg.attention_impl, dtype=dtype)
            for _ in range(cfg.num_layers)
        )
        self.projection_layer = nn.Linear(2 * d, d)
        self.classifier = nn.Sequential(
            nn.LayerNorm(d, eps=_LN_EPS), nn.Linear(d, d // 2), nn.GELU(),
            nn.Dropout(cfg.mlp_dropout), nn.Linear(d // 2, num_classes),
        )

    def forward(self, rgb_emb, motion_emb, mask_rgb=None, mask_flow=None,
                generator: torch.Generator | None = None):
        """rgb_emb (B, T1, d), motion_emb (B, T2, d); masks (B, T) bool,
        True = real frame. Returns (B, num_classes) float32 logits.
        ``generator``: the source of every dropout draw, required in
        ``train()`` mode when a dropout rate is above 0. Under a ``seq``
        axis the inputs are whole in time and each rank runs the layers on
        its block of it (``cut_time``)."""
        self.check_generator(generator)
        if self.shard is not None and self.shard.pipe > 1:
            raise ValueError("a TFAM cut into pipeline stages runs through "
                             "parallel.pipelining.tfam_cross_pipeline_logits")
        trunk = self.cut_time(self.prologue(rgb_emb, motion_emb, mask_rgb, mask_flow))
        x = trunk.x
        for layer in self.layers:
            x = layer(x, cross_src=trunk.cross, src_key_padding_mask=trunk.attn,
                      cross_key_padding_mask=trunk.cross_attn, generator=generator)
        return self.head(self.pool(x, trunk), generator)

    def check_generator(self, generator) -> None:
        cfg = self.config
        if (self.training and (cfg.dropout > 0.0 or cfg.mlp_dropout > 0.0)
                and generator is None):
            raise ValueError("TFAM in train() mode with dropout > 0 needs a generator")

    def prologue(self, rgb_emb, motion_emb, mask_rgb=None, mask_flow=None) -> "Trunk":
        """The fusion mode's input to the layers, whole in time: PE, the
        key-padding masks (True = ignore), the concatenations and the
        reference's RGB[:-1] truncation, and what the pooling needs."""
        cfg = self.config
        attn_rgb = None if mask_rgb is None else ~mask_rgb
        attn_flow = None if mask_flow is None else ~mask_flow

        if cfg.use_pe:
            rgb_emb = rgb_emb + sinusoidal_positional_encoding(
                rgb_emb.shape[1], cfg.d_model, rgb_emb.device
            )[None].to(rgb_emb.dtype)
            motion_emb = motion_emb + sinusoidal_positional_encoding(
                motion_emb.shape[1], cfg.d_model, motion_emb.device
            )[None].to(motion_emb.dtype)

        def batch_max(mask, cap):
            # the reference pools over the batch-max padded length; bucket
            # padding beyond it is left out (vimoclip_tpu/models/tfam.py:181)
            if mask is None:
                return cap
            longest = mask.sum(dim=1).max()
            if self.shard is not None:  # the global batch's
                longest = self.shard.max_over_data(longest)
            return min(int(longest), cap)

        if cfg.use_only_rgb:
            return Trunk(rgb_emb, attn_rgb, None, None,
                         [(rgb_emb.shape[1], batch_max(mask_rgb, rgb_emb.shape[1]))], mask_rgb)
        if cfg.use_only_flow:
            return Trunk(motion_emb, attn_flow, None, None,
                         [(motion_emb.shape[1], batch_max(mask_flow, motion_emb.shape[1]))],
                         mask_flow)
        if cfg.use_cross_attention:
            return Trunk(rgb_emb, attn_rgb, motion_emb, attn_flow,
                         [(rgb_emb.shape[1], batch_max(mask_rgb, rgb_emb.shape[1]))], mask_rgb)
        # RGB drops its last frame to align with the T-1 motion frames;
        # positions >= batchmax-1 leave the key set under bucket padding
        s1_cap = rgb_emb.shape[1] - 1
        rgb_emb = rgb_emb[:, :-1, :]
        if attn_rgb is not None:
            keep = torch.arange(s1_cap, device=rgb_emb.device) < (
                batch_max(mask_rgb, s1_cap + 1) - 1)
            attn_rgb = attn_rgb[:, :-1] | ~keep[None, :]
        if cfg.concat_dim == 1:
            s1, s2 = rgb_emb.shape[1], motion_emb.shape[1]
            x = torch.cat([rgb_emb, motion_emb], dim=1)
            attn_mask = (None if attn_rgb is None or attn_flow is None
                         else torch.cat([attn_rgb, attn_flow], dim=1))
            lim1 = s1 if mask_rgb is None else min(batch_max(mask_rgb, s1 + 1) - 1, s1)
            pool_limits = [(s1, lim1), (s2, batch_max(mask_flow, s2))]
        elif cfg.concat_dim == -1:
            common = min(rgb_emb.shape[1], motion_emb.shape[1])
            x = torch.cat([rgb_emb[:, :common], motion_emb[:, :common]], dim=-1)
            x = self.projection_layer(x.float())
            attn_mask = None if attn_flow is None else attn_flow[:, :common]
            pool_limits = [(common, batch_max(mask_flow, common))]
        else:
            raise ValueError(f"concat_dim must be 1 or -1, got {cfg.concat_dim}")
        return Trunk(x, attn_mask, None, None, pool_limits,
                     None if attn_mask is None else ~attn_mask)

    def cut_time(self, trunk: "Trunk") -> "Trunk":
        """This rank's block of the trunk's time under a ``seq`` axis (the
        queries' and the cross keys' alike); the trunk itself without
        one."""
        n = 1 if self.shard is None else self.shard.seq
        if n == 1:
            return trunk
        if self.config.attention_impl not in ("ring", "ring_inner"):
            raise ValueError(
                f"under a seq axis of {n} the layers need attention_impl ring, not "
                f"{self.config.attention_impl!r}")
        tq = trunk.x.shape[1]
        tk = tq if trunk.cross is None else trunk.cross.shape[1]
        if tq % n or tk % n:
            raise ValueError(
                f"Tq={tq}, Tk={tk} must be divisible by the 'seq' axis size {n} — pad to a "
                "bucket first (data.pipeline length buckets already produce such shapes)")
        r = self.shard.seq_rank
        cut = lambda t: None if t is None else t.narrow(1, r * (t.shape[1] // n),
                                                         t.shape[1] // n)
        return Trunk(cut(trunk.x), cut(trunk.attn), cut(trunk.cross), cut(trunk.cross_attn),
                     trunk.pool_limits, trunk.pool_mask, local=cut)

    def pool(self, x: torch.Tensor, trunk: "Trunk") -> torch.Tensor:
        """The reference's unmasked mean over the batch-max layout, or the
        masked mean (``masked_pooling``); under a ``seq`` axis x is this
        rank's time block, summed over the ``seq`` group."""
        local = trunk.local or (lambda t: t)
        seq_group = None if trunk.local is None else self.shard.seq_group
        total = (lambda t: t) if seq_group is None else (lambda t: seq_sum(t, seq_group))
        if self.config.masked_pooling and trunk.pool_mask is not None:
            m = trunk.pool_mask[..., None].to(x.dtype)
            return total((x * local(m)).sum(dim=1)) / m.sum(dim=1).clamp_min(1.0)
        include = torch.cat([
            torch.arange(cap, device=x.device) < limit for cap, limit in trunk.pool_limits
        ])
        denom = max(sum(limit for _, limit in trunk.pool_limits), 1)
        include = local(include[None, :, None].to(x.dtype))
        return total((x * include).sum(dim=1)) / denom

    def head(self, pooled: torch.Tensor, generator=None) -> torch.Tensor:
        """LN -> Linear -> exact GELU -> Dropout -> Linear, in float32
        whatever the trunk's dtype."""
        h = layer_norm(pooled, self.classifier[0])
        h = F.gelu(self.classifier[1](h), approximate="none")
        if self.training and self.config.mlp_dropout > 0.0:
            h = bernoulli_dropout(h, self.config.mlp_dropout, generator, self.shard)
        return self.classifier[4](h)


@dataclasses.dataclass
class Trunk:
    """What the layers and the pooling take: x (B, L, d), its key-padding
    mask, the cross-attention keys (cross mode) and their mask, the pooling
    limits and mask (whole in time), and ``local``, the cut to this rank's
    time block under a ``seq`` axis (None without one)."""

    x: torch.Tensor
    attn: torch.Tensor | None
    cross: torch.Tensor | None
    cross_attn: torch.Tensor | None
    pool_limits: list
    pool_mask: torch.Tensor | None
    local: object = None
