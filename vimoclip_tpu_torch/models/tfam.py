"""TFAM — Temporal Fusion of Appearance and Motion (the port's copy of
``vimoclip_tpu/models/tfam.py``), inference only.

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

Masks use the collate convention True = real frame. Training (dropout > 0 in
``train()`` mode) raises: it comes with the TFAM training slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vimoclip_tpu_torch.config import TFAMModelConfig, check_model_config
from vimoclip_tpu_torch.models.clip_vit import layer_norm
from vimoclip_tpu_torch.ops.attention import MultiHeadAttention, dense

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
                 attention_impl: str = "xla", head_proj: str = "split",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        mha = lambda: MultiHeadAttention(
            d_model, num_heads, dropout=dropout, dtype=dtype,
            implementation=attention_impl, head_proj=head_proj,
        )
        self.self_attn = mha()
        self.cross_attn = mha()
        self.norm_self = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.norm_cross = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.ffn = nn.Sequential(
            nn.Linear(d_model, dim_feedforward), _activation(activation),
            nn.Dropout(dropout), nn.Linear(dim_feedforward, d_model),
            nn.Dropout(dropout),
        )
        self.norm_ffn = nn.LayerNorm(d_model, eps=_LN_EPS)

    def forward(self, x, cross_src=None, src_key_padding_mask=None,
                cross_key_padding_mask=None):
        x = layer_norm(x + self.self_attn(x, key_padding_mask=src_key_padding_mask),
                       self.norm_self)
        if cross_src is not None:
            attn = self.cross_attn(x, kv=cross_src,
                                   key_padding_mask=cross_key_padding_mask)
            x = layer_norm(x + attn, self.norm_cross)
        h = self.ffn[1](dense(x, self.ffn[0], self.dtype))
        h = dense(h, self.ffn[3], self.dtype)
        return layer_norm(x + h, self.norm_ffn)


class TFAM(nn.Module):
    """Fusion transformer over paired RGB / motion embedding sequences."""

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
                           attention_impl=cfg.attention_impl,
                           head_proj=cfg.head_proj, dtype=dtype)
            for _ in range(cfg.num_layers)
        )
        self.projection_layer = nn.Linear(2 * d, d)
        self.classifier = nn.Sequential(
            nn.LayerNorm(d, eps=_LN_EPS), nn.Linear(d, d // 2), nn.GELU(),
            nn.Dropout(cfg.mlp_dropout), nn.Linear(d // 2, num_classes),
        )

    def forward(self, rgb_emb, motion_emb, mask_rgb=None, mask_flow=None):
        """rgb_emb (B, T1, d), motion_emb (B, T2, d); masks (B, T) bool,
        True = real frame. Returns (B, num_classes) float32 logits."""
        cfg = self.config
        if self.training and (cfg.dropout > 0.0 or cfg.mlp_dropout > 0.0):
            raise NotImplementedError(
                "TFAM in train() mode with dropout > 0 is training work: it "
                "comes with the TFAM training slice of the port; call .eval()"
            )
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
            return min(int(mask.sum(dim=1).max()), cap)

        pool_mask = None
        if cfg.use_only_rgb:
            x, pool_mask = rgb_emb, mask_rgb
            pool_limits = [(x.shape[1], batch_max(mask_rgb, x.shape[1]))]
            for layer in self.layers:
                x = layer(x, src_key_padding_mask=attn_rgb)
        elif cfg.use_only_flow:
            x, pool_mask = motion_emb, mask_flow
            pool_limits = [(x.shape[1], batch_max(mask_flow, x.shape[1]))]
            for layer in self.layers:
                x = layer(x, src_key_padding_mask=attn_flow)
        elif cfg.use_cross_attention:
            x, pool_mask = rgb_emb, mask_rgb
            pool_limits = [(x.shape[1], batch_max(mask_rgb, x.shape[1]))]
            for layer in self.layers:
                x = layer(x, cross_src=motion_emb, src_key_padding_mask=attn_rgb,
                          cross_key_padding_mask=attn_flow)
        else:
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
                lim1 = s1 if mask_rgb is None else min(
                    batch_max(mask_rgb, s1 + 1) - 1, s1)
                pool_limits = [(s1, lim1), (s2, batch_max(mask_flow, s2))]
            elif cfg.concat_dim == -1:
                common = min(rgb_emb.shape[1], motion_emb.shape[1])
                x = torch.cat([rgb_emb[:, :common], motion_emb[:, :common]], dim=-1)
                x = self.projection_layer(x.float())
                attn_mask = None if attn_flow is None else attn_flow[:, :common]
                pool_limits = [(common, batch_max(mask_flow, common))]
            else:
                raise ValueError(f"concat_dim must be 1 or -1, got {cfg.concat_dim}")
            pool_mask = None if attn_mask is None else ~attn_mask
            for layer in self.layers:
                x = layer(x, src_key_padding_mask=attn_mask)

        if cfg.masked_pooling and pool_mask is not None:
            m = pool_mask[..., None].to(x.dtype)
            pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
        else:
            include = torch.cat([
                torch.arange(cap, device=x.device) < limit
                for cap, limit in pool_limits
            ])
            denom = max(sum(limit for _, limit in pool_limits), 1)
            pooled = (x * include[None, :, None].to(x.dtype)).sum(dim=1) / denom

        # the head runs in float32 whatever the trunk's dtype
        h = layer_norm(pooled, self.classifier[0])
        h = F.gelu(self.classifier[1](h), approximate="none")
        return self.classifier[4](h)
