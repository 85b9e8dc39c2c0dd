"""SigLIP vision tower (Zhai et al. 2023; the So400m shape of Alabdulmohsin
et al. 2023): ``transformers``' ``SiglipVisionModel``, whose
``pooler_output`` is the tower's embedding.

patch conv (k = stride = p, with a bias; pixels past the last whole patch
unused) -> learned positions (no CLS token, no pre-LN) -> N pre-norm blocks
(MHA with q/k/v/out biases, GELU-tanh MLP) -> post-LN over every token ->
attention-pooling (MAP) head: a learned probe attends over all tokens, then
``h + fc2(gelu(fc1(LN(h))))``, and the probe's row is the (B, hidden)
embedding. There is no projection.

The module's ``state_dict`` is HF's ``vision_model.*`` layout without the
prefix, but for the blocks' separate q/k/v projections, packed here into
``self_attn.in_proj_weight`` / ``in_proj_bias`` as the port's
``MultiHeadAttention`` holds them (the head's attention is
``nn.MultiheadAttention`` in HF too, packed already).
``models/convert.py::siglip_vision_state_from_hf`` maps an HF state.

As ``ClipVisionEncoder``: the public input is NHWC, patchify is a reshape
plus one matmul, linear layers run in the compute ``dtype`` and LayerNorms
in float32, so the residual stream is float32. As there, the blocks'
LayerNorms and the post-LN take the residual add before them
(``ops/kernels/layer_norm.py::add_layer_norm``, one kernel on a card in
inference) and write the dtype of the linears after them; the post-LN
takes the last block's MLP output. ``matmul_quant="int8"`` runs the
blocks' attention projections and both MLP linears in dynamic int8
(``ops/quant.py``); the patch embedding and the head stay in ``dtype``.
Token merging (ToMe) is not implemented for this tower.

Spans (``utils/profiling.py::annotate``): ``vimo.tower.attn`` around each
block's attention core (``ops/attention.py``), ``vimo.tower.head`` around the
MAP head.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from vimoclip_tpu_torch.models.clip_vit import layer_norm, norm_dtype
from vimoclip_tpu_torch.ops.attention import MultiHeadAttention, dense
from vimoclip_tpu_torch.ops.kernels.layer_norm import add_layer_norm
from vimoclip_tpu_torch.ops.quant import make_dense
from vimoclip_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    """Defaults: ``google/siglip-so400m-patch14-384``'s ``vision_config``."""

    image_size: int = 384
    patch_size: int = 14
    hidden_size: int = 1152
    num_layers: int = 27
    num_heads: int = 16
    intermediate_size: int = 4304
    layer_norm_eps: float = 1e-6
    attention_impl: str = "xla"
    matmul_quant: str | None = None  # None | "int8" (ops/quant.py), opt-in
    token_merge_r: int = 0  # not implemented here: must stay 0

    # the tower's frame preprocessing (ops/preprocess.py::clip_preprocess):
    # HF's SiglipImageProcessor resizes to (S, S) and maps x/255 to [-1, 1]
    resize = "squash"
    image_mean = (0.5, 0.5, 0.5)
    image_std = (0.5, 0.5, 0.5)

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid ** 2

    @property
    def embed_dim(self) -> int:
        """The width of the tower's output: the MAP head's, the hidden size."""
        return self.hidden_size


class _MLP(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, quant: str | None):
        super().__init__()
        linear = make_dense(quant)
        self.fc1 = linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = linear(cfg.intermediate_size, cfg.hidden_size)

    def run(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """fc2(gelu_tanh(fc1(x))): every SigLIP config's ``gelu_pytorch_tanh``."""
        h = F.gelu(dense(x, self.fc1, dtype), approximate="tanh")
        return dense(h, self.fc2, dtype)


class _Embeddings(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig):
        super().__init__()
        e, p = cfg.hidden_size, cfg.patch_size
        self.patch_embedding = nn.Conv2d(3, e, kernel_size=p, stride=p, bias=True)
        self.position_embedding = nn.Embedding(cfg.num_patches, e)


class SiglipEncoderLayer(nn.Module):
    """Pre-norm block (HF ``SiglipEncoderLayer`` keys, q/k/v packed)."""

    def __init__(self, cfg: SiglipVisionConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = MultiHeadAttention(
            cfg.hidden_size, cfg.num_heads, dtype=dtype, implementation=cfg.attention_impl,
            quant=cfg.matmul_quant, span="vimo.tower.attn")
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = _MLP(cfg, cfg.matmul_quant)
        self.norm_dtype = norm_dtype(cfg.matmul_quant, dtype)

    def forward(self, x: torch.Tensor, delta: torch.Tensor | None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """(residual stream, the last block's pending MLP output or None) ->
        (the stream after this block's attention, this block's MLP output):
        each residual add is fused into the LayerNorm that follows it."""
        x, h = add_layer_norm(x, delta, self.layer_norm1, self.norm_dtype)
        x, h = add_layer_norm(x, self.self_attn(h), self.layer_norm2, self.norm_dtype)
        return x, self.mlp.run(h, self.dtype)


class _Encoder(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, dtype: torch.dtype):
        super().__init__()
        self.layers = nn.ModuleList(SiglipEncoderLayer(cfg, dtype)
                                    for _ in range(cfg.num_layers))


class SiglipAttentionPoolingHead(nn.Module):
    """HF ``SiglipMultiheadAttentionPoolingHead``: one learned query over
    every token, then a residual MLP on its row."""

    def __init__(self, cfg: SiglipVisionConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.probe = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.attention = MultiHeadAttention(cfg.hidden_size, cfg.num_heads, dtype=dtype,
                                            implementation=cfg.attention_impl)
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = _MLP(cfg, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, E) post-LN tokens (any float dtype) -> (B, E) float32."""
        with annotate("vimo.tower.head"):
            probe = self.probe.expand(x.shape[0], 1, -1)
            h = self.attention(probe, kv=x).float()
            h = h + self.mlp.run(layer_norm(h, self.layernorm), self.dtype)
            return h[:, 0]


class SiglipVisionEncoder(nn.Module):
    """SigLIP visual tower: NHWC normalised images -> (B, hidden_size)
    embeddings (HF's ``pooler_output``) in the compute dtype."""

    def __init__(self, config: SiglipVisionConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if config.token_merge_r:
            raise ValueError("token merging (token_merge_r) is not implemented for the "
                             "SigLIP tower")
        cfg = self.config = config
        self.dtype = dtype
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg, dtype)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.head = SiglipAttentionPoolingHead(cfg, dtype)

    def patchify(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) -> (B, N, E): the g x g whole p x p patches flattened
        in (C, kh, kw) order against the conv's (E, C, kh, kw) weight, plus
        its bias; rows and columns past g p are unused, as by the conv."""
        cfg, dt = self.config, self.dtype
        b, p, g = pixels.shape[0], cfg.patch_size, cfg.grid
        x = pixels[:, : g * p, : g * p].to(dt).reshape(b, g, p, g, p, 3)
        x = x.permute(0, 1, 3, 5, 2, 4).reshape(b, g * g, 3 * p * p)
        conv = self.embeddings.patch_embedding
        return torch.addmm(conv.bias.to(dt), x.reshape(-1, 3 * p * p),
                           conv.weight.to(dt).reshape(cfg.hidden_size, -1).t()
                           ).view(b, g * g, -1)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if tuple(pixels.shape[1:]) != (cfg.image_size, cfg.image_size, 3):
            raise ValueError(
                f"expected NHWC ({cfg.image_size},{cfg.image_size},3) input, "
                f"got {tuple(pixels.shape[1:])}"
            )
        x = self.patchify(pixels).float() + self.embeddings.position_embedding.weight.float()
        delta = None
        for block in self.encoder.layers:
            x, delta = block(x, delta)
        _, h = add_layer_norm(x, delta, self.post_layernorm, self.dtype)
        return self.head(h).to(self.dtype)
