"""The vision towers' one factory: every entry point (serving, extraction,
export, the student, the benchmark CLI) builds its tower, maps a state into
the tower's layout and preprocesses frames for it from the tower's config,
whichever kind the config's type names:

- ``ClipVisionConfig``: OpenAI CLIP's ViT (``models/clip_vit.py``), the
  short-edge resize and center crop, CLIP's mean and std;
- ``SiglipVisionConfig``: SigLIP's ViT with the attention-pooling head
  (``models/siglip_vit.py``), the squash resize, mean and std 0.5.

A tower's output width is ``config.embed_dim`` (CLIP's projection, SigLIP's
hidden size)."""

from __future__ import annotations

from typing import Mapping, Union

import torch
from torch import nn

from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
from vimoclip_tpu_torch.models.convert import siglip_vision_state_from_hf
from vimoclip_tpu_torch.models.siglip_vit import SiglipVisionConfig, SiglipVisionEncoder
from vimoclip_tpu_torch.ops.preprocess import clip_preprocess

VisionConfig = Union[ClipVisionConfig, SiglipVisionConfig]


def vision_tower(config: VisionConfig, dtype: torch.dtype = torch.float32) -> nn.Module:
    """The tower ``config`` describes, in the compute ``dtype``."""
    if isinstance(config, SiglipVisionConfig):
        return SiglipVisionEncoder(config, dtype=dtype)
    if isinstance(config, ClipVisionConfig):
        return ClipVisionEncoder(config, dtype=dtype)
    raise TypeError(f"not a vision tower's config: {type(config).__name__}")


def tower_state(config: VisionConfig, state: Mapping) -> dict:
    """``state`` in the layout of ``config``'s tower: a SigLIP tower also
    takes HF's ``SiglipVisionModel`` names (``models/convert.py``)."""
    if isinstance(config, SiglipVisionConfig):
        return siglip_vision_state_from_hf(state)
    return dict(state)


def preprocess(frames: torch.Tensor, config: VisionConfig,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> the tower's (B, S, S, 3) ``dtype`` inputs."""
    return clip_preprocess(frames, config.image_size, dtype=dtype, resize=config.resize,
                           mean=config.image_mean, std=config.image_std)
