"""MoCLIP student (the port's copy of ``vimoclip_tpu/models/student.py``):
a vision tower (CLIP's ViT, or SigLIP's) over motion frames with a
residual-MLP distillation branch and a classification head.

- (B, T, H, W, 3) uint8 motion frames -> (B*T, ...) -> the tower's
  preprocessing (``clip_preprocess``; kernel K5 when the frames already have
  the encoder's size) -> the vision tower its config names
  (``models/towers.py``: CLIP's ViT, or SigLIP's) in the compute dtype ->
  (B, T, P) embeddings, P the tower's ``embed_dim``, cast to float32 before
  both branches;
- distillation: ``x + alpha * fc2(gelu(fc1(x)))``, exact GELU, fc2's weight
  and bias zero at init so the branch starts as the identity, alpha 0.1;
- classification: the temporal mean of the raw embeddings -> Linear(P,
  P/2) -> ReLU -> Linear(P/2, classes).

The ``state_dict`` is the reference student's (``visual_encoder.*`` in the
OpenAI CLIP layout, ``residual_mlp.fc1/fc2``, ``classification_head.0/.2``),
so a reference ``student_best.pth`` loads with ``strict=True``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vimoclip_tpu_torch.models.towers import VisionConfig, preprocess, vision_tower


class ResidualMLP(nn.Module):
    """Two-layer GELU MLP with a zero-initialised output layer and a scaled
    residual skip."""

    def __init__(self, embed_dim: int, alpha: float = 0.1):
        super().__init__()
        self.alpha = alpha
        self.fc1 = nn.Linear(embed_dim, embed_dim)
        self.fc2 = nn.Linear(embed_dim, embed_dim)
        with torch.no_grad():
            self.fc2.weight.zero_()
            self.fc2.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.alpha * self.fc2(F.gelu(self.fc1(x), approximate="none"))


class StudentModel(nn.Module):
    """Motion-frame student (flow or frame difference: one architecture).
    Returns ``(embeddings, embeddings_for_distillation, logits)``."""

    def __init__(self, vision_config: VisionConfig, num_classes: int = 140,
                 alpha: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vision_config = vision_config
        self.dtype = dtype
        p = vision_config.embed_dim
        self.visual_encoder = vision_tower(vision_config, dtype=dtype)
        self.residual_mlp = ResidualMLP(p, alpha=alpha)
        self.classification_head = nn.Sequential(
            nn.Linear(p, p // 2), nn.ReLU(), nn.Linear(p // 2, num_classes))

    def forward(self, motion_frames: torch.Tensor, preprocessed: bool = False):
        """``motion_frames``: (B, T, H, W, 3) uint8, or with ``preprocessed``
        already normalised (B, T, S, S, 3) floats."""
        b, t = motion_frames.shape[:2]
        frames = motion_frames.reshape(b * t, *motion_frames.shape[2:])
        if not preprocessed:
            frames = preprocess(frames, self.vision_config, self.dtype)
        embeddings = self.visual_encoder(frames).reshape(b, t, -1).float()
        distill = self.residual_mlp(embeddings)
        logits = self.classification_head(embeddings.mean(dim=1))
        return embeddings, distill, logits
