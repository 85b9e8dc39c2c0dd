"""Training objectives (the port's copy of ``vimoclip_tpu/losses.py``): the
stage-1 distillation loss and the classification losses of both stages.
Mean-reduced, float32 in, float32 out."""

from __future__ import annotations

import torch
import torch.nn.functional as F

# the reference's epsilon for a NaN-safe cosine (reference losses.py:24)
_COSINE_EPS = 1e-5


def distillation_loss(student: torch.Tensor, teacher: torch.Tensor,
                      mode: str = "mse") -> torch.Tensor:
    """Stage-1 distillation between (..., T, D) student and teacher
    embeddings: ``mse``, or ``cosine`` as the reference computes it (norms
    clamped to >= 1e-5, the cosine clamped to (-1 + 1e-5, 1 - 1e-5), loss =
    mean(1 - cos))."""
    if mode == "mse":
        return torch.mean(torch.square(student - teacher))
    if mode == "cosine":
        s_norm = torch.linalg.vector_norm(student, dim=-1).clamp(min=_COSINE_EPS)
        t_norm = torch.linalg.vector_norm(teacher, dim=-1).clamp(min=_COSINE_EPS)
        cos = torch.sum(student * teacher, dim=-1) / (s_norm * t_norm)
        cos = cos.clamp(-1.0 + _COSINE_EPS, 1.0 - _COSINE_EPS)
        return torch.mean(1.0 - cos)
    raise ValueError(f"Unsupported mode '{mode}'. Choose 'mse' or 'cosine'.")


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight: torch.Tensor | None = None) -> torch.Tensor:
    """-[pw * y * log sigmoid(x) + (1 - y) * log(1 - sigmoid(x))], mean over
    every element (``nn.BCEWithLogitsLoss``); ``pos_weight`` broadcasts."""
    targets = targets.to(logits.dtype)
    log_p = -F.softplus(-logits)
    log_not_p = -F.softplus(logits)
    pw = torch.ones_like(logits) if pos_weight is None else pos_weight
    return torch.mean(-(pw * targets * log_p + (1.0 - targets) * log_not_p))


def classification_loss(predictions: torch.Tensor, targets: torch.Tensor,
                        positive_weight: float | None = None) -> torch.Tensor:
    """Multi-label BCE with the reference's per-element pos_weight
    ``w * targets + 1``: each positive weighs w + 1 (QUIRKS #4)."""
    targets = targets.to(predictions.dtype)
    pos_weight = None if positive_weight is None else positive_weight * targets + 1.0
    return bce_with_logits(predictions, targets, pos_weight=pos_weight)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Single-label softmax cross entropy on one-hot (B, C) targets (their
    argmax, as the reference feeds ``nn.CrossEntropyLoss``) or (B,) class
    indices."""
    idx = targets.argmax(dim=-1) if targets.ndim == logits.ndim else targets
    log_probs = torch.log_softmax(logits, dim=-1)
    return torch.mean(-log_probs.gather(-1, idx.long()[..., None])[..., 0])
