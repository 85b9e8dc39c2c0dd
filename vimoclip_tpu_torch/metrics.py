"""Evaluation metrics (the port's copy of ``vimoclip_tpu/metrics.py``).

- ``average_precision_np``: micro AP over flattened scores, thresholds at
  distinct scores (sklearn / torchmetrics tie handling).
- ``MultilabelAveragePrecision``: streaming micro AP, buffered on the host.
- ``DeviceMultilabelAveragePrecision``: the same accumulation on the device;
  only the scalar leaves it. Under score ties it uses the per-positive
  formula, as JAX's ``average_precision_jax`` does.
- ``TopKAccuracy``: streaming top-k accuracy (one-hot or index targets).
"""

from __future__ import annotations

import numpy as np
import torch


def average_precision_np(scores, targets) -> float:
    """Binary AP over flattened scores; 0.0 when there is no positive."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    targets = np.asarray(targets).ravel().astype(np.float64)
    total_pos = targets.sum()
    if total_pos == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    sorted_scores = scores[order]
    sorted_targets = targets[order]
    tps = np.cumsum(sorted_targets)
    fps = np.cumsum(1.0 - sorted_targets)
    threshold_idxs = np.r_[np.where(np.diff(sorted_scores))[0], scores.size - 1]
    precision = tps[threshold_idxs] / (tps[threshold_idxs] + fps[threshold_idxs])
    recall = tps[threshold_idxs] / total_pos
    recall_prev = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - recall_prev) * precision))


def average_precision_torch(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-positive micro AP on the device: (1/P) * sum over positives of
    precision at their rank; equal to the thresholded AP for distinct
    scores."""
    scores = scores.reshape(-1).float()
    targets = targets.reshape(-1).float()
    order = torch.argsort(-scores, stable=True)
    sorted_targets = targets[order]
    tps = torch.cumsum(sorted_targets, 0)
    ranks = torch.arange(1, scores.numel() + 1, device=scores.device, dtype=torch.float32)
    ap = torch.sum(tps / ranks * sorted_targets) / tps[-1].clamp_min(1.0)
    return torch.where(tps[-1] > 0, ap, torch.zeros_like(ap))


class MultilabelAveragePrecision:
    """Streaming micro multilabel AP (torchmetrics
    ``MultilabelAveragePrecision(num_labels=C, average="micro")``)."""

    def __init__(self, num_labels: int, average: str = "micro"):
        if average != "micro":
            raise NotImplementedError("only micro averaging is used by the reference")
        self.num_labels = num_labels
        self.reset()

    def reset(self) -> None:
        self._scores: list[np.ndarray] = []
        self._targets: list[np.ndarray] = []

    def update(self, logits, targets) -> None:
        logits = np.asarray(logits, dtype=np.float32)
        targets = np.asarray(targets)
        if logits.shape[-1] != self.num_labels:
            raise ValueError(f"expected {self.num_labels} labels, got {logits.shape[-1]}")
        self._scores.append(logits.reshape(-1, self.num_labels))
        self._targets.append(targets.reshape(-1, self.num_labels))

    def compute(self) -> float:
        if not self._scores:
            return 0.0
        return average_precision_np(np.concatenate(self._scores),
                                    np.concatenate(self._targets))


class DeviceMultilabelAveragePrecision:
    """Micro multilabel AP accumulated on the device: ``update`` keeps the
    tensors where they are, ``compute`` fetches one float. Updates past
    ``capacity`` rows raise instead of growing without limit."""

    device_resident = True

    def __init__(self, num_labels: int, average: str = "micro", capacity: int = 1_000_000):
        if average != "micro":
            raise NotImplementedError("only micro averaging is used by the reference")
        self.num_labels = num_labels
        self.capacity = capacity
        self.reset()

    def reset(self) -> None:
        self._scores: list[torch.Tensor] = []
        self._targets: list[torch.Tensor] = []
        self._rows = 0

    def update(self, logits: torch.Tensor, targets: torch.Tensor) -> None:
        if logits.shape[-1] != self.num_labels:
            raise ValueError(f"expected {self.num_labels} labels, got {logits.shape[-1]}")
        rows = logits.numel() // self.num_labels
        if self._rows + rows > self.capacity:
            raise RuntimeError(
                f"DeviceMultilabelAveragePrecision would exceed its {self.capacity}-row "
                "buffer; raise `capacity` or use MultilabelAveragePrecision")
        self._rows += rows
        self._scores.append(logits.detach().reshape(-1, self.num_labels))
        self._targets.append(targets.detach().reshape(-1, self.num_labels))

    def compute(self) -> float:
        if not self._scores:
            return 0.0
        return float(average_precision_torch(torch.cat(self._scores),
                                             torch.cat(self._targets)))


class TopKAccuracy:
    """Streaming top-k accuracy (reference ``Accuracy``, MammalNet)."""

    def __init__(self, top_k: int = 1):
        self.top_k = top_k
        self.reset()

    def reset(self) -> None:
        self._correct = 0
        self._total = 0

    def update(self, logits, targets) -> None:
        logits = np.asarray(logits)
        targets = np.asarray(targets)
        if targets.ndim == logits.ndim:  # one-hot -> indices
            targets = targets.argmax(axis=-1)
        topk = np.argsort(-logits, axis=-1)[..., : self.top_k]
        self._correct += int((topk == targets[..., None]).any(axis=-1).sum())
        self._total += int(targets.size)

    def compute(self) -> float:
        return self._correct / self._total if self._total else 0.0
