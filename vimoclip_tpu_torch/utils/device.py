"""Device selection: ``cuda`` unless the caller asks for the CPU, never a
silent fall back from one to the other."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when a CUDA device is asked
    for and no card is present (the port's entry points never carry on on
    the CPU in place of the card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev
