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


def describe_card(device: str | torch.device = "cuda") -> str:
    """What a measurement runs on: ``nvidia-smi``'s name and power limit of
    the card ``device`` names (``NVIDIA H100 80GB HBM3, 700.00 W``; the
    current card when it names no index), or ``cpu``. The index is read as
    ``nvidia-smi``'s, which is torch's unless ``CUDA_VISIBLE_DEVICES``
    reorders the cards."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    import subprocess

    index = torch.cuda.current_device() if dev.index is None else dev.index
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
