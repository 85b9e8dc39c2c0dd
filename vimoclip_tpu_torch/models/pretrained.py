"""Loading CLIP visual weights from local files (the port's copy of
``vimoclip_tpu/models/pretrained.py``). Accepts:

- a safetensors file (HF ``model.safetensors`` or OpenAI ``visual.*`` keys),
- a torch ``pytorch_model.bin`` / ``.pt`` / ``.pth`` state dict,
- an HF model directory or a name already in the local ``transformers``
  cache (never fetched: ``local_files_only``),

and returns ``(ClipVisionConfig, state)`` with ``state`` in the
``ClipVisionEncoder`` layout (numpy values).
"""

from __future__ import annotations

import os

import numpy as np

from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig
from vimoclip_tpu_torch.models.convert import (
    config_from_hf_state,
    config_from_openai_state,
    openai_visual_state_from_hf,
    strip_prefix,
    to_numpy,
)


def load_clip_vision(source: str) -> tuple[ClipVisionConfig, dict[str, np.ndarray]]:
    """Load CLIP visual-tower weights from ``source`` (file, dir, cached name)."""
    if os.path.isfile(source) and source.endswith(".safetensors"):
        from safetensors.numpy import load_file

        state = load_file(source)
    elif os.path.isfile(source):
        import torch

        raw = torch.load(source, map_location="cpu", weights_only=False)
        if hasattr(raw, "state_dict"):
            raw = raw.state_dict()
        state = to_numpy(raw)
    else:
        from transformers import CLIPModel

        model = CLIPModel.from_pretrained(source, local_files_only=True)
        state = to_numpy(model.state_dict())

    if any(k.startswith("visual.") for k in state):  # OpenAI serialisation
        config = config_from_openai_state(state, prefix="visual.")
        visual = {k: v for k, v in state.items() if k.startswith("visual.")}
        return config, strip_prefix(visual, "visual.")
    config = config_from_hf_state(state)
    return config, openai_visual_state_from_hf(state, config)
