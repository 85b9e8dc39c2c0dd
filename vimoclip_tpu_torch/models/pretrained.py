"""Loading vision-tower weights from local files (the port's copy of
``vimoclip_tpu/models/pretrained.py``, which reads CLIP only). Accepts:

- a safetensors file (HF ``model.safetensors`` or OpenAI ``visual.*`` keys),
- a torch ``pytorch_model.bin`` / ``.pt`` / ``.pth`` state dict,
- an HF model directory or a name already in the local ``transformers``
  cache (never fetched: ``local_files_only``),

holding CLIP (OpenAI or HF) or HF SigLIP weights (``SiglipModel`` or
``SiglipVisionModel``: ``vision_model.*`` keys, a patch embedding and no CLS
token). Returns ``(config, state)``: a ``ClipVisionConfig`` and the
``ClipVisionEncoder`` layout, or a ``SiglipVisionConfig`` and the
``SiglipVisionEncoder`` layout (numpy values); ``models/towers.py`` builds
the tower either names. A SigLIP config reads the ``vision_config`` of a
``config.json`` beside the weights (what ``save_pretrained`` writes) for
what the shapes do not give.
"""

from __future__ import annotations

import json
import os

import numpy as np

from vimoclip_tpu_torch.models.convert import (
    config_from_hf_state,
    config_from_openai_state,
    is_siglip_state,
    openai_visual_state_from_hf,
    siglip_config_from_hf_state,
    siglip_vision_state_from_hf,
    strip_prefix,
    to_numpy,
)


def _hf_config(folder: str) -> dict:
    """``<folder>/config.json``, or ``{}``."""
    path = os.path.join(folder, "config.json")
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _hf_vision_config(folder: str) -> dict:
    """The ``vision_config`` of ``<folder>/config.json`` (the whole file for
    a vision model's own config)."""
    config = _hf_config(folder)
    return config.get("vision_config", config)


def _is_siglip_folder(source: str) -> bool:
    return os.path.isdir(source) and \
        str(_hf_config(source).get("model_type", "")).startswith("siglip")


def load_clip_vision(source: str) -> tuple[object, dict[str, np.ndarray]]:
    """Load CLIP or SigLIP visual-tower weights from ``source`` (file, dir,
    cached name)."""
    folder = os.path.dirname(source) if os.path.isfile(source) else source
    if os.path.isfile(source) and source.endswith(".safetensors"):
        from safetensors.numpy import load_file

        state = load_file(source)
    elif os.path.isfile(source):
        import torch

        raw = torch.load(source, map_location="cpu", weights_only=False)
        if hasattr(raw, "state_dict"):
            raw = raw.state_dict()
        state = to_numpy(raw)
    elif _is_siglip_folder(source):
        from transformers import SiglipVisionModel

        model = SiglipVisionModel.from_pretrained(source, local_files_only=True)
        state = to_numpy(model.state_dict())
    else:
        from transformers import CLIPModel

        model = CLIPModel.from_pretrained(source, local_files_only=True)
        state = to_numpy(model.state_dict())

    if is_siglip_state(state):
        config = siglip_config_from_hf_state(state, _hf_vision_config(folder))
        return config, siglip_vision_state_from_hf(state)
    if any(k.startswith("visual.") for k in state):  # OpenAI serialisation
        config = config_from_openai_state(state, prefix="visual.")
        visual = {k: v for k, v in state.items() if k.startswith("visual.")}
        return config, strip_prefix(visual, "visual.")
    config = config_from_hf_state(state)
    return config, openai_visual_state_from_hf(state, config)
