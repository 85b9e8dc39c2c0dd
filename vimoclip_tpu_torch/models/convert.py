"""Weights carried across: Flax param trees, HF CLIP and reference
checkpoints -> the port's ``state_dict`` layouts.

The port's modules keep the reference layouts, so most checkpoints load as
they are:

- ``ClipVisionEncoder``: OpenAI CLIP ``visual.*`` without the prefix (packed
  ``attn.in_proj_weight``, ``mlp.c_fc``/``c_proj``, raw ``proj`` applied as
  ``x @ proj``);
- ``TFAM``: reference AMO_CLIP (packed ``in_proj_weight``, ``ffn.0/3``,
  ``classifier.0/1/4``, ``projection_layer``);
- ``StudentModel``: the reference student (``visual_encoder.*`` as above,
  ``residual_mlp.fc1/fc2``, ``classification_head.0/.2``);
- ``SiglipVisionEncoder``: HF's ``vision_model.*`` without the prefix, the
  blocks' q/k/v packed (``siglip_vision_state_from_hf``).

The converters here are the port's own copies of the mappings in
``vimoclip_tpu/models/torch_compat.py`` and ``clip_convert.py`` (the tests
hold them against those key for key, bit for bit). Inputs and outputs are
``{key: numpy array}`` dicts; ``to_tensors`` turns one into a ``state_dict``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig
from vimoclip_tpu_torch.models.siglip_vit import SiglipVisionConfig


def strip_prefix(state: Mapping, prefix: str = "module.") -> dict:
    """Remove a key prefix (DataParallel's ``module.`` by default)."""
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in state.items()}


def to_numpy(state: Mapping) -> dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in state.items()}


def to_tensors(state: Mapping) -> dict[str, torch.Tensor]:
    # np.array copies: arrays handed over by JAX are read-only
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v)))
            for k, v in state.items()}


def _c(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x))


# ---------------------------------------------------------------------------
# Flax -> port
# ---------------------------------------------------------------------------


def clip_vision_state_from_jax(params: Mapping, config: ClipVisionConfig,
                               prefix: str = "visual.") -> dict:
    """Flax ``ClipVisionEncoder`` params (nested dicts of arrays) -> OpenAI
    visual state dict; with ``prefix=""`` the ``ClipVisionEncoder`` layout."""
    p = params
    out: dict[str, np.ndarray] = {}

    def put(key, value):
        out[prefix + key] = _c(value)

    put("class_embedding", p["class_embedding"])
    put("positional_embedding", p["position_embedding"])
    # flax conv kernel (kh, kw, C, E) -> torch conv weight (E, C, kh, kw)
    put("conv1.weight",
        np.transpose(np.asarray(p["patch_embedding"]["kernel"]), (3, 2, 0, 1)))
    put("ln_pre.weight", p["pre_layernorm"]["scale"])
    put("ln_pre.bias", p["pre_layernorm"]["bias"])
    put("ln_post.weight", p["post_layernorm"]["scale"])
    put("ln_post.bias", p["post_layernorm"]["bias"])
    put("proj", p["visual_projection"]["kernel"])  # already (E, P)
    for i in range(config.num_layers):
        layer = p[f"layers_{i}"]
        t = f"transformer.resblocks.{i}"
        attn = layer["attn"]
        put(f"{t}.attn.in_proj_weight", np.concatenate(
            [np.asarray(attn[n]["kernel"]).T
             for n in ("q_proj", "k_proj", "v_proj")], axis=0))
        put(f"{t}.attn.in_proj_bias", np.concatenate(
            [np.asarray(attn[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")]))
        put(f"{t}.attn.out_proj.weight", np.asarray(attn["out_proj"]["kernel"]).T)
        put(f"{t}.attn.out_proj.bias", attn["out_proj"]["bias"])
        put(f"{t}.ln_1.weight", layer["layer_norm1"]["scale"])
        put(f"{t}.ln_1.bias", layer["layer_norm1"]["bias"])
        put(f"{t}.ln_2.weight", layer["layer_norm2"]["scale"])
        put(f"{t}.ln_2.bias", layer["layer_norm2"]["bias"])
        put(f"{t}.mlp.c_fc.weight", np.asarray(layer["mlp_fc1"]["kernel"]).T)
        put(f"{t}.mlp.c_fc.bias", layer["mlp_fc1"]["bias"])
        put(f"{t}.mlp.c_proj.weight", np.asarray(layer["mlp_fc2"]["kernel"]).T)
        put(f"{t}.mlp.c_proj.bias", layer["mlp_fc2"]["bias"])
    return out


def student_state_from_jax(params: Mapping, vision_config: ClipVisionConfig) -> dict:
    """Flax ``StudentModel`` params -> the reference student state dict (the
    inverse of ``torch_compat.student_params_from_torch``)."""
    out = clip_vision_state_from_jax(params["visual_encoder"], vision_config,
                                     prefix="visual_encoder.")
    for flax_name, name in (("fc1", "residual_mlp.fc1"), ("fc2", "residual_mlp.fc2")):
        out[f"{name}.weight"] = _c(np.asarray(params["residual_mlp"][flax_name]["kernel"]).T)
        out[f"{name}.bias"] = _c(params["residual_mlp"][flax_name]["bias"])
    for flax_name, name in (("head_dense1", "classification_head.0"),
                            ("head_dense2", "classification_head.2")):
        out[f"{name}.weight"] = _c(np.asarray(params[flax_name]["kernel"]).T)
        out[f"{name}.bias"] = _c(params[flax_name]["bias"])
    return out


def tfam_state_from_jax(params: Mapping, num_layers: int) -> dict:
    """Flax ``TFAM`` params -> reference AMO_CLIP state dict. Like the
    reference, every layer carries ``cross_attn``/``norm_cross`` and the model
    ``projection_layer``; modules the fusion mode never created are filled
    with placeholders (LayerNorm ones/zeros, zero linears) that its forward
    never reads."""
    out: dict[str, np.ndarray] = {}

    def lin(fp, name):
        out[f"{name}.weight"] = _c(np.asarray(fp["kernel"]).T)
        out[f"{name}.bias"] = np.asarray(fp["bias"])

    def ln(fp, name):
        out[f"{name}.weight"] = np.asarray(fp["scale"])
        out[f"{name}.bias"] = np.asarray(fp["bias"])

    def mha(fp, name):
        qkv = ("q_proj", "k_proj", "v_proj")
        out[f"{name}.in_proj_weight"] = _c(np.concatenate(
            [np.asarray(fp[n]["kernel"]).T for n in qkv], axis=0))
        out[f"{name}.in_proj_bias"] = np.concatenate(
            [np.asarray(fp[n]["bias"]) for n in qkv])
        lin(fp["out_proj"], f"{name}.out_proj")

    for i in range(num_layers):
        layer, t = params[f"layers_{i}"], f"layers.{i}"
        mha(layer["self_attn"], f"{t}.self_attn")
        if "cross_attn" in layer:
            mha(layer["cross_attn"], f"{t}.cross_attn")
            ln(layer["norm_cross"], f"{t}.norm_cross")
        lin(layer["ffn_dense1"], f"{t}.ffn.0")
        lin(layer["ffn_dense2"], f"{t}.ffn.3")
        ln(layer["norm_self"], f"{t}.norm_self")
        ln(layer["norm_ffn"], f"{t}.norm_ffn")
    ln(params["classifier_norm"], "classifier.0")
    lin(params["classifier_dense1"], "classifier.1")
    lin(params["classifier_dense2"], "classifier.4")
    if "projection_layer" in params:
        lin(params["projection_layer"], "projection_layer")

    d = int(np.asarray(params["classifier_norm"]["scale"]).shape[0])

    def fill(key, shape, ones=False):
        if key not in out:
            out[key] = (np.ones if ones else np.zeros)(shape, np.float32)

    for i in range(num_layers):
        t = f"layers.{i}"
        fill(f"{t}.cross_attn.in_proj_weight", (3 * d, d))
        fill(f"{t}.cross_attn.in_proj_bias", (3 * d,))
        fill(f"{t}.cross_attn.out_proj.weight", (d, d))
        fill(f"{t}.cross_attn.out_proj.bias", (d,))
        fill(f"{t}.norm_cross.weight", (d,), ones=True)
        fill(f"{t}.norm_cross.bias", (d,))
    fill("projection_layer.weight", (d, 2 * d))
    fill("projection_layer.bias", (d,))
    return out


# ---------------------------------------------------------------------------
# HF transformers CLIP -> OpenAI visual layout
# ---------------------------------------------------------------------------


def openai_visual_state_from_hf(state: Mapping, config: ClipVisionConfig) -> dict:
    """HF ``CLIPModel`` / ``CLIPVisionModelWithProjection`` state dict (numpy
    values) -> the ``ClipVisionEncoder`` layout (OpenAI keys, no prefix)."""
    s = dict(state)
    if not any(k.startswith("vision_model.") for k in s):  # bare vision dump
        s = {(k if k.startswith("visual_projection") else f"vision_model.{k}"): v
             for k, v in s.items()}
    emb, enc = "vision_model.embeddings", "vision_model.encoder.layers"
    out = {
        "class_embedding": _c(s[f"{emb}.class_embedding"]),
        "positional_embedding": _c(s[f"{emb}.position_embedding.weight"]),
        "conv1.weight": _c(s[f"{emb}.patch_embedding.weight"]),
        "ln_pre.weight": _c(s["vision_model.pre_layrnorm.weight"]),  # HF typo
        "ln_pre.bias": _c(s["vision_model.pre_layrnorm.bias"]),
        "ln_post.weight": _c(s["vision_model.post_layernorm.weight"]),
        "ln_post.bias": _c(s["vision_model.post_layernorm.bias"]),
        # HF Linear weight (P, E); OpenAI applies x @ proj with proj (E, P)
        "proj": _c(np.asarray(s["visual_projection.weight"]).T),
    }
    for i in range(config.num_layers):
        h, t = f"{enc}.{i}", f"transformer.resblocks.{i}"
        qkv = [f"{h}.self_attn.{n}_proj" for n in "qkv"]
        out[f"{t}.attn.in_proj_weight"] = _c(np.concatenate(
            [np.asarray(s[f"{n}.weight"]) for n in qkv], axis=0))
        out[f"{t}.attn.in_proj_bias"] = _c(np.concatenate(
            [np.asarray(s[f"{n}.bias"]) for n in qkv]))
        for hf, oa in (("self_attn.out_proj", "attn.out_proj"),
                       ("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"),
                       ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj")):
            out[f"{t}.{oa}.weight"] = _c(s[f"{h}.{hf}.weight"])
            out[f"{t}.{oa}.bias"] = _c(s[f"{h}.{hf}.bias"])
    return out


def config_from_openai_state(state: Mapping, prefix: str = "visual.") -> ClipVisionConfig:
    """Infer a ClipVisionConfig from an OpenAI visual state dict's shapes
    (heads = hidden // 64, which holds for every released CLIP ViT)."""
    s = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    hidden, _, patch, _ = np.shape(s["conv1.weight"])
    n_pos = np.shape(s["positional_embedding"])[0]
    n_layers = 1 + max(int(k.split(".")[2]) for k in s
                       if k.startswith("transformer.resblocks."))
    return ClipVisionConfig(
        image_size=int(round((n_pos - 1) ** 0.5)) * patch, patch_size=patch,
        hidden_size=hidden, num_layers=n_layers, num_heads=max(1, hidden // 64),
        intermediate_size=np.shape(s["transformer.resblocks.0.mlp.c_fc.weight"])[0],
        projection_dim=np.shape(s["proj"])[1],
    )


def config_from_hf_state(state: Mapping) -> ClipVisionConfig:
    """Infer a ClipVisionConfig from an HF state dict's shapes."""
    s = dict(state)
    hidden, _, patch, _ = np.shape(s["vision_model.embeddings.patch_embedding.weight"])
    n_pos = np.shape(s["vision_model.embeddings.position_embedding.weight"])[0]
    n_layers = 1 + max(int(k.split(".")[3]) for k in s
                       if k.startswith("vision_model.encoder.layers."))
    return ClipVisionConfig(
        image_size=int(round((n_pos - 1) ** 0.5)) * patch, patch_size=patch,
        hidden_size=hidden, num_layers=n_layers, num_heads=max(1, hidden // 64),
        intermediate_size=np.shape(
            s["vision_model.encoder.layers.0.mlp.fc1.weight"])[0],
        projection_dim=np.shape(s["visual_projection.weight"])[0],
    )


# ---------------------------------------------------------------------------
# HF transformers SigLIP -> SiglipVisionEncoder
# ---------------------------------------------------------------------------

_SIGLIP_PATCH = "vision_model.embeddings.patch_embedding.weight"


def is_siglip_state(state: Mapping) -> bool:
    """An HF SigLIP state (``SiglipModel`` or ``SiglipVisionModel``): a
    patch embedding under ``vision_model.`` and no CLS token."""
    return _SIGLIP_PATCH in state and \
        "vision_model.embeddings.class_embedding" not in state


def _cat(parts):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return _c(np.concatenate([np.asarray(p) for p in parts]))


def siglip_vision_state_from_hf(state: Mapping) -> dict:
    """An HF ``SiglipModel`` / ``SiglipVisionModel`` state (``vision_model.*``
    keys; a text tower's keys are dropped), or the vision model's own keys
    without the prefix -> the ``SiglipVisionEncoder`` layout: the prefix
    gone, each block's ``q_proj``/``k_proj``/``v_proj`` packed into
    ``self_attn.in_proj_weight``/``in_proj_bias`` (rows q, k, v), the
    ``position_ids`` buffer dropped. A state already in that layout passes
    through. Values stay numpy arrays or tensors, as they came."""
    prefix = "vision_model."
    s = ({k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
         if any(k.startswith(prefix) for k in state) else dict(state))
    s.pop("embeddings.position_ids", None)
    out = {}
    for key, value in s.items():
        head, _, leaf = key.rpartition(".")
        if head.endswith(".self_attn.q_proj"):
            attn = head[: -len(".q_proj")]
            out[f"{attn}.in_proj_{leaf}"] = _cat(
                [s[f"{attn}.{n}_proj.{leaf}"] for n in "qkv"])
        elif not (head.endswith(".self_attn.k_proj") or head.endswith(".self_attn.v_proj")):
            out[key] = value
    return out


# what a SigLIP state's shapes do not give, for the published towers: the
# head count by width (B/16 768 -> 12, L/16 1024 -> 16, So400m/14 1152 ->
# 16), and the 384 px So400m/14's frame size, 6 pixels past its 27 patches
_SIGLIP_HEADS = {768: 12, 1024: 16, 1152: 16}
_SIGLIP_IMAGE = {(14, 27): 384}


def siglip_config_from_hf_state(state: Mapping, hf_vision_config: Mapping | None = None
                                ) -> SiglipVisionConfig:
    """A SiglipVisionConfig from an HF SigLIP state's shapes; the frame
    size, heads and the LayerNorm's eps from the checkpoint's
    ``vision_config`` (``config.json``) where given, else the published
    towers' (``_SIGLIP_IMAGE`` or whole patches; ``_SIGLIP_HEADS``; 1e-6).
    The tower's activation is GELU-tanh: another is refused."""
    s = dict(state)
    c = dict(hf_vision_config or {})
    if c.get("hidden_act", "gelu_pytorch_tanh") != "gelu_pytorch_tanh":
        raise ValueError(f"SigLIP tower with activation {c['hidden_act']!r}: the port's "
                         "tower runs gelu_pytorch_tanh")
    hidden, _, patch, _ = np.shape(s[_SIGLIP_PATCH])
    n_pos = np.shape(s["vision_model.embeddings.position_embedding.weight"])[0]
    n_layers = 1 + max(int(k.split(".")[3]) for k in s
                       if k.startswith("vision_model.encoder.layers."))
    grid = int(round(n_pos ** 0.5))
    image = c.get("image_size", _SIGLIP_IMAGE.get((int(patch), grid), grid * int(patch)))
    return SiglipVisionConfig(
        image_size=int(image), patch_size=int(patch),
        hidden_size=int(hidden), num_layers=n_layers,
        num_heads=int(c.get("num_attention_heads",
                            _SIGLIP_HEADS.get(int(hidden), max(1, hidden // 64)))),
        intermediate_size=int(np.shape(
            s["vision_model.encoder.layers.0.mlp.fc1.weight"])[0]),
        layer_norm_eps=float(c.get("layer_norm_eps", 1e-6)),
    )


# ---------------------------------------------------------------------------
# reference checkpoint files
# ---------------------------------------------------------------------------


def _load_state_file(path: str) -> dict[str, np.ndarray]:
    raw = torch.load(path, map_location="cpu", weights_only=False)
    state = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    return strip_prefix(to_numpy(state))


def tfam_state_from_checkpoint(path: str) -> dict[str, np.ndarray]:
    """A reference-format TFAM checkpoint (``best_model.pth``: a state dict,
    possibly under ``state_dict`` and DataParallel-prefixed) -> AMO_CLIP
    state dict for ``TFAM.load_state_dict``."""
    return _load_state_file(path)


def student_tower_state(state: Mapping) -> dict:
    """The CLIP tower of a student state dict (its ``visual_encoder.*``
    keys without the prefix); a bare tower passes through."""
    if any(k.startswith("visual_encoder.") for k in state):
        return strip_prefix({k: v for k, v in state.items()
                             if k.startswith("visual_encoder.")}, "visual_encoder.")
    return dict(state)


def student_state_from_checkpoint(
    path: str, vision_config: ClipVisionConfig | SiglipVisionConfig | None = None
) -> tuple[ClipVisionConfig | SiglipVisionConfig, dict[str, np.ndarray]]:
    """A reference stage-1 student checkpoint (``student_best.pth``: a state
    dict, possibly under ``state_dict`` and DataParallel-prefixed) -> the
    whole ``StudentModel`` state dict, plus the tower's config (inferred
    from the shapes unless given: a CLIP or a SigLIP tower)."""
    state = _load_state_file(path)
    if not any(k.startswith("visual_encoder.") for k in state):
        raise ValueError(f"{path}: no 'visual_encoder.*' keys (not a student checkpoint)")
    if vision_config is None:
        tower = {f"vision_model.{k[len('visual_encoder.'):]}": v for k, v in state.items()
                 if k.startswith("visual_encoder.")}
        vision_config = (siglip_config_from_hf_state(tower) if is_siglip_state(tower)
                         else config_from_openai_state(state, prefix="visual_encoder."))
    return vision_config, state


def student_visual_state_from_checkpoint(
    path: str, vision_config: ClipVisionConfig | SiglipVisionConfig | None = None
) -> tuple[ClipVisionConfig | SiglipVisionConfig, dict[str, np.ndarray]]:
    """A reference stage-1 student checkpoint (``student_best.pth``) -> its
    visual tower in its kind's layout (``models/towers.py``), plus the tower's
    config (inferred from the shapes unless given). The serving cascade
    feeds TFAM the tower's output; the residual MLP and classification head
    are not used there."""
    vision_config, state = student_state_from_checkpoint(path, vision_config)
    return vision_config, student_tower_state(state)
