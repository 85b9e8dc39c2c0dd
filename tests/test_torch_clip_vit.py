"""The port's CLIP ViT and its weight converters against the JAX package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimoclip_tpu.models import clip_convert as jcc
from vimoclip_tpu.models.clip_vit import ClipVisionConfig as JConfig
from vimoclip_tpu.models.clip_vit import ClipVisionEncoder as JEncoder
from vimoclip_tpu.models.pretrained import load_clip_vision as jax_load_clip_vision
from vimoclip_tpu_torch.models import convert
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
from vimoclip_tpu_torch.models.pretrained import load_clip_vision

torch.set_num_threads(1)

GEOM = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=2,
            num_heads=2, intermediate_size=64, projection_dim=16)


@pytest.fixture(scope="module")
def jax_params():
    return JEncoder(JConfig(**GEOM)).init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]


def _jax_fields(jcfg) -> dict:
    """JAX's config without ``head_proj``, which only rescheduled XLA's
    transposes: the port runs one attention layout and has no such field."""
    fields = dataclasses.asdict(jcfg)
    del fields["head_proj"]
    return fields


def _port_encoder(params, cfg):
    enc = ClipVisionEncoder(cfg)
    enc.load_state_dict(convert.to_tensors(
        convert.clip_vision_state_from_jax(params, cfg, prefix="")), strict=True)
    return enc.eval()


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_encoder_matches_jax(jax_params, impl, act):
    jcfg = JConfig(**GEOM, attention_impl="flash", hidden_act=act)
    pixels = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(np.float32)
    ref, ref_hidden = JEncoder(jcfg).apply({"params": jax_params}, pixels,
                                           return_hidden=True)
    enc = _port_encoder(jax_params, ClipVisionConfig(**GEOM, attention_impl=impl,
                                                     hidden_act=act))
    with torch.no_grad():
        got, hidden = enc(torch.from_numpy(pixels), return_hidden=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(ref_hidden), atol=1e-4, rtol=0)


def test_bf16_encoder_close_to_f32(jax_params):
    pixels = torch.from_numpy(
        np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32))
    cfg = ClipVisionConfig(**GEOM)
    f32 = _port_encoder(jax_params, cfg)
    bf16 = ClipVisionEncoder(cfg, dtype=torch.bfloat16)
    bf16.load_state_dict(f32.state_dict())
    with torch.no_grad():
        a, b = f32(pixels), bf16.eval()(pixels)
    assert b.dtype == torch.bfloat16
    assert (a - b.float()).abs().max().item() < 5e-2


def test_state_from_jax_equals_jax_converter(jax_params):
    cfg = JConfig(**GEOM)
    ours = convert.clip_vision_state_from_jax(jax_params, ClipVisionConfig(**GEOM))
    theirs = jcc.clip_vision_params_to_openai(jax_params, cfg)
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert ours[key].dtype == theirs[key].dtype
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


def _hf_state(rng):
    e, i, p, n = GEOM["hidden_size"], GEOM["intermediate_size"], GEOM["patch_size"], 17
    s = {
        "vision_model.embeddings.class_embedding": (e,),
        "vision_model.embeddings.position_embedding.weight": (n, e),
        "vision_model.embeddings.patch_embedding.weight": (e, 3, p, p),
        "vision_model.pre_layrnorm.weight": (e,), "vision_model.pre_layrnorm.bias": (e,),
        "vision_model.post_layernorm.weight": (e,),
        "vision_model.post_layernorm.bias": (e,),
        "visual_projection.weight": (GEOM["projection_dim"], e),
    }
    for li in range(GEOM["num_layers"]):
        t = f"vision_model.encoder.layers.{li}"
        for name in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                     "self_attn.out_proj"):
            s[f"{t}.{name}.weight"], s[f"{t}.{name}.bias"] = (e, e), (e,)
        for name in ("layer_norm1", "layer_norm2"):
            s[f"{t}.{name}.weight"], s[f"{t}.{name}.bias"] = (e,), (e,)
        s[f"{t}.mlp.fc1.weight"], s[f"{t}.mlp.fc1.bias"] = (i, e), (i,)
        s[f"{t}.mlp.fc2.weight"], s[f"{t}.mlp.fc2.bias"] = (e, i), (e,)
    return {k: rng.standard_normal(shape).astype(np.float32) for k, shape in s.items()}


def test_hf_conversion_equals_jax_chain():
    state = _hf_state(np.random.default_rng(3))
    cfg = convert.config_from_hf_state(state)
    jcfg = jcc.config_from_hf_state(state)
    assert dataclasses.asdict(cfg) == _jax_fields(jcfg)
    ours = convert.openai_visual_state_from_hf(state, cfg)
    theirs = jcc.clip_vision_params_to_openai(
        jcc.clip_vision_params_from_hf(state, jcfg), jcfg, prefix="")
    assert ours.keys() == theirs.keys()
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    openai = {f"visual.{k}": v for k, v in ours.items()}
    assert (dataclasses.asdict(convert.config_from_openai_state(openai))
            == _jax_fields(jcc.config_from_openai_state(openai)))


@pytest.mark.parametrize("fmt", ["safetensors", "pth_openai"])
def test_load_clip_vision_matches_jax_loader(tmp_path, fmt):
    state = _hf_state(np.random.default_rng(4))
    if fmt == "safetensors":
        from safetensors.numpy import save_file

        path = str(tmp_path / "model.safetensors")
        save_file(state, path)
    else:
        cfg = convert.config_from_hf_state(state)
        visual = convert.openai_visual_state_from_hf(state, cfg)
        path = str(tmp_path / "clip.pth")
        torch.save({f"visual.{k}": torch.from_numpy(v) for k, v in visual.items()}, path)
    cfg, ours = load_clip_vision(path)
    jcfg, jparams = jax_load_clip_vision(path)
    # the JAX loader's OpenAI branch takes heads = hidden // 64 unclamped
    # (0 at this test width); the port clamps to >= 1 like its HF branch
    assert (dataclasses.asdict(cfg) | {"num_heads": 0}
            == _jax_fields(jcfg) | {"num_heads": 0})
    theirs = jcc.clip_vision_params_to_openai(jparams, jcfg, prefix="")
    assert ours.keys() == theirs.keys()
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    ClipVisionEncoder(cfg).load_state_dict(convert.to_tensors(ours), strict=True)


def test_seeded_init_is_reproducible():
    from vimoclip_tpu_torch.models import init_parameters_

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return init_parameters_(ClipVisionEncoder(ClipVisionConfig(**GEOM)), g).state_dict()

    a, b, c = draw(0), draw(0), draw(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["proj"], c["proj"])
    assert torch.equal(a["ln_pre.weight"], torch.ones(GEOM["hidden_size"]))
    assert torch.equal(a["ln_pre.bias"], torch.zeros(GEOM["hidden_size"]))
    assert abs(a["proj"].std().item() - 0.02) < 0.005


@pytest.mark.parametrize("approx", [dict(matmul_quant="int8"), dict(token_merge_r=2)],
                         ids=["int8", "tome"])
def test_opt_in_accelerators_match_jax(jax_params, approx):
    """The opt-in approximations build from the config and load the exact
    tower's weights: both within 1e-4 of JAX's tower with the same option
    (ops/quant.py and ops/tome.py have their own tests)."""
    pixels = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref = jax.jit(lambda p, x: JEncoder(JConfig(**GEOM, **approx)).apply({"params": p}, x))(
        jax_params, pixels)
    enc = _port_encoder(jax_params, ClipVisionConfig(**GEOM, **approx))
    with torch.no_grad():
        got = enc(torch.from_numpy(pixels))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
