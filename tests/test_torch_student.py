"""The port's MoCLIP student, distillation loss and student converters
against the JAX package on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimoclip_tpu import losses as jax_losses
from vimoclip_tpu.models.clip_vit import ClipVisionConfig as JConfig
from vimoclip_tpu.models.student import StudentModel as JStudent
from vimoclip_tpu.models.torch_compat import (
    student_params_from_checkpoint,
    student_params_to_torch,
)
from vimoclip_tpu_torch import losses
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig
from vimoclip_tpu_torch.models.convert import (
    student_state_from_checkpoint,
    student_state_from_jax,
    student_tower_state,
    to_tensors,
)
from vimoclip_tpu_torch.models.student import ResidualMLP, StudentModel

torch.set_num_threads(1)

GEOM = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=2,
            num_heads=2, intermediate_size=64, projection_dim=16)
C = 5


@pytest.fixture(scope="module")
def jax_params():
    model = JStudent(vision_config=JConfig(**GEOM), num_classes=C)
    params = model.init(jax.random.key(0), jnp.zeros((1, 2, 32, 32, 3), jnp.uint8))["params"]
    # a trained fc2 is not zero: give it values so the branch is exercised
    rng = np.random.default_rng(7)
    fc2 = params["residual_mlp"]["fc2"]
    fc2 = {k: jnp.asarray(0.1 * rng.standard_normal(v.shape), jnp.float32)
           for k, v in fc2.items()}
    return jax.tree.map(np.asarray, {**params, "residual_mlp": {
        **params["residual_mlp"], "fc2": fc2}})


def _port_student(params, **kw):
    cfg = ClipVisionConfig(**GEOM)
    model = StudentModel(cfg, num_classes=C, **kw)
    model.load_state_dict(to_tensors(student_state_from_jax(params, cfg)), strict=True)
    return model.eval()


@pytest.mark.parametrize("hw", [(32, 32), (36, 48)], ids=["no-resize", "resize"])
def test_student_forward_matches_jax(jax_params, hw):
    frames = np.random.default_rng(sum(hw)).integers(0, 256, (2, 3, *hw, 3), dtype=np.uint8)
    ref = JStudent(vision_config=JConfig(**GEOM), num_classes=C).apply(
        {"params": jax_params}, jnp.asarray(frames))
    with torch.no_grad():
        got = _port_student(jax_params)(torch.from_numpy(frames))
    for name, a, r in zip(("embeddings", "distill", "logits"), got, ref):
        assert a.dtype == torch.float32 and tuple(a.shape) == r.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5, rtol=0, err_msg=name)


def test_student_preprocessed_input_and_bf16(jax_params):
    from vimoclip_tpu_torch.ops.preprocess import clip_preprocess

    frames = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 3, 32, 32, 3), dtype=np.uint8))
    model = _port_student(jax_params)
    with torch.no_grad():
        raw = model(frames)
        pixels = clip_preprocess(frames.reshape(6, 32, 32, 3), 32).reshape(2, 3, 32, 32, 3)
        pre = model(pixels, preprocessed=True)
        half = _port_student(jax_params, dtype=torch.bfloat16)(frames)
    for a, b, h in zip(raw, pre, half):
        assert torch.equal(a, b)
        assert h.dtype == torch.float32  # cast before both branches
        assert (h - a).abs().max().item() < 0.1


def test_residual_mlp_is_identity_at_init():
    mlp = ResidualMLP(16)
    assert mlp.alpha == 0.1
    x = torch.randn(3, 4, 16)
    assert torch.equal(mlp(x), x)
    assert not mlp.fc2.weight.any() and not mlp.fc2.bias.any()


@pytest.mark.parametrize("mode", ["mse", "cosine"])
def test_distillation_loss_matches_jax(mode):
    rng = np.random.default_rng(1)
    s = rng.standard_normal((2, 5, 8)).astype(np.float32)
    t = rng.standard_normal((2, 5, 8)).astype(np.float32)
    s[0, 1] = 0.0  # a zero vector: the 1e-5 norm clamp
    t[1, 2] = 0.0
    t[1, 3] = 2.5 * s[1, 3]  # parallel: the 1 - 1e-5 clamp
    want = float(jax_losses.distillation_loss(jnp.asarray(s), jnp.asarray(t), mode))
    got = losses.distillation_loss(torch.from_numpy(s), torch.from_numpy(t), mode).item()
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    with pytest.raises(ValueError, match="mode"):
        losses.distillation_loss(torch.from_numpy(s), torch.from_numpy(t), "l1")


def test_student_state_from_jax_matches_torch_compat(jax_params):
    cfg = ClipVisionConfig(**GEOM)
    ours = student_state_from_jax(jax_params, cfg)
    theirs = student_params_to_torch(jax_params, JConfig(**GEOM))
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        assert ours[key].dtype == value.dtype, key
        np.testing.assert_array_equal(ours[key], value, err_msg=key)
    assert sorted(ours) == sorted(StudentModel(cfg, num_classes=C).state_dict())


@pytest.mark.parametrize("wrap", ["bare", "module-prefixed"])
def test_reference_checkpoint_loads_strictly_and_matches_jax(jax_params, tmp_path, wrap):
    """A reference ``student_best.pth`` (a bare state dict, or DataParallel's
    ``module.`` keys under ``state_dict``) loads strictly; the geometry is
    inferred from its shapes, as the JAX loader infers it."""
    cfg = ClipVisionConfig(**GEOM)
    state = to_tensors(student_state_from_jax(jax_params, cfg))
    path = str(tmp_path / "student_best.pth")
    torch.save(state if wrap == "bare" else
               {"state_dict": {f"module.{k}": v for k, v in state.items()}}, path)
    inferred, ours = student_state_from_checkpoint(path)
    jcfg, jparams = student_params_from_checkpoint(path)
    # heads are inferred as hidden // 64 (clamped to 1) by both loaders
    assert dataclasses.asdict(inferred) == dataclasses.asdict(cfg) | {"num_heads": 1}
    assert inferred.num_heads == jcfg.num_heads and inferred.hidden_size == jcfg.hidden_size
    theirs = student_params_to_torch(jparams, jcfg)
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key], value, err_msg=key)
    model = StudentModel(inferred, num_classes=C)
    model.load_state_dict(to_tensors(ours), strict=True)
    assert sorted(student_tower_state(ours)) == sorted(model.visual_encoder.state_dict())
    with pytest.raises(ValueError, match="visual_encoder"):
        torch.save({"fc.weight": torch.zeros(2, 2)}, tmp_path / "not_student.pth")
        student_state_from_checkpoint(str(tmp_path / "not_student.pth"))


def test_cosine_loss_gradient_at_a_zero_student_vector():
    """The reference's torch cosine (norm clamped at 1e-5) has a finite
    gradient at an all-zero student embedding, and so has the port's; JAX's
    ``jnp.linalg.norm`` gives NaN there (ROADMAP.md §C)."""
    rng = np.random.default_rng(0)
    s = rng.standard_normal((2, 3, 4)).astype(np.float32)
    t = rng.standard_normal((2, 3, 4)).astype(np.float32)
    s[0, 1] = 0.0
    jax_grad = jax.grad(lambda x: jax_losses.distillation_loss(x, jnp.asarray(t), "cosine"))(
        jnp.asarray(s))
    assert np.isnan(np.asarray(jax_grad)[0, 1]).all()
    st = torch.from_numpy(s).requires_grad_()
    losses.distillation_loss(st, torch.from_numpy(t), "cosine").backward()
    assert torch.isfinite(st.grad).all()
    # elsewhere the two gradients agree
    np.testing.assert_allclose(st.grad.numpy()[1], np.asarray(jax_grad)[1], rtol=1e-5, atol=1e-7)
