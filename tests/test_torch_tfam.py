"""The port's TFAM (inference) and its converter against the JAX package:
the four fusion modes x use_pe x masked_pooling, JAX on the flash path
(Pallas interpret mode on the CPU)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from vimoclip_tpu.config import TFAMModelConfig as JConfig
from vimoclip_tpu.models.tfam import TFAM as JTFAM
from vimoclip_tpu.models.tfam import sinusoidal_positional_encoding as jax_pe
from vimoclip_tpu.models.torch_compat import tfam_params_to_torch
from vimoclip_tpu_torch.config import TFAMModelConfig
from vimoclip_tpu_torch.models.convert import tfam_state_from_jax, to_tensors
from vimoclip_tpu_torch.models.tfam import TFAM, sinusoidal_positional_encoding

torch.set_num_threads(1)

MODES = {
    "cross": dict(use_cross_attention=True),
    "rgb": dict(use_only_rgb=True),
    "flow": dict(use_only_flow=True),
    "concat_time": dict(use_cross_attention=False, concat_dim=1),
    "concat_chan": dict(use_cross_attention=False, concat_dim=-1),
}
C = 7


def _base(mode, use_pe, masked_pooling):
    return dict(d_model=16, nhead=2, num_layers=2, dim_feedforward=32,
                dropout=0.1, mlp_dropout=0.1, attention_impl="flash",
                use_pe=use_pe, masked_pooling=masked_pooling, **MODES[mode])


def _inputs(seed):
    rng = np.random.default_rng(seed)
    rgb = rng.standard_normal((3, 12, 16)).astype(np.float32)
    mot = rng.standard_normal((3, 11, 16)).astype(np.float32)
    # bucket padding beyond the batch max (10 / 9) exercises pool_limits
    mask_r = np.arange(12)[None] < np.array([7, 10, 5])[:, None]
    mask_m = np.arange(11)[None] < np.array([6, 9, 4])[:, None]
    return rgb, mot, mask_r, mask_m


@pytest.mark.parametrize("masked_pooling", [False, True], ids=["refpool", "maskpool"])
@pytest.mark.parametrize("use_pe", [False, True], ids=["nope", "pe"])
@pytest.mark.parametrize("mode", list(MODES))
def test_tfam_matches_jax(mode, use_pe, masked_pooling):
    base = _base(mode, use_pe, masked_pooling)
    jt = JTFAM(config=JConfig(**base), num_classes=C)
    args = _inputs(seed=len(mode))
    params = jt.init(jax.random.key(1), *args)["params"]
    ref = np.asarray(jt.apply({"params": params}, *args))
    for impl in ("flash", "xla"):
        cfg = TFAMModelConfig(**(base | {"attention_impl": impl}))
        model = TFAM(cfg, num_classes=C)
        model.load_state_dict(to_tensors(tfam_state_from_jax(params, 2)), strict=True)
        with torch.no_grad():
            got = model.eval()(*(torch.from_numpy(a) for a in args))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["cross", "concat_chan", "rgb"])
def test_state_from_jax_equals_jax_converter(mode):
    jt = JTFAM(config=JConfig(**_base(mode, False, False)), num_classes=C)
    params = jt.init(jax.random.key(2), *_inputs(0))["params"]
    ours = tfam_state_from_jax(params, 2)
    theirs = tfam_params_to_torch(params, 2, fill_missing_reference_modules=True)
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert ours[key].dtype == theirs[key].dtype
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


def test_positional_encoding_matches_jax():
    np.testing.assert_allclose(sinusoidal_positional_encoding(50, 16).numpy(),
                               np.asarray(jax_pe(50, 16)), atol=1e-6)


def test_bf16_trunk_close_to_f32():
    base = _base("cross", False, True)
    jt = JTFAM(config=JConfig(**base), num_classes=C)
    args = _inputs(3)
    params = jt.init(jax.random.key(3), *args)["params"]
    state = to_tensors(tfam_state_from_jax(params, 2))
    outs = []
    for dtype in (torch.float32, torch.bfloat16):
        model = TFAM(TFAMModelConfig(**base), num_classes=C, dtype=dtype)
        model.load_state_dict(state)
        with torch.no_grad():
            outs.append(model.eval()(*(torch.from_numpy(a) for a in args)))
    assert outs[1].dtype == torch.float32  # the head runs in float32
    assert (outs[0] - outs[1]).abs().max().item() < 5e-2


def test_training_and_ring_refused():
    cfg = TFAMModelConfig(**_base("cross", False, False))
    model = TFAM(cfg, num_classes=C)  # a fresh module is in train() mode
    args = [torch.from_numpy(a) for a in _inputs(0)]
    # train mode with dropout runs given a generator, and raises without one
    with pytest.raises(ValueError, match="generator"):
        model(*args)
    gen = lambda: torch.Generator().manual_seed(5)
    out = model(*args, generator=gen())
    assert out.shape == (3, C) and torch.isfinite(out).all()
    assert torch.equal(out, model(*args, generator=gen()))  # same stream, same masks
    with torch.no_grad():
        assert not torch.equal(out, model.eval()(*args))
    # ring attention builds since slice 7b, and without a seq group (a mesh
    # with a "seq" axis) it raises, as JAX's "needs seq_mesh"
    ring = TFAM(dataclasses.replace(cfg, attention_impl="ring"), num_classes=C).eval()
    with pytest.raises(ValueError, match="needs a seq group"):
        ring(*args)
    # dropout 0 in train mode is the same function as eval: allowed
    quiet = TFAM(dataclasses.replace(cfg, dropout=0.0, mlp_dropout=0.0), num_classes=C)
    assert quiet(*(torch.from_numpy(a) for a in _inputs(0))).shape == (3, C)


@pytest.mark.parametrize("head_dim", [64, 128, 256, 512])
@pytest.mark.parametrize("is_cuda", [False, True], ids=["cpu", "cuda"])
@pytest.mark.parametrize("dropping", [False, True], ids=["nodrop", "drop"])
def test_auto_follows_the_measured_crossover_at_every_head_dim(head_dim, is_cuda, dropping):
    """``auto`` follows the crossovers measured on the card for each head
    dim and dtype: up to 128 the kernels whenever dropout is active, and
    without it from ``AUTO_FLASH_MIN_T_NODROP`` keys; above 128 (the wide
    kernels) the kernels at every length in bf16 and with dropout, and in
    float32 without dropout (an eval step, K1 alone, slower than eager
    attention on long keys) below ``AUTO_WIDE_FLASH_MAX_T_NODROP`` keys. On
    the CPU it runs eager attention."""
    from vimoclip_tpu_torch.ops.attention import (
        AUTO_FLASH_MIN_T_NODROP,
        AUTO_WIDE_FLASH_MAX_T_NODROP,
        _auto_impl,
    )

    for dtype in (torch.float32, torch.bfloat16):
        cut = AUTO_WIDE_FLASH_MAX_T_NODROP if head_dim > 128 else AUTO_FLASH_MIN_T_NODROP
        for tk in (16, cut - 1, cut, 4096):
            if head_dim > 128:
                kernels = is_cuda and (dtype == torch.bfloat16 or dropping or tk < cut)
            else:
                kernels = is_cuda and (dropping or tk >= cut)
            want = "flash" if kernels else "xla"
            assert _auto_impl(is_cuda, dropping, tk, head_dim, dtype) == want, (dtype, tk)


def _wide_tfam(impl: str, heads: int):
    base = dict(d_model=512, nhead=heads, num_layers=2, dim_feedforward=1024, dropout=0.1,
                mlp_dropout=0.1, use_cross_attention=True, attention_impl=impl)
    rng = np.random.default_rng(11)
    args = (rng.standard_normal((2, 10, 512)).astype(np.float32),
            rng.standard_normal((2, 9, 512)).astype(np.float32),
            np.arange(10)[None] < np.array([10, 6])[:, None],
            np.arange(9)[None] < np.array([9, 5])[:, None])
    jt = JTFAM(config=JConfig(**base), num_classes=C)
    params = jt.init(jax.random.key(4), *args)["params"]
    ref = np.asarray(jt.apply({"params": params}, *args))
    model = TFAM(TFAMModelConfig(**base), num_classes=C)
    model.load_state_dict(to_tensors(tfam_state_from_jax(params, 2)), strict=True)
    with torch.no_grad():
        got = model.eval()(*(torch.from_numpy(a) for a in args))
    return got.numpy(), ref


def test_head_dim_256_under_auto_matches_jax():
    """A 2-head d512 TFAM (head dim 256) under ``auto`` equals JAX's TFAM
    in eval mode (the plain versions run on the CPU)."""
    got, ref = _wide_tfam("auto", 2)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("heads", [2, 1])
def test_wide_head_dims_on_flash_match_jax(heads):
    """A d512 TFAM at 2 and 1 heads (head dims 256 and 512, the wide
    kernels' on the card) on ``flash`` in eval mode against JAX's TFAM on
    its Pallas kernels (interpret mode)."""
    got, ref = _wide_tfam("flash", heads)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
