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
    with pytest.raises(NotImplementedError, match="training slice"):
        model(*(torch.from_numpy(a) for a in _inputs(0)))
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        TFAM(dataclasses.replace(cfg, attention_impl="ring"), num_classes=C)
    # dropout 0 in train mode is the same function as eval: allowed
    quiet = TFAM(dataclasses.replace(cfg, dropout=0.0, mlp_dropout=0.0), num_classes=C)
    assert quiet(*(torch.from_numpy(a) for a in _inputs(0))).shape == (3, C)
