"""The port's preprocessing against the JAX package's on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import ResizeMethod, _kernels, compute_weight_mat

from vimoclip_tpu.ops import preprocess as jp
from vimoclip_tpu_torch.ops import preprocess as tp

torch.set_num_threads(1)


@pytest.mark.parametrize("m, n", [(360, 224), (640, 398), (48, 32), (36, 32),
                                  (16, 32), (100, 37), (224, 224)])
def test_resize_weights_match_jax(m, n):
    ref = np.asarray(compute_weight_mat(m, n, n / m, 0.0,
                                        _kernels[ResizeMethod.CUBIC], True))
    np.testing.assert_allclose(tp.compute_weight_mat(m, n), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("h, w, size", [(36, 48, 32), (48, 36, 32), (32, 32, 32),
                                        (90, 160, 56)])
def test_crop_resize_windows_match_jax(h, w, size):
    for (a, a0, a1), (b, b0, b1) in zip(jp._crop_resize_weights(h, w, size),
                                        tp._crop_resize_weights(h, w, size)):
        assert (a0, a1) == (b0, b1)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape, size", [((4, 36, 48, 3), 32), ((3, 90, 160, 3), 56),
                                         ((2, 32, 32, 3), 32)])
def test_clip_preprocess_matches_jax(shape, size):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    ref = np.asarray(jp.clip_preprocess(jnp.asarray(x), size))
    got = tp.clip_preprocess(torch.from_numpy(x), size)
    assert got.dtype == torch.float32 and got.shape == (shape[0], size, size, 3)
    # normalised units (~[-2, 2]): float32 contractions in another order
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)
    ref16 = np.asarray(jp.clip_preprocess(jnp.asarray(x), size, dtype=jnp.bfloat16)
                       .astype(jnp.float32))
    got16 = tp.clip_preprocess(torch.from_numpy(x), size, dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    # bf16 operands and output: a few bf16 ulps at |x| ~ 2
    np.testing.assert_allclose(got16.float().numpy(), ref16, atol=3e-2, rtol=0)


def test_clip_preprocess_rejects_non_uint8():
    with pytest.raises(ValueError):
        tp.clip_preprocess(torch.zeros(1, 32, 32, 3), 32)


def test_normalize_matches_jax():
    x = np.random.default_rng(1).uniform(0, 255, (2, 5, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(tp.normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jp.normalize(jnp.asarray(x))), atol=1e-6)


def test_gray_and_frame_diff_match_jax_exactly():
    x = np.random.default_rng(2).integers(0, 256, (9, 60, 80, 3), dtype=np.uint8)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(tp.rgb_to_gray(t).numpy(),
                                  np.asarray(jp.rgb_to_gray(jnp.asarray(x))))
    np.testing.assert_array_equal(tp.frame_diff(t).numpy(),
                                  np.asarray(jp.frame_diff(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tp.frame_diff(t, replicate_channels=False).numpy(),
        np.asarray(jp.frame_diff(jnp.asarray(x), replicate_channels=False)))
