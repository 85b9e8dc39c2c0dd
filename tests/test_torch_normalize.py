"""Kernel K5 (fused uint8 -> CLIP normalisation): the port's plain version
against the JAX Pallas kernel in interpret mode, and ``clip_preprocess``'s
no-resize branch, which runs it, against JAX's ``clip_preprocess``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimoclip_tpu.ops import preprocess as jp
from vimoclip_tpu.ops.pallas import fused_normalize as jax_fused_normalize
from vimoclip_tpu_torch.ops import preprocess as tp
from vimoclip_tpu_torch.ops.kernels.normalize import (
    fused_normalize,
    fused_normalize_reference,
    normalize_constants,
)

torch.set_num_threads(1)

# one bf16 ulp relative to the value: 2^-7 of |x| bounds it
BF16_ULP = 2.0 ** -7


def _frames(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("shape", [(3, 16, 24, 3), (2, 3, 8, 16, 3), (5, 17, 23, 3),
                                   (3, 17, 31, 3), (1, 1, 1, 3)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k5_matches_jax_kernel(shape, dtype):
    x = _frames(shape, seed=len(shape) + shape[-2])
    ref = np.asarray(jax_fused_normalize(jnp.asarray(x), dtype=getattr(jnp, dtype),
                                         interpret=True).astype(jnp.float32))
    got = fused_normalize(torch.from_numpy(x), dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    if dtype == "float32":
        # the same two float32 roundings: bitwise is expected
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(got.float().numpy(), ref)


def test_constants_are_jax_float32_constants():
    sub, mul = normalize_constants()
    mean = jnp.asarray(tp.CLIP_MEAN, jnp.float32)
    std = jnp.asarray(tp.CLIP_STD, jnp.float32)
    np.testing.assert_array_equal(sub, np.asarray(mean * 255.0))
    np.testing.assert_array_equal(mul, np.asarray(1.0 / (std * 255.0)))


def test_refusals():
    bad = np.zeros((2, 4, 4, 4), np.uint8)
    with pytest.raises(ValueError, match="channel"):
        jax_fused_normalize(jnp.asarray(bad), interpret=True)
    with pytest.raises(ValueError, match="channel"):
        fused_normalize(torch.from_numpy(bad))
    with pytest.raises(TypeError):
        fused_normalize(torch.zeros(2, 4, 4, 3))
    with pytest.raises(TypeError):
        fused_normalize(torch.zeros(2, 4, 4, 3, dtype=torch.uint8), dtype=torch.float16)


def test_cpu_calls_launch_nothing():
    before = fused_normalize.launches
    x = torch.from_numpy(_frames((2, 5, 7, 3)))
    out = fused_normalize(x)
    assert fused_normalize.launches == before
    assert torch.equal(out, fused_normalize_reference(x))


def test_strided_view_is_read_as_its_values():
    base = torch.from_numpy(_frames((4 * 17 * 31 * 3 + 5,), seed=3))
    view = base[5:].view(4, 17, 31, 3)  # a storage offset of 5 bytes
    assert torch.equal(fused_normalize(view), fused_normalize(view.clone()))
    nhwc = torch.from_numpy(_frames((2, 3, 9, 11), seed=4)).permute(0, 2, 3, 1)[..., :3]
    assert torch.equal(fused_normalize(nhwc, dtype=torch.bfloat16),
                       fused_normalize(nhwc.contiguous(), dtype=torch.bfloat16))


@pytest.mark.parametrize("size", [224, 32])
def test_clip_preprocess_without_resize_matches_jax(size):
    x = _frames((2, size, size, 3), seed=size)
    ref = np.asarray(jp.clip_preprocess(jnp.asarray(x), size))
    got = tp.clip_preprocess(torch.from_numpy(x), size)
    # the no-resize branch is K5's function
    assert torch.equal(got, fused_normalize(torch.from_numpy(x)))
    # multiplication by 1/(255 std) against JAX's division by 255 std: one
    # float32 ulp at |x| < 2.2 (2.4e-7 measured)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-7, rtol=0)
    ref16 = np.asarray(jp.clip_preprocess(jnp.asarray(x), size, dtype=jnp.bfloat16)
                       .astype(jnp.float32))
    got16 = tp.clip_preprocess(torch.from_numpy(x), size, dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    assert (np.abs(got16.float().numpy() - ref16) <= BF16_ULP * np.abs(ref16)).all()
