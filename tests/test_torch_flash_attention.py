"""The port's attention kernel wrapper on the CPU: its plain version
(``flash_attention_reference``) against the JAX Pallas kernel run in
interpret mode, and the JAX argument checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimoclip_tpu.ops.attention import dot_product_attention as jax_dpa
from vimoclip_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from vimoclip_tpu_torch.ops.attention import dot_product_attention
from vimoclip_tpu_torch.ops.kernels.flash_attention import (
    flash_attention,
    flash_attention_reference,
)

torch.set_num_threads(1)

# f32: same math, different summation order -> ~1e-7 relative; 1e-5 leaves
# room. bf16: p and the output are rounded to bf16 (rel. 2^-8) at points
# where the online (JAX) and one-pass (port) softmax hold different maxima.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(b, h, tq, tk, d, seed, masked_rows=()):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    mask = rng.random((b, tk)) < 0.3  # True = ignore
    for r in masked_rows:
        mask[r] = True
    return q, k, v, mask


CASES = [
    # (b, h, tq, tk, d, use_mask, fully masked rows)
    (2, 2, 64, 64, 16, False, ()),
    (2, 2, 130, 200, 16, True, ()),
    (2, 3, 130, 77, 32, True, (1,)),
    (1, 2, 40, 300, 16, True, (0,)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[:5])))
def test_reference_matches_jax_kernel(case, dtype):
    b, h, tq, tk, d, use_mask, rows = case
    q, k, v, mask = _inputs(b, h, tq, tk, d, seed=tq + tk, masked_rows=rows)
    mask = mask if use_mask else None
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jax_flash(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                    key_padding_mask=None if mask is None else jnp.asarray(mask),
                    interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    td = getattr(torch, dtype)
    tq_, tk_, tv_ = (torch.from_numpy(a).to(td) for a in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    got = flash_attention_reference(tq_, tk_, tv_, tmask)
    assert got.dtype == td and got.shape == (b, h, tq, d)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=TOL[dtype], rtol=0)
    # the wrapper on a CPU tensor is the plain version, and launches nothing
    before = flash_attention.launches
    out = flash_attention(tq_, tk_, tv_, key_padding_mask=tmask)
    assert torch.equal(out, got)
    assert flash_attention.launches == before


def test_fully_masked_row_is_uniform_over_real_keys():
    q, k, v, mask = _inputs(2, 2, 10, 12, 16, seed=3, masked_rows=(0,))
    out = flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                    torch.from_numpy(mask))
    np.testing.assert_allclose(out[0].numpy(),
                               np.broadcast_to(v[0].mean(axis=1, keepdims=True),
                                               out[0].shape), atol=1e-5)


def test_eager_path_matches_jax_and_reference():
    q, k, v, mask = _inputs(2, 2, 33, 45, 16, seed=5, masked_rows=(1,))
    tq_, tk_, tv_, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    got = dot_product_attention(tq_, tk_, tv_, tm).numpy()
    ref = np.asarray(jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             key_padding_mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        got, flash_attention_reference(tq_, tk_, tv_, tm).numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kwargs, exc", [
    (dict(dropout_rate=1.0), ValueError),
    (dict(dropout_rate=-0.1), ValueError),
    (dict(dropout_rate=0.1), ValueError),  # no seed
    (dict(dropout_rate=0.1, dropout_seed=3), NotImplementedError),
    (dict(key_padding_mask=torch.zeros(2, 7, dtype=torch.bool)), ValueError),
], ids=["rate1", "negative", "noseed", "dropout", "maskshape"])
def test_argument_errors(kwargs, exc):
    q, k, v, _ = _inputs(2, 2, 8, 9, 16, seed=0)
    with pytest.raises(exc):
        flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kwargs)


def test_shape_errors():
    q = torch.zeros(2, 2, 8, 16)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(2, 2, 9, 8), torch.zeros(2, 2, 9, 8))
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(2, 2, 9, 16), torch.zeros(2, 2, 10, 16))
