"""The layout step in front of the bf16 backward kernels (K2, K3, K4), on
the CPU: which views TMA can read in place (``tma_legal``), the padded copy
the wrapper hands the kernels otherwise (``tma_operand``), and that the
plain backward gives the same gradients on the copies, and the JAX
package's gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimoclip_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from vimoclip_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_backward_reference,
    flash_attention_reference,
    tma_legal,
    tma_operand,
)

torch.set_num_threads(1)


def _packed(b, t, h, d, offset, dtype=torch.bfloat16):
    """q, k, v split out of one packed projection (B, T, 3 * H * D), as
    MultiHeadAttention passes them, starting ``offset`` elements into it."""
    x = torch.randn(b, t, 3 * h * d + offset).to(dtype)[..., offset:]
    return [y.view(b, t, h, d).transpose(1, 2) for y in x.split(h * d, -1)]


def _offset_view(shape, offset, dtype=torch.bfloat16):
    n = int(np.prod(shape))
    return torch.randn(n + offset).to(dtype)[offset:].view(shape)


VIEWS = {
    "contiguous": (lambda: torch.randn(2, 2, 40, 64).bfloat16(), True),
    "offset 1 element": (lambda: _offset_view((2, 2, 40, 64), 1), False),
    "offset 16 bytes": (lambda: _offset_view((2, 2, 40, 64), 8), True),
    "packed heads": (lambda: _packed(2, 40, 4, 32, 0)[1], True),
    "packed heads, misaligned": (lambda: _packed(2, 40, 4, 32, 1)[0], False),
    "head dim 20": (lambda: torch.randn(1, 2, 30, 20).bfloat16(), False),
    "head dim 24": (lambda: torch.randn(1, 2, 30, 24).bfloat16(), True),
    "merged heads (dO)": (lambda: torch.randn(2, 40, 3, 64).bfloat16().transpose(1, 2), True),
    "heads broadcast": (lambda: torch.randn(2, 1, 40, 64).bfloat16().expand(2, 3, 40, 64), False),
    "row stride 72": (lambda: torch.randn(2, 2, 40, 72).bfloat16()[..., :64], True),
    "row stride 68": (lambda: torch.randn(2, 2, 40, 68).bfloat16()[..., :64], False),
    "float32 head dim 4": (lambda: torch.randn(1, 2, 30, 4), True),
}


@pytest.mark.parametrize("name", list(VIEWS))
def test_tma_legal_predicate(name):
    make, legal = VIEWS[name]
    assert tma_legal(make()) is legal


@pytest.mark.parametrize("name", list(VIEWS))
def test_copy_step_keeps_every_value(name):
    t = VIEWS[name][0]()
    out = tma_operand(t)
    assert tma_legal(out)
    assert out.shape == t.shape and out.dtype == t.dtype
    assert torch.equal(out, t)
    if tma_legal(t):
        assert out is t  # legal operands are read in place, never copied
    else:
        assert out.data_ptr() != t.data_ptr()


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("shape, offset", [
    # past 512 keys (K3 + K4)
    ((1, 2, 40, 520, 20), 0), ((2, 2, 33, 530, 32), 1), ((1, 1, 70, 515, 16), 3),
    # 512 keys or fewer (K2): ragged Tq, head dims 20 and 32
    ((1, 2, 40, 64, 20), 0), ((2, 2, 33, 300, 32), 1), ((1, 1, 70, 512, 20), 3),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else f"off{v}")
def test_plain_backward_on_copies_equals_original(shape, offset, rate):
    b, h, tq, tk, d = shape
    g = torch.Generator().manual_seed(tq + tk)
    q, k, v = (_offset_view((b, h, t, d), offset) for t in (tq, tk, tk))
    grad = torch.randn(b, tq, h, d, generator=g).bfloat16().transpose(1, 2)
    mask = torch.rand(b, tk, generator=g) < 0.3
    mask[0, : tk // 2] = True
    seeds = torch.arange(b * h, dtype=torch.int32).view(b, h) if rate else None
    out, lse = flash_attention_reference(q, k, v, mask, rate, seed=seeds, return_lse=True)
    ref = flash_attention_backward_reference(q, k, v, mask, out, lse, grad, rate, seed=seeds)
    copies = [tma_operand(t) for t in (q, k, v, grad)]
    assert not any(tma_legal(t) for t in (q, k, v))  # every operand is copied
    got = flash_attention_backward_reference(*copies[:3], mask, out, lse, copies[3], rate,
                                             seed=seeds)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


def test_plain_backward_on_copies_matches_jax_vjp():
    # past 512 keys (the K3/K4 regime); float32 rows of 6 elements (24
    # bytes), so every operand goes through the padded copy
    b, h, tq, tk, d = 1, 2, 24, 520, 6
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for t in (tq, tk, tk))
    g = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    mask = rng.random((b, tk)) < 0.3

    def jax_loss(q_, k_, v_):
        o = jax_flash(q_, k_, v_, key_padding_mask=jnp.asarray(mask), block_q=128,
                      block_k=128, interpret=True)
        return jnp.sum(o * g)

    jgrads = jax.grad(jax_loss, argnums=(0, 1, 2))(q, k, v)
    tq_, tk_, tv_, tg = (tma_operand(torch.from_numpy(x)) for x in (q, k, v, g))
    assert all(t.stride(2) == 8 for t in (tq_, tk_, tv_, tg))
    tmask = torch.from_numpy(mask)
    out, lse = flash_attention_reference(tq_, tk_, tv_, tmask, return_lse=True)
    grads = flash_attention_backward_reference(tq_, tk_, tv_, tmask, out, lse, tg)
    for a, r in zip(grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4)
