"""The port's attention kernel wrappers on the CPU: their plain versions
(forward, lse variant, backward, Philox keep mask) against the JAX Pallas
kernels run in interpret mode and ``jax.vjp``, and the JAX argument
checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimoclip_tpu.ops.attention import dot_product_attention as jax_dpa
from vimoclip_tpu.ops.pallas.flash_attention import _expand_seed as jax_expand_seed
from vimoclip_tpu.ops.pallas.flash_attention import _keep_threshold as jax_keep_threshold
from vimoclip_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from vimoclip_tpu_torch.ops.kernels import flash_attention as fa
from vimoclip_tpu_torch.ops.attention import dot_product_attention
from vimoclip_tpu_torch.ops.kernels.flash_attention import (
    expand_seed,
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
    # head dims above 128: the port's wide kernels on the card
    (2, 2, 70, 90, 192, True, (1,)),
    (1, 2, 40, 100, 256, True, ()),
    (2, 1, 33, 70, 512, True, (0,)),
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
    before = dict(flash_attention.launches)
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
    (dict(dropout_rate=0.1, dropout_seed=3), None),  # runs on the CPU
    (dict(key_padding_mask=torch.zeros(2, 7, dtype=torch.bool)), ValueError),
], ids=["rate1", "negative", "noseed", "dropout", "maskshape"])
def test_argument_errors(kwargs, exc):
    q, k, v, _ = _inputs(2, 2, 8, 9, 16, seed=0)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    if exc is None:  # dropout with a seed: the plain K1' on its Philox mask
        out = flash_attention(*args, **kwargs)
        seed = expand_seed(kwargs["dropout_seed"], 2, 2)
        ref = flash_attention_reference(*args, dropout_rate=0.1, seed=seed)
        assert torch.equal(out, ref)
        return
    with pytest.raises(exc):
        flash_attention(*args, **kwargs)


def test_shape_errors():
    q = torch.zeros(2, 2, 8, 16)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(2, 2, 9, 8), torch.zeros(2, 2, 9, 8))
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(2, 2, 9, 16), torch.zeros(2, 2, 10, 16))


# ---------------------------------------------------------------------------
# the training variant: Philox bits, lse, the backward, the autograd Function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("words, expected", [
    # Random123's known answers for Philox4x32-10: (counter, key) -> output
    ((0, 0, 0, 0, 0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 6, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344, 0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answers(words, expected):
    assert tuple(int(w) for w in fa.philox4x32(*words)) == expected


@pytest.mark.parametrize("seed", [0, 7, -3, 2**31 - 1, [5, -9], [[1, 2, 3], [-4, 2**30, 0]]],
                         ids=["0", "7", "neg", "max", "rows", "full"])
def test_expand_seed_matches_jax(seed):
    seed = np.asarray(seed, np.int32)
    want = np.asarray(jax_expand_seed(jnp.asarray(seed), 2, 3))
    got = fa.expand_seed(torch.from_numpy(seed), 2, 3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        fa.expand_seed(torch.zeros(4, dtype=torch.int32), 2, 3)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 0.999, 1e-12])
def test_keep_threshold_matches_jax(rate):
    assert fa.keep_threshold(rate) == jax_keep_threshold(rate)


def test_keep_mask_is_per_row_and_head():
    """The bits are keyed on each (row, head)'s own seed and the global
    (query, key) coordinates: any slice of batch, heads or keys sees the same
    mask, and the kept fraction is 1 - p."""
    seeds = fa.expand_seed(11, 3, 4)
    keep = fa.dropout_keep_mask(seeds, 50, 70, 0.25)
    assert keep.shape == (3, 4, 50, 70)
    assert torch.equal(fa.dropout_keep_mask(seeds[1:, 2:], 50, 70, 0.25), keep[1:, 2:])
    assert torch.equal(fa.dropout_keep_mask(seeds, 50, 33, 0.25), keep[..., :33])
    n = keep.numel()
    assert abs(keep.float().mean().item() - 0.75) <= 5 * (0.75 * 0.25 / n) ** 0.5


def test_lse_matches_numpy_logsumexp():
    q, k, v, mask = _inputs(2, 2, 30, 41, 16, seed=4)
    _, lse = flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                       torch.from_numpy(mask), return_lse=True)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64) / 4.0, k) + np.where(
        mask[:, None, None, :], -1e9, 0.0)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)


# Gradients relative to the largest |gradient| of their batch row (a fully
# masked row makes P = 1 for each of its keys, so its gradients dwarf the
# rest). f32: summation
# order. bf16: P and dS round to bf16 at each product (2^-8) after float32
# scores that differ in their last bits between the two packages.
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    diff = np.abs(a - b).reshape(len(b), -1).max(1)
    return (diff / np.maximum(1.0, np.abs(b).reshape(len(b), -1).max(1))).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape, block", [
    ((2, 2, 70, 130, 16), 512),   # one key tile: JAX's single-pass kernel (K2)
    ((2, 2, 130, 260, 16), 128),  # three key tiles: JAX's dq + dkv sweeps (K3, K4)
    ((2, 1, 40, 70, 256), 512),   # head dim 256: the port's wide K2 on the card
    ((2, 1, 40, 260, 256), 128),  # and its wide K3 + K4
], ids=["k2", "k3k4", "k2_d256", "k3k4_d256"])
def test_training_plain_versions_match_jax_vjp(shape, block, dtype):
    """Plain forward (lse variant) and backward with an all-keep mask at
    p = 0.1 against the JAX kernels in interpret mode, whose stubbed bits keep
    everything: this pins the 1/(1-p) scaling and the backward formulas."""
    b, h, tq, tk, d = shape
    q, k, v, mask = _inputs(b, h, tq, tk, d, seed=tq + tk, masked_rows=(1,))
    g = np.random.default_rng(1).standard_normal((b, h, tq, d)).astype(np.float32)
    jd = getattr(jnp, dtype)
    f = lambda q_, k_, v_: jax_flash(q_, k_, v_, key_padding_mask=jnp.asarray(mask),
                                     dropout_rate=0.1, dropout_seed=5, block_q=block,
                                     block_k=block, interpret=True)
    out, vjp = jax.vjp(f, *(jnp.asarray(x, jd) for x in (q, k, v)))
    want = [out, *vjp(jnp.asarray(g, jd))]
    td = getattr(torch, dtype)
    args = [torch.from_numpy(x).to(td) for x in (q, k, v)]
    keep = torch.ones(b, h, tq, tk, dtype=torch.bool)
    o, lse = flash_attention_reference(*args, torch.from_numpy(mask), 0.1, keep=keep,
                                       return_lse=True)
    grads = fa.flash_attention_backward_reference(
        *args, torch.from_numpy(mask), o, lse, torch.from_numpy(g).to(td), 0.1, keep=keep)
    got = [o, *grads]
    assert all(t.dtype == td for t in got)
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0].astype(jnp.float32)),
                               atol=TOL[dtype], rtol=0)
    for name, a, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        err = _rel(a.float().numpy(), np.asarray(w.astype(jnp.float32)))
        assert err <= GRAD_TOL[dtype], (name, err)


def test_plain_backward_matches_autograd():
    """Away from fully masked rows the lse-based backward is the exact
    gradient of the plain forward, dropout (Philox bits) included."""
    q, k, v, mask = _inputs(2, 2, 40, 50, 16, seed=8)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    mask = torch.from_numpy(mask)
    seeds = fa.expand_seed(11, 2, 2)
    out = flash_attention_reference(q, k, v, mask, 0.2, seed=seeds)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    auto = torch.autograd.grad(out, (q, k, v), g)
    with torch.no_grad():
        o, lse = flash_attention_reference(q, k, v, mask, 0.2, seed=seeds, return_lse=True)
        formula = fa.flash_attention_backward_reference(q, k, v, mask, o, lse, g, 0.2,
                                                        seed=seeds)
    for a, b in zip(auto, formula):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def test_function_runs_plain_versions_on_cpu():
    """With grad enabled the wrapper goes through the autograd Function; on
    the CPU its forward and backward are the plain versions, and no kernel
    launch is counted."""
    q, k, v, mask = _inputs(2, 2, 20, 30, 16, seed=9)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    mask = torch.from_numpy(mask)
    before = dict(flash_attention.launches)
    out = flash_attention(q, k, v, mask, dropout_rate=0.1, dropout_seed=3)
    g = torch.ones_like(out)
    grads = torch.autograd.grad(out, (q, k, v), g)
    assert flash_attention.launches == before
    seeds = fa.expand_seed(3, 2, 2)
    with torch.no_grad():
        o, lse = flash_attention_reference(q, k, v, mask, 0.1, seed=seeds, return_lse=True)
        want = fa.flash_attention_backward_reference(q, k, v, mask, o, lse, g, 0.1,
                                                     seed=seeds)
    assert torch.equal(out.detach(), o)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        fa.backward_kernels(q, k, v, mask, seeds, 0.1, o, lse, g)
