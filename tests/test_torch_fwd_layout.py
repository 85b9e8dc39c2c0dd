"""The layout step in front of the bf16 forward kernel (K1, K1'), on the
CPU: the plain forward gives the same outputs (and lse) on the padded
copies ``tma_operand`` hands the kernel as on the original views, and
matches the JAX package's Pallas kernel run in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimoclip_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from vimoclip_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_reference,
    tma_legal,
    tma_operand,
)

torch.set_num_threads(1)


def _offset_view(shape, offset, generator, dtype=torch.bfloat16):
    n = int(np.prod(shape))
    return torch.randn(n + offset, generator=generator).to(dtype)[offset:].view(shape)


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("with_lse", [False, True], ids=["K1", "K1'"])
@pytest.mark.parametrize("shape, offset", [
    ((1, 2, 40, 64, 20), 0), ((2, 2, 33, 300, 32), 1), ((1, 1, 70, 130, 16), 3),
    ((1, 2, 20, 600, 20), 1),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else f"off{v}")
def test_plain_forward_on_copies_equals_original(shape, offset, with_lse, rate):
    b, h, tq, tk, d = shape
    g = torch.Generator().manual_seed(tq + tk)
    q, k, v = (_offset_view((b, h, t, d), offset, g) for t in (tq, tk, tk))
    mask = torch.rand(b, tk, generator=g) < 0.3
    mask[0] = True  # one fully masked row
    seeds = torch.arange(b * h, dtype=torch.int32).view(b, h) if rate else None
    copies = [tma_operand(t) for t in (q, k, v)]
    assert not any(tma_legal(t) for t in (q, k, v))  # every operand is copied
    assert all(tma_legal(t) for t in copies)
    ref = flash_attention_reference(q, k, v, mask, rate, seed=seeds, return_lse=with_lse)
    got = flash_attention_reference(*copies, mask, rate, seed=seeds, return_lse=with_lse)
    for a, r in zip(got if with_lse else [got], ref if with_lse else [ref]):
        assert torch.equal(a, r)


# float32: the same math in another summation order (~1e-7 relative); bf16:
# p and the output rounded to bf16 (rel. 2^-8) at points where the online
# (JAX) and one-pass (port) softmax hold different maxima
@pytest.mark.parametrize("dtype, d, tol", [("float32", 6, 1e-5), ("bfloat16", 20, 2e-2)])
def test_plain_forward_on_copies_matches_jax_kernel(dtype, d, tol):
    # float32 rows of 6 elements (24 bytes) and bf16 rows of 20 (40 bytes):
    # every operand goes through the padded copy
    b, h, tq, tk = 2, 2, 40, 200
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for t in (tq, tk, tk))
    mask = rng.random((b, tk)) < 0.3
    mask[1] = True  # a fully masked row: uniform over the real keys
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jax_flash(*(jnp.asarray(x, jd) for x in (q, k, v)),
                    key_padding_mask=jnp.asarray(mask), interpret=True)
    td = getattr(torch, dtype)
    tq_, tk_, tv_ = (tma_operand(torch.from_numpy(x).to(td)) for x in (q, k, v))
    assert all(t.stride(2) * t.element_size() % 16 == 0 for t in (tq_, tk_, tv_))
    got = flash_attention_reference(tq_, tk_, tv_, torch.from_numpy(mask))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=tol, rtol=0)


# The launch kind names the kernel the forward entry routes to (run_hopper in
# csrc/flash_attention_fwd.cu): bf16 K1 without dropout at head dims 65-128
# runs fwd_pp_wgmma_kernel; every other call keeps its kind.
@pytest.mark.parametrize("kind, d, dtype, dropout, expected", [
    ("fwd", 65, torch.bfloat16, False, "fwd_pp"),
    ("fwd", 72, torch.bfloat16, False, "fwd_pp"),
    ("fwd", 80, torch.bfloat16, False, "fwd_pp"),
    ("fwd", 128, torch.bfloat16, False, "fwd_pp"),
    ("fwd", 64, torch.bfloat16, False, "fwd"),
    ("fwd", 144, torch.bfloat16, False, "fwd_wide"),
    ("fwd", 72, torch.float32, False, "fwd"),
    ("fwd", 72, torch.bfloat16, True, "fwd"),
    ("fwd_lse", 72, torch.bfloat16, False, "fwd_lse"),
    ("fwd_lse", 72, torch.bfloat16, True, "fwd_lse"),
    ("fwd_lse", 144, torch.bfloat16, False, "fwd_lse_wide"),
    ("bwd_dqkv", 72, torch.bfloat16, False, "bwd_dqkv"),
], ids=lambda v: str(v).replace("torch.", ""))
def test_launch_kind_routes_bf16_k1_at_head_dims_65_to_128(kind, d, dtype, dropout, expected):
    from vimoclip_tpu_torch.ops.kernels.flash_attention import LAUNCH_KINDS, launch_kind

    assert launch_kind(kind, d, dtype, dropout) == expected
    assert expected in LAUNCH_KINDS


@pytest.mark.parametrize("d", [65, 72, 80, 100, 128])
def test_pp_output_rows_are_tma_legal(d):
    # fwd_pp_wgmma_kernel stores O with TMA: at any head dim its rows start 16-byte
    # aligned, and the view shows exactly D columns
    from vimoclip_tpu_torch.ops.kernels.flash_attention import fwd_output

    out = fwd_output(2, 5, 3, d, torch.bfloat16, "cpu", "fwd_pp")
    assert out.shape == (2, 3, 5, d) and tma_legal(out)
    plain = fwd_output(2, 5, 3, d, torch.bfloat16, "cpu", "fwd")
    assert plain.shape == out.shape and plain.stride()[1:] == (d, 3 * d, 1)
