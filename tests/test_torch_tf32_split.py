"""The float32 attention kernels' error budget, on the CPU.

The float32 kernels (``vimoclip_tpu_torch/csrc/tf32.cuh``) compute every
product as three TF32 passes: each operand x is split into hi = rna(x) and
lo = rna(x - hi), both rounded to TF32 (10 mantissa bits, round to nearest,
ties away from zero), and A.B = A_lo.B_hi + A_hi.B_lo + A_hi.B_hi, summed in
float32. Here numpy emulates those passes for the five products of the
forward and backward (S = Qs.K^T, O = P.V, dP = dO.V^T, dQ = dS.K,
dK = dS^T.Q, dV = P^T.dO) at the kernels' rounding points, and K3's dq
sweep over key tiles in its contraction order, and holds the
attention output, lse and gradients to a float64 reference within 1e-5: a
tenth of the 1e-4 limits the kernels meet against their plain float32
versions on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
The port's plain versions stay exact float32; the emulation lives here only.
"""

import numpy as np
import pytest

from vimoclip_tpu_torch.ops.kernels.flash_attention import _MASK_VALUE

BUDGET = 1e-5  # a tenth of KERNEL_TOL, LSE_TOL and GRAD_TOL (float32)


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """x (float32) rounded to TF32: to nearest on the low 13 mantissa bits,
    ties away from zero (cvt.rna.tf32.f32), the low bits cleared."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    x = np.asarray(x, dtype=np.float32)
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def mm3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as three TF32 passes with float32 sums (products of TF32 values
    are exact in float32)."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return (a_lo @ b_hi + a_hi @ b_lo).astype(np.float32) + a_hi @ b_hi


def _inputs(d: int, seed: int, tq: int = 96, tk: int = 160):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, t, d)).astype(np.float32) for t in (tq, tk, tk))
    do = rng.standard_normal((2, tq, d)).astype(np.float32)
    masked = rng.random(tk) < 0.25
    keep = rng.random((2, tq, tk)) >= 0.1
    return q, k, v, do, masked, keep


def _forward(q, k, v, masked, keep, rate, mm):
    """The kernels' forward at their rounding points: s from round(q * scale)
    and k, the -1e9 bias, p = exp(s - m), l over the undropped p, o = P V /
    (l (1 - rate)); returns (o, lse)."""
    f = q.dtype.type
    scale = f(1.0 / np.sqrt(q.shape[-1]))
    s = mm(q * scale, np.swapaxes(k, -1, -2)) + np.where(masked, f(_MASK_VALUE), f(0))
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    l = p.sum(-1, keepdims=True)
    o = mm(np.where(keep, p, 0), v) / (l * f(1 - rate))
    return o, (m + np.log(l))[..., 0]


def _backward(q, k, v, do, o, lse, masked, keep, rate, mm):
    """The kernels' backward from lse and delta = rowsum(dO * O):
    (dq, dk, dv)."""
    f = q.dtype.type
    scale = f(1.0 / np.sqrt(q.shape[-1]))
    delta = (do * o).sum(-1)
    s = mm(q * scale, np.swapaxes(k, -1, -2)) + np.where(masked, f(_MASK_VALUE), f(0))
    p = np.exp(s - lse[..., None])
    dp = np.where(keep, mm(do, np.swapaxes(v, -1, -2)), 0) / f(1 - rate)
    pd = np.where(keep, p, 0) / f(1 - rate)
    ds = p * (dp - delta[..., None])
    dq = mm(ds, k) * scale
    dk = mm(np.swapaxes(ds, -1, -2), q) * scale
    dv = mm(np.swapaxes(pd, -1, -2), do)
    return dq, dk, dv


def _rel(a, ref) -> float:
    """Largest |a - ref| over the largest |ref| (at least 1) of each batch
    row, as the card tests hold gradients."""
    diff = np.abs(a.astype(np.float64) - ref).reshape(len(ref), -1).max(1)
    return float((diff / np.maximum(np.abs(ref).reshape(len(ref), -1).max(1), 1.0)).max())


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("d", [16, 64, 128, 256, 512])
def test_three_pass_tf32_stays_within_a_tenth_of_the_limits(d, rate):
    q, k, v, do, masked, keep = _inputs(d, seed=d)
    if rate == 0.0:
        keep = np.ones_like(keep)
    # float64 reference on the same float32 inputs
    q64, k64, v64, do64 = (x.astype(np.float64) for x in (q, k, v, do))
    o_ref, lse_ref = _forward(q64, k64, v64, masked, keep, rate, np.matmul)
    grads_ref = _backward(q64, k64, v64, do64, o_ref, lse_ref, masked, keep, rate, np.matmul)

    o, lse = _forward(q, k, v, masked, keep, rate, mm3)
    assert o.dtype == np.float32 and lse.dtype == np.float32
    assert np.abs(o - o_ref).max() <= BUDGET
    assert (np.abs(lse - lse_ref) / np.maximum(np.abs(lse_ref), 1.0)).max() <= BUDGET
    grads = _backward(q, k, v, do, o, lse, masked, keep, rate, mm3)
    for name, g, ref in zip(("dq", "dk", "dv"), grads, grads_ref):
        assert g.dtype == np.float32
        assert _rel(g, ref) <= BUDGET, (name, _rel(g, ref))


# the key of each slot of mma's A fragment within an 8-key k-step: the
# accumulator layout holds keys 2 t4 and 2 t4 + 1 where the fragment wants
# slots t4 and t4 + 4 (csrc/tf32.cuh)
K_STEP_ORDER = np.array([0, 2, 4, 6, 1, 3, 5, 7])


def dq_sweep(ds: np.ndarray, k: np.ndarray) -> np.ndarray:
    """ds @ k as the float32 K3 sums it: over key tiles of 64 into one
    float32 accumulator, each 8-key k-step as three TF32 products (lo.hi,
    hi.lo, hi.hi, accumulated in that order) over the keys in the permuted
    order of mma's A fragment."""
    ds_hi, ds_lo = split(ds)
    k_hi, k_lo = split(k)
    tk = k.shape[-2]
    acc = np.zeros(ds.shape[:-1] + k.shape[-1:], dtype=np.float32)
    for k0 in range(0, tk, 64):
        for c in range(k0, min(k0 + 64, tk), 8):
            keys = c + K_STEP_ORDER
            keys = keys[keys < tk]
            for a, b in ((ds_lo, k_hi), (ds_hi, k_lo), (ds_hi, k_hi)):
                acc = (acc + a[..., keys] @ b[..., keys, :]).astype(np.float32)
    return acc


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("d", [64, 256])
def test_k3_sweep_past_512_keys_stays_within_a_tenth_of_the_limits(d, rate):
    """K3 past 512 keys: S and dP as three TF32 passes, dS from the saved
    lse, and dq accumulated tile by tile in float32, each tile's dS K as
    three TF32 passes in the kernel's contraction order, against float64."""
    q, k, v, do, masked, keep = _inputs(d, seed=d + 1, tq=96, tk=640)
    if rate == 0.0:
        keep = np.ones_like(keep)
    q64, k64, v64, do64 = (x.astype(np.float64) for x in (q, k, v, do))
    o_ref, lse_ref = _forward(q64, k64, v64, masked, keep, rate, np.matmul)
    dq_ref = _backward(q64, k64, v64, do64, o_ref, lse_ref, masked, keep, rate, np.matmul)[0]

    f = np.float32
    o, lse = _forward(q, k, v, masked, keep, rate, mm3)
    scale = f(1.0 / np.sqrt(d))
    s = mm3(q * scale, np.swapaxes(k, -1, -2)) + np.where(masked, f(_MASK_VALUE), f(0))
    p = np.exp(s - lse[..., None])
    dp = np.where(keep, mm3(do, np.swapaxes(v, -1, -2)), 0) / f(1 - rate)
    ds = p * (dp - (do * o).sum(-1)[..., None])
    dq = dq_sweep(ds, k) * scale
    assert dq.dtype == np.float32
    assert _rel(dq, dq_ref) <= BUDGET, _rel(dq, dq_ref)


def test_one_tf32_pass_alone_misses_the_limits():
    """The budget needs the lo passes: S from hi.hi alone (one TF32 pass)
    moves the output past the kernels' 1e-4, so the test above can fail."""
    q, k, v, _, masked, keep = _inputs(64, seed=3)
    keep = np.ones_like(keep)
    q64, k64, v64 = (x.astype(np.float64) for x in (q, k, v))
    o_ref, _ = _forward(q64, k64, v64, masked, keep, 0.0, np.matmul)
    one_pass = lambda a, b: rna_tf32(a) @ rna_tf32(b)  # noqa: E731
    o, _ = _forward(q, k, v, masked, keep, 0.0, one_pass)
    assert np.abs(o - o_ref).max() > 1e-4


def test_split_is_exact_to_tf32_squared():
    """hi + lo recovers x to about 2^-21 of |x|, and rna rounds ties away
    from zero."""
    x = np.random.default_rng(0).standard_normal(10_000).astype(np.float32)
    hi, lo = split(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    assert (np.abs(hi.astype(np.float64) + lo - x) <= 2.0**-21 * np.abs(x)).all()
    tie = np.array([1 + 2.0**-11, -(1 + 2.0**-11)], dtype=np.float32)  # halfway past 1
    assert rna_tf32(tie).tolist() == [1 + 2.0**-10, -(1 + 2.0**-10)]
