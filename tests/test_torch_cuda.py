"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA H100:  python -m pytest -m cuda tests/test_torch_cuda.py
Without a card every test here skips (decided inside the fixture)."""

import numpy as np
import pytest
import torch

from vimoclip_tpu_torch.ops.attention import (
    AUTO_FLASH_MIN_T_NODROP,
    AUTO_WIDE_FLASH_MAX_T_NODROP,
    MultiHeadAttention,
)
from vimoclip_tpu_torch.ops.kernels.flash_attention import (
    expand_seed,
    flash_attention,
    flash_attention_backward_reference,
    flash_attention_reference,
    forward_lse,
)

pytestmark = pytest.mark.cuda

# f32: the kernel and the reference sum in different orders -> ~1e-6.
# bf16: p is rounded to bf16 relative to the running max in the kernel and
# to the final max in the reference, and the output is bf16 (rel. 2^-8).
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# gradients, relative to the largest |gradient| of their batch row: f32 sums
# in other orders;
# bf16 rounds dS and P at each product (2^-8) after scores that differ in
# their last float32 bits, and stores bf16
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, h, tq, tk, d, dtype, device, seed=0, masked_rows=(0,)):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, d, generator=g).to(device, dtype)
               for t in (tq, tk, tk))
    mask = torch.rand(b, tk, generator=g) < 0.3
    for r in masked_rows:
        mask[r] = True
    return q, k, v, mask.to(device)


def _rel(a, b):
    """Largest |a - b| over the largest |b| (at least 1) of the same batch
    row: a fully masked row's gradients dwarf the other rows'."""
    diff = (a.float() - b.float()).abs().flatten(1).amax(1)
    return (diff / b.float().abs().flatten(1).amax(1).clamp_min(1.0)).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [
    (3, 8, 384, 384, 64), (3, 8, 384, 256, 64), (3, 8, 384, 299, 64),
    (3, 8, 2048, 2048, 64), (2, 2, 130, 77, 16), (2, 2, 70, 200, 128),
    (1, 3, 65, 65, 80), (2, 2, 33, 47, 20),
    # Tq != Tk at head dims 32, 256 and 512 (the wide kernels)
    (2, 2, 96, 130, 32), (2, 2, 100, 70, 256), (1, 2, 70, 90, 512),
], ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_reference(cuda, shape, dtype):
    from vimoclip_tpu_torch.ops.kernels.flash_attention import launch_kind

    q, k, v, mask = _inputs(*shape, dtype, cuda)
    kind = launch_kind("fwd", shape[-1])
    before = flash_attention.launches[kind]
    out = flash_attention(q, k, v, key_padding_mask=mask)
    torch.cuda.synchronize()
    assert flash_attention.launches[kind] == before + 1
    ref = flash_attention_reference(q, k, v, mask)
    assert out.dtype == dtype and out.shape == ref.shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
def test_kernel_reads_strided_views(cuda, dtype, offset):
    # heads split out of a packed projection, as MultiHeadAttention passes
    # them; offset 1 leaves every row misaligned (the plain-load path)
    b, t, h, d = 2, 100, 4, 32
    x = torch.randn(b, t, 3 * h * d + offset, device=cuda).to(dtype)[..., offset:]
    q, k, v = (y.view(b, t, h, d).transpose(1, 2) for y in x.split(h * d, -1))
    out = flash_attention(q, k, v)
    ref = flash_attention_reference(q.contiguous(), k.contiguous(), v.contiguous())
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def test_kernel_refusals(cuda):
    q = torch.randn(1, 2, 8, 16, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    # no head dim is refused: 160 runs on the wide kernels
    big = torch.randn(1, 1, 8, 160, device=cuda)
    out = flash_attention(big, big, big)
    assert (out - flash_attention_reference(big, big, big)).abs().max().item() <= TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_dropout_forward_runs_without_grad(cuda, dtype):
    # a dropout forward outside autograd is K1 with its fused dropout
    q, k, v, mask = _inputs(2, 2, 50, 70, 16, dtype, cuda)
    before = dict(flash_attention.launches)
    out = flash_attention(q, k, v, mask, dropout_rate=0.1, dropout_seed=1)
    assert flash_attention.launches["fwd"] == before["fwd"] + 1
    assert flash_attention.launches["fwd_lse"] == before["fwd_lse"]
    ref = flash_attention_reference(q, k, v, mask, 0.1, seed=expand_seed(1, 2, 2, cuda))
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def _train_call(q, k, v, mask, rate, seed, grad_out):
    """K1' + its backward through the autograd Function, and the plain
    versions on the same inputs and Philox mask."""
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = flash_attention(qr, kr, vr, mask, dropout_rate=rate,
                          dropout_seed=seed if rate else None)
    out.backward(grad_out)
    seeds = expand_seed(seed, q.shape[0], q.shape[1], q.device) if rate else None
    ref, lse = flash_attention_reference(q, k, v, mask, rate, seed=seeds, return_lse=True)
    grads = flash_attention_backward_reference(q, k, v, mask, ref, lse, grad_out, rate,
                                               seed=seeds)
    return (out, qr.grad, kr.grad, vr.grad), (ref, *grads)


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [
    (8, 8, 384, 384, 64), (8, 8, 384, 256, 64), (8, 8, 1024, 1024, 64),
    (2, 2, 300, 299, 64), (2, 2, 130, 77, 16), (2, 2, 70, 600, 128),
    # past 512 keys: ragged Tq != Tk at head dim 32, head dim 128, Tq below
    # one tile, and a head dim TMA needs the padded copy for (bf16 rows of 40 bytes)
    (2, 2, 700, 613, 32), (2, 2, 530, 1000, 128), (2, 2, 40, 777, 64), (2, 3, 100, 530, 20),
    # Tq above Tk at head dim 128, head dim 16 past 512 keys
    (2, 2, 300, 140, 128), (2, 2, 100, 600, 16),
], ids=lambda s: "x".join(map(str, s)))
def test_training_kernels_match_plain(cuda, shape, dtype, rate):
    b, h, tq, tk, d = shape
    q, k, v, mask = _inputs(*shape, dtype, cuda, seed=tq + tk)
    g = torch.randn(b, tq, h, d, device=cuda).to(dtype).transpose(1, 2)  # as from a merge of heads
    before = dict(flash_attention.launches)
    got, ref = _train_call(q, k, v, mask, rate, 1234, g)
    seeds = expand_seed(1234, b, h, cuda) if rate else None
    _, lse_ref = flash_attention_reference(q, k, v, mask, rate, seed=seeds, return_lse=True)
    _, lse = forward_lse(q, k, v, mask, seeds, rate)
    # elementwise: a fully masked row's lse is -1e9
    assert ((lse - lse_ref).abs() / lse_ref.abs().clamp_min(1.0)).max().item() <= 1e-4
    torch.cuda.synchronize()
    after = flash_attention.launches
    assert after["fwd_lse"] == before["fwd_lse"] + 2 and after["fwd"] == before["fwd"]
    single = tk <= 512
    assert after["bwd_dqkv"] == before["bwd_dqkv"] + single
    assert after["bwd_dq"] == before["bwd_dq"] + (not single)
    assert after["bwd_dkv"] == before["bwd_dkv"] + (not single)
    assert (got[0].float() - ref[0].float()).abs().max().item() <= TOL[dtype]
    for name, a, r in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
        assert a.dtype == dtype and a.shape == r.shape
        assert np.isfinite(a.float().cpu().numpy()).all(), name
        assert _rel(a, r) <= GRAD_TOL[dtype], (name, _rel(a, r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
def test_training_kernels_read_strided_views(cuda, dtype, offset):
    b, t, h, d = 2, 100, 4, 32
    x = torch.randn(b, t, 3 * h * d + offset, device=cuda).to(dtype)[..., offset:]
    q, k, v = (y.view(b, t, h, d).transpose(1, 2) for y in x.split(h * d, -1))
    g = torch.randn(b, h, t, d, device=cuda).to(dtype)
    got, ref = _train_call(q, k, v, None, 0.1, 5, g)
    assert (got[0].float() - ref[0].float()).abs().max().item() <= TOL[dtype]
    for a, r in zip(got[1:], ref[1:]):
        assert _rel(a, r) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
def test_long_training_kernels_read_strided_views(cuda, dtype, offset):
    # past 512 keys (K3 + K4); offset 1 leaves every bf16 row misaligned, so
    # the wrapper hands the TMA kernels a padded copy
    b, t, h, d = 2, 600, 4, 32
    x = torch.randn(b, t, 3 * h * d + offset, device=cuda).to(dtype)[..., offset:]
    q, k, v = (y.view(b, t, h, d).transpose(1, 2) for y in x.split(h * d, -1))
    g = torch.randn(b, h, t, d, device=cuda).to(dtype)
    before = dict(flash_attention.launches)
    got, ref = _train_call(q, k, v, None, 0.1, 5, g)
    torch.cuda.synchronize()
    assert flash_attention.launches["bwd_dq"] == before["bwd_dq"] + 1
    assert flash_attention.launches["bwd_dkv"] == before["bwd_dkv"] + 1
    assert (got[0].float() - ref[0].float()).abs().max().item() <= TOL[dtype]
    for a, r in zip(got[1:], ref[1:]):
        assert _rel(a, r) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_long_backward_fully_masked_rows(cuda, dtype, rate):
    # two batch rows with every key ignored: P = 1 on each of their keys, as
    # in the plain version (and the TPU kernels)
    b, h, tq, tk, d = 4, 2, 130, 700, 64
    q, k, v, mask = _inputs(b, h, tq, tk, d, dtype, cuda, seed=3, masked_rows=(0, 2))
    g = torch.randn(b, h, tq, d, device=cuda).to(dtype)
    got, ref = _train_call(q, k, v, mask, rate, 11, g)
    for name, a, r in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
        assert torch.isfinite(a.float()).all(), name
        assert _rel(a, r) <= GRAD_TOL[dtype], (name, _rel(a, r))
        # the fully masked rows' gradients are not zero: their P is 1
        assert a[0].float().abs().max().item() > 0 and a[2].float().abs().max().item() > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("tk", [384, 1024], ids=["dqkv", "dq+dkv"])
def test_backward_is_deterministic(cuda, tk, dtype):
    q, k, v, mask = _inputs(4, 8, 384, tk, 64, dtype, cuda)
    g = torch.randn(4, 8, 384, 64, device=cuda).to(dtype)
    first, _ = _train_call(q, k, v, mask, 0.1, 9, g)
    second, _ = _train_call(q, k, v, mask, 0.1, 9, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("tq, tk", [(40, 64), (40, 299), (40, 512), (130, 299), (300, 512)],
                         ids=lambda v: str(v))
def test_single_pass_kernels_match_plain(cuda, tq, tk, d, rate, dtype):
    """K1, K1' and K2 (keys within one 512-key tile) against their plain
    versions: Tq below one tile, ragged Tk, head dims 16 and 32 (the
    64-column kernels), 64 and 128 (two chunks)."""
    b, h = 2, 3
    q, k, v, mask = _inputs(b, h, tq, tk, d, dtype, cuda, seed=tq + tk + d)
    g = torch.randn(b, tq, h, d, device=cuda).to(dtype).transpose(1, 2)
    before = dict(flash_attention.launches)
    got, ref = _train_call(q, k, v, mask, rate, 77, g)
    with torch.no_grad():
        out1 = flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    after = flash_attention.launches
    assert after["fwd_lse"] == before["fwd_lse"] + 1 and after["fwd"] == before["fwd"] + 1
    assert after["bwd_dqkv"] == before["bwd_dqkv"] + 1
    assert (out1.float() - flash_attention_reference(q, k, v, mask).float()).abs().max() <= TOL[
        dtype]
    assert (got[0].float() - ref[0].float()).abs().max().item() <= TOL[dtype]
    for name, a, r in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
        assert torch.isfinite(a.float()).all(), name
        assert _rel(a, r) <= GRAD_TOL[dtype], (name, _rel(a, r))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
def test_single_pass_kernels_read_packed_heads(cuda, d, offset, dtype):
    # heads split out of a packed projection; offset 1 leaves every row
    # misaligned, so the wrapper hands the TMA kernels padded copies
    b, t, h = 2, 260, 4
    x = torch.randn(b, t, 3 * h * d + offset, device=cuda).to(dtype)[..., offset:]
    q, k, v = (y.view(b, t, h, d).transpose(1, 2) for y in x.split(h * d, -1))
    g = torch.randn(b, t, h, d, device=cuda).to(dtype).transpose(1, 2)
    got, ref = _train_call(q, k, v, None, 0.1, 21, g)
    assert (got[0].float() - ref[0].float()).abs().max().item() <= TOL[dtype]
    for a, r in zip(got[1:], ref[1:]):
        assert _rel(a, r) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p0.1"])
def test_single_pass_backward_fully_masked_rows(cuda, rate, dtype):
    # K2 with two batch rows whose every key is ignored: P = 1 on each key
    b, h, tq, tk, d = 4, 2, 130, 300, 64
    q, k, v, mask = _inputs(b, h, tq, tk, d, dtype, cuda, seed=4, masked_rows=(0, 2))
    g = torch.randn(b, h, tq, d, device=cuda).to(dtype)
    got, ref = _train_call(q, k, v, mask, rate, 13, g)
    for name, a, r in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
        assert torch.isfinite(a.float()).all(), name
        assert _rel(a, r) <= GRAD_TOL[dtype], (name, _rel(a, r))
        assert a[0].float().abs().max().item() > 0 and a[2].float().abs().max().item() > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("d", [16, 32, 128])
def test_single_pass_backward_is_deterministic(cuda, d, rate, dtype):
    q, k, v, mask = _inputs(2, 4, 200, 450, d, dtype, cuda)
    g = torch.randn(2, 4, 200, d, device=cuda).to(dtype)
    first, _ = _train_call(q, k, v, mask, rate, 9, g)
    second, _ = _train_call(q, k, v, mask, rate, 9, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_no_cuda_tensor_reaches_a_plain_version(cuda, monkeypatch, dtype):
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(fa, "flash_attention_reference", refuse)
    monkeypatch.setattr(fa, "flash_attention_backward_reference", refuse)
    for tk in (300, 700):  # K2; K3 + K4
        q, k, v, mask = _inputs(2, 2, 100, tk, 64, dtype, cuda)
        qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
        fa.flash_attention(qr, kr, vr, mask, dropout_rate=0.1, dropout_seed=3).sum().backward()
        with torch.no_grad():
            fa.flash_attention(q, k, v, mask)
            fa.flash_attention(q, k, v, mask, dropout_rate=0.1, dropout_seed=3)
        torch.cuda.synchronize()
        assert all(torch.isfinite(t.grad.float()).all() for t in (qr, kr, vr))


def test_kept_fraction(cuda):
    q, k, v, _ = _inputs(4, 8, 256, 256, 16, torch.float32, cuda)
    seeds = expand_seed(3, 4, 8, cuda)
    from vimoclip_tpu_torch.ops.kernels.flash_attention import dropout_keep_mask

    frac = dropout_keep_mask(seeds, 256, 256, 0.1).float().mean().item()
    n = 4 * 8 * 256 * 256
    assert abs(frac - 0.9) <= 5 * (0.9 * 0.1 / n) ** 0.5


def test_mha_flash_matches_eager_on_card(cuda):
    torch.manual_seed(0)
    mha = MultiHeadAttention(512, 8, dtype=torch.bfloat16).to(cuda).eval()
    x = torch.randn(3, 384, 512, device=cuda)
    kv = torch.randn(3, 256, 512, device=cuda)
    mask = torch.rand(3, 256, device=cuda) < 0.2
    with torch.no_grad():
        mha.implementation = "xla"
        ref = mha(x, kv=kv, key_padding_mask=mask).float()
        mha.implementation = "flash"
        out = mha(x, kv=kv, key_padding_mask=mask).float()
    assert np.isfinite(out.cpu().numpy()).all()
    assert (out - ref).abs().max().item() < 5e-2


@pytest.mark.parametrize("t", [128, 4096], ids=["short", "long"])
def test_auto_sends_dropout_to_the_kernels(cuda, t):
    """``auto`` with dropout active takes the kernels at any key length;
    without dropout a short key length stays on the eager path."""
    mha = MultiHeadAttention(64, 4, dropout=0.1, implementation="auto").to(cuda)
    x = torch.randn(2, t, 64, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = dict(flash_attention.launches)
    mha.train()(x, generator=gen).sum().backward()
    assert flash_attention.launches["fwd_lse"] == before["fwd_lse"] + 1
    with torch.no_grad():
        mha.eval()(x)
    eager = t < AUTO_FLASH_MIN_T_NODROP
    assert flash_attention.launches["fwd"] == before["fwd"] + (0 if eager else 1)


def test_auto_without_dropout_follows_the_measured_crossover(cuda):
    """``auto`` in eval mode takes K1 from the no-dropout crossover on and the
    eager path below it."""
    n = AUTO_FLASH_MIN_T_NODROP
    mha = MultiHeadAttention(64, 4, dropout=0.1, implementation="auto").to(cuda).eval()
    for t in sorted({max(1, n - 1), n, 2 * n}):
        before = flash_attention.launches["fwd"]
        with torch.no_grad():
            out = mha(torch.randn(2, t, 64, device=cuda))
        assert torch.isfinite(out).all()
        assert flash_attention.launches["fwd"] == before + (1 if t >= n else 0), t


def test_auto_at_wide_head_dims_follows_the_measured_rule(cuda):
    """A 2-head d512 TFAM (head dim 256) under ``auto``: a train step with
    dropout on a short clip runs the wide kernels, with the loss of the
    ``flash`` step from the same state and generator, and within
    flash-vs-eager rounding of the ``xla`` step; in float32 eval steps run
    K1 below ``AUTO_WIDE_FLASH_MAX_T_NODROP`` keys and eager attention from
    there, and an attention with dropout runs the kernels at every length,
    as bf16 does with dropout and without."""
    import dataclasses

    from vimoclip_tpu_torch import losses
    from vimoclip_tpu_torch.config import TFAMModelConfig
    from vimoclip_tpu_torch.models.tfam import TFAM

    cfg = TFAMModelConfig(d_model=512, nhead=2, num_layers=2, dim_feedforward=1024,
                          use_cross_attention=True, dropout=0.1, mlp_dropout=0.1,
                          attention_impl="auto")
    g = torch.Generator().manual_seed(0)
    x, m = torch.randn(2, 16, 512, generator=g), torch.randn(2, 15, 512, generator=g)
    labels = (torch.rand(2, 6, generator=g) < 0.3).float()
    x, m, labels = x.to(cuda), m.to(cuda), labels.to(cuda)
    state, loss, ran, models = None, {}, {}, {}
    for impl in ("auto", "flash", "xla"):
        model = models[impl] = TFAM(dataclasses.replace(cfg, attention_impl=impl),
                                    num_classes=6).to(cuda)
        if state is None:
            state = model.state_dict()
        model.load_state_dict(state)
        before = dict(flash_attention.launches)
        gen = torch.Generator(device=cuda).manual_seed(1)
        out = losses.bce_with_logits(model.train()(x, m, generator=gen), labels)
        out.backward()
        torch.cuda.synchronize()
        ran[impl] = {k: n - before[k] for k, n in flash_attention.launches.items()
                     if n != before[k]}
        loss[impl] = out.item()
    assert ran["auto"] == ran["flash"] == {"fwd_lse_wide": 4, "bwd_dqkv_wide": 4}, ran
    assert not ran["xla"]
    assert loss["auto"] == loss["flash"], loss
    assert abs(loss["flash"] - loss["xla"]) <= 1e-4, loss
    model = models["auto"].eval()
    n = AUTO_WIDE_FLASH_MAX_T_NODROP
    for t in (16, n, 4096):
        before = flash_attention.launches["fwd_wide"]
        with torch.no_grad():
            out = model(torch.randn(2, t, 512, device=cuda), torch.randn(2, t - 1, 512,
                                                                       device=cuda))
        assert torch.isfinite(out).all()
        # 2 layers; the cross-attention site's keys are the t - 1 motion frames
        want = 2 * ((t < n) + (t - 1 < n))
        assert flash_attention.launches["fwd_wide"] == before + want, t
    mha = MultiHeadAttention(512, 2, dropout=0.1, implementation="auto").to(cuda).train()
    gen = torch.Generator(device=cuda).manual_seed(2)
    for t in (n - 64, n, 2 * n, 4096):
        before = flash_attention.launches["fwd_lse_wide"]
        mha(torch.randn(1, t, 512, device=cuda, requires_grad=True), generator=gen)
        assert flash_attention.launches["fwd_lse_wide"] == before + 1, t
    # bf16 takes the kernels at every length, with dropout and without
    half = MultiHeadAttention(512, 2, dropout=0.1, implementation="auto",
                              dtype=torch.bfloat16).to(cuda)
    x = torch.randn(1, 2 * n, 512, device=cuda, requires_grad=True)
    before = dict(flash_attention.launches)
    half.train()(x, generator=gen)
    with torch.no_grad():
        half.eval()(x)
    assert flash_attention.launches["fwd_lse_wide"] == before["fwd_lse_wide"] + 1
    assert flash_attention.launches["fwd_wide"] == before["fwd_wide"] + 1


# ---------------------------------------------------------------------------
# head dims above 128: the wide kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", [130, 160, 192, 256, 320, 384, 512])
@pytest.mark.parametrize("tk", [300, 600], ids=["dqkv", "dq+dkv"])
def test_wide_kernels_match_plain(cuda, tk, d, dtype, rate):
    """K1, K1' and K2 (or K3 + K4) above head dim 128 against their plain
    versions, at global dropout offsets; 130 is a head dim whose bf16 rows
    TMA reads from the wrapper's padded copy; 160, 320 and 384 leave a last
    chunk partly filled or a pair of 128-column slices with one slice (or
    none of the second's columns)."""
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa

    b, h, tq = 2, 2, 130
    q, k, v, mask = _inputs(b, h, tq, tk, d, dtype, cuda, seed=d + tk)
    seeds = expand_seed(77, b, h, cuda) if rate else None
    at = dict(row0=192, col0=4 * tk)
    before = dict(flash_attention.launches)
    with torch.no_grad():
        k1 = flash_attention(q, k, v, mask, rate, seeds, **at)
    out, lse = fa.forward_lse(q, k, v, mask, seeds, rate, **at)
    ref, ref_lse = flash_attention_reference(q, k, v, mask, rate, seed=seeds,
                                             return_lse=True, **at)
    grad = torch.randn(b, tq, h, d, device=cuda).to(dtype).transpose(1, 2)
    got = fa.backward(q, k, v, mask, seeds, rate, out, lse, grad, **at)
    want = flash_attention_backward_reference(q, k, v, mask, out, lse, grad, rate, seed=seeds,
                                              **at)
    torch.cuda.synchronize()
    ran = {kind: n - before[kind] for kind, n in flash_attention.launches.items()
           if n != before[kind]}
    bwd = {"bwd_dqkv_wide": 1} if tk <= 512 else {"bwd_dq_wide": 1, "bwd_dkv_wide": 1}
    assert ran == {"fwd_wide": 1, "fwd_lse_wide": 1, **bwd}, ran
    assert (k1.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert ((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1.0)).max().item() <= 1e-4
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == r.shape
        assert _rel(a, r) <= GRAD_TOL[dtype], (name, _rel(a, r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("t", [200, 600], ids=["dqkv", "dq+dkv"])
def test_wide_kernels_read_packed_heads(cuda, t, dtype, offset):
    """Head dim 256 split out of a packed projection (strided (B, H, T)
    views); offset 1 leaves every bf16 row misaligned, so the wrapper hands
    the TMA kernels a padded copy."""
    b, h, d = 2, 2, 256
    x = torch.randn(b, t, 3 * h * d + offset, device=cuda).to(dtype)[..., offset:]
    q, k, v = (y.view(b, t, h, d).transpose(1, 2) for y in x.split(h * d, -1))
    g = torch.randn(b, h, t, d, device=cuda).to(dtype)
    got, ref = _train_call(q, k, v, None, 0.1, 5, g)
    assert (got[0].float() - ref[0].float()).abs().max().item() <= TOL[dtype]
    for a, r in zip(got[1:], ref[1:]):
        assert _rel(a, r) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("tk", [300, 700], ids=["dqkv", "dq+dkv"])
def test_wide_backward_fully_masked_rows(cuda, tk, rate, dtype):
    """Two batch rows with every key ignored at head dim 256: P = 1 on each
    of their keys, as in the plain version (and the TPU kernels)."""
    q, k, v, mask = _inputs(4, 2, 130, tk, 256, dtype, cuda, seed=3, masked_rows=(0, 2))
    g = torch.randn(4, 2, 130, 256, device=cuda).to(dtype)
    got, ref = _train_call(q, k, v, mask, rate, 11, g)
    assert (got[0].float() - ref[0].float()).abs().max().item() <= TOL[dtype]
    for name, a, r in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
        assert torch.isfinite(a.float()).all(), name
        assert _rel(a, r) <= GRAD_TOL[dtype], (name, _rel(a, r))
        assert a[0].float().abs().max().item() > 0 and a[2].float().abs().max().item() > 0


@pytest.mark.parametrize("d", [256, 384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("tk", [384, 1024], ids=["dqkv", "dq+dkv"])
def test_wide_backward_is_deterministic(cuda, tk, dtype, d):
    q, k, v, mask = _inputs(4, 2, 384, tk, d, dtype, cuda)
    g = torch.randn(4, 2, 384, d, device=cuda).to(dtype)
    first, _ = _train_call(q, k, v, mask, 0.1, 9, g)
    second, _ = _train_call(q, k, v, mask, 0.1, 9, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind, rows, cols", [("fwd_lse", 128, 256), ("bwd_dqkv", 128, 320),
                                              ("bwd_dq", 128, 640)])
@pytest.mark.parametrize("d", [256, 384, 512])
def test_wide_kernels_draw_the_plain_bits(cuda, d, kind, rows, cols):
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa

    seed = _seeds(cuda, 2, 2)
    got = fa.kernel_keep_bits(kind, seed, rows, cols, 0.1, 64, 128, head_dim=d)
    assert torch.equal(got, fa.dropout_keep_mask(seed, rows, cols, 0.1, 64, 128))


@pytest.mark.parametrize("entry", ["vimo_flash_attention_fwd_occupancy",
                                   "vimo_flash_attention_bwd_dqkv_occupancy",
                                   "vimo_flash_attention_bwd_dq_occupancy"])
@pytest.mark.parametrize("drop", [0, 1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("d", [256, 512])
def test_wide_kernels_fit_an_sm(cuda, d, drop, entry):
    """The bf16 K1/K1', K2 and K3 above head dim 128 (the paired kernels)
    launch at least one CTA per SM, with their shared memory at that head
    dim."""
    import ctypes

    from vimoclip_tpu_torch.ops.kernels import _build

    lib = "flash_attention_fwd" if "fwd" in entry else "flash_attention_bwd"
    fn = getattr(_build.load_library(lib), entry)
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    assert fn(d, drop) >= 1, fn(d, drop)


# ---------------------------------------------------------------------------
# K3 alone: float32 (three-pass TF32: dq_tf32_kernel, dq_tf32_wide_kernel)
# and bf16 above head dim 128 (dq_pair_wgmma_kernel)
# ---------------------------------------------------------------------------


def _dq_alone(q, k, v, mask, seeds, rate, grad, keep_bits=None, **at):
    """K3 alone, launched as ``backward_kernels`` launches it past 512
    keys, from K1''s lse: its dq and the plain version's. ``keep_bits``:
    the buffer a bf16 K3 with dropout fills for K4."""
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa

    b, h, tq, d = q.shape
    out, lse = fa.forward_lse(q, k, v, mask, seeds, rate, **at)
    delta = (grad.float() * out.float()).sum(-1).contiguous()
    ops = [fa.tma_operand(fa._rows(t)) for t in (q, k, v, grad)]
    dq = fa._heads_major(b, tq, h, d, q.dtype, q.device)
    fa._launch_bwd("bwd_dq", *ops[:3], mask, seeds, rate, lse, delta, ops[3], dq, None, None,
                   keep_bits, **at)
    want = flash_attention_backward_reference(q, k, v, mask, out, lse, grad, rate, seed=seeds,
                                              **at)[0]
    return dq, want


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("shape", [
    *((2, 2, 130, 600, d) for d in (16, 32, 64, 96, 128, 192, 256, 512)),
    # past 512 keys: Tq != Tk, ragged; Tq below one tile, narrow and wide
    (2, 2, 577, 1000, 64), (2, 2, 40, 777, 64), (2, 2, 40, 777, 256),
], ids=lambda s: "x".join(map(str, s)))
def test_float32_dq_kernel_matches_plain(cuda, shape, rate):
    """The float32 K3 alone within 1e-4 of its plain version at every head
    dim, with user-masked keys and a fully masked batch row (P = 1 on each
    of its keys, so its dq is not zero), at global dropout offsets; two
    calls bitwise equal."""
    b, h, tq, tk, d = shape
    q, k, v, mask = _inputs(*shape, torch.float32, cuda, seed=tq + tk + d)
    g = torch.randn(b, tq, h, d, device=cuda).transpose(1, 2)
    seeds = expand_seed(21, b, h, cuda) if rate else None
    at = dict(row0=64, col0=4 * tk)
    kind = "bwd_dq_wide" if d > 128 else "bwd_dq"
    before = dict(flash_attention.launches)
    got, want = _dq_alone(q, k, v, mask, seeds, rate, g, **at)
    again, _ = _dq_alone(q, k, v, mask, seeds, rate, g, **at)
    torch.cuda.synchronize()
    assert flash_attention.launches[kind] == before[kind] + 2
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= GRAD_TOL[torch.float32], _rel(got, want)
    assert torch.equal(got, again)
    assert got[0].abs().max().item() > 0  # the fully masked row


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("shape", [
    *((2, 2, 130, 600, d) for d in (130, 160, 256, 320, 384, 512, 640)),
    # Tq below one tile, ragged keys
    (2, 2, 40, 777, 256), (2, 2, 40, 777, 640),
], ids=lambda s: "x".join(map(str, s)))
def test_bf16_wide_dq_kernel_matches_plain(cuda, shape, rate):
    """The bf16 K3 above head dim 128 (the paired kernel) alone within
    ``GRAD_TOL`` of its plain version, with user-masked keys and a fully
    masked batch row, at global dropout offsets: 130 is read from the
    wrapper's padded copy, 160, 320, 384 and 640 leave a pair with one
    slice or a partial one, 640 streams q and dO; two calls bitwise equal;
    with dropout the keep bits it stores for K4 are the plain mask's."""
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa

    b, h, tq, tk, d = shape
    q, k, v, mask = _inputs(*shape, torch.bfloat16, cuda, seed=tq + tk + d)
    g = torch.randn(b, tq, h, d, device=cuda).to(torch.bfloat16).transpose(1, 2)
    seeds = expand_seed(23, b, h, cuda) if rate else None
    at = dict(row0=64, col0=4 * tk)
    nk, tq_pad = -(-tk // 64), -(-tq // 64) * 64
    bits = [torch.zeros(b, h, nk, tq_pad, 2, dtype=torch.int32, device=cuda) if rate else None
            for _ in range(2)]
    before = dict(flash_attention.launches)
    got, want = _dq_alone(q, k, v, mask, seeds, rate, g, bits[0], **at)
    again, _ = _dq_alone(q, k, v, mask, seeds, rate, g, bits[1], **at)
    torch.cuda.synchronize()
    assert flash_attention.launches["bwd_dq_wide"] == before["bwd_dq_wide"] + 2
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    assert _rel(got, want) <= GRAD_TOL[torch.bfloat16], _rel(got, want)
    assert torch.equal(got, again)
    assert got[0].float().abs().max().item() > 0  # the fully masked row
    if rate:
        words = bits[0].to(torch.int64) & 0xFFFFFFFF
        kept = (words[..., None] >> torch.arange(32, device=cuda)) & 1
        kept = kept.reshape(b, h, nk, tq_pad, 64).permute(0, 1, 3, 2, 4).reshape(b, h, tq_pad, -1)
        plain = fa.dropout_keep_mask(seeds, tq, tk, rate, at["row0"], at["col0"])
        assert torch.equal(kept[:, :, :tq, :tk].bool(), plain)
        assert torch.equal(bits[0], bits[1])


@pytest.mark.parametrize("d", [64, 256])
def test_float32_dq_kernel_reads_a_misaligned_view(cuda, d):
    """Operands split out of a packed projection 4 bytes past a 16-byte
    boundary: ``backward_kernels`` hands K3 the padded copy ``tma_operand``
    makes, and its dq equals the plain version's."""
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa

    b, t, h = 2, 600, 2
    x = torch.randn(b, t, 3 * h * d + 1, device=cuda)[..., 1:]
    q, k, v = (y.view(b, t, h, d).transpose(1, 2) for y in x.split(h * d, -1))
    assert not fa.tma_legal(q)
    g = torch.randn(b, h, t, d, device=cuda)
    seeds = expand_seed(3, b, h, cuda)
    out, lse = fa.forward_lse(q, k, v, None, seeds, 0.1)
    before = flash_attention.launches[fa.launch_kind("bwd_dq", d)]
    got = fa.backward_kernels(q, k, v, None, seeds, 0.1, out, lse, g)[0]
    want = flash_attention_backward_reference(q, k, v, None, out, lse, g, 0.1, seed=seeds)[0]
    torch.cuda.synchronize()
    assert flash_attention.launches[fa.launch_kind("bwd_dq", d)] == before + 1
    assert _rel(got, want) <= GRAD_TOL[torch.float32], _rel(got, want)


@pytest.mark.parametrize("d", [64, 128, 256, 512])
def test_float32_dq_kernel_draws_the_plain_bits(cuda, d):
    """The float32 K3 keeps no keep-bit buffer: its bits, read back
    through dq (``kernel_keep_bits``), are the plain mask's bit for bit at
    global offsets."""
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa

    seed = _seeds(cuda, 2, 2)
    got = fa.kernel_keep_bits("bwd_dq", seed, 128, 640, 0.1, 192, 256, head_dim=d,
                              dtype=torch.float32)
    assert torch.equal(got, fa.dropout_keep_mask(seed, 128, 640, 0.1, 192, 256))


# ---------------------------------------------------------------------------
# K5: fused uint8 -> CLIP normalisation, and the stage-1 paths that run it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape, offset", [
    ((8, 224, 224, 3), 0), ((3, 17, 31, 3), 0), ((3, 17, 31, 3), 5), ((1, 1, 1, 3), 3),
    ((2, 5, 7, 3), 8), ((4, 16, 16, 3), 12), ((2, 9, 13, 3), 1), ((16, 48, 1, 3), 4),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else f"off{v}")
def test_normalize_kernel_matches_plain_bitwise(cuda, shape, offset, dtype):
    from vimoclip_tpu_torch.ops.kernels.normalize import (
        fused_normalize,
        fused_normalize_reference,
    )

    n = int(np.prod(shape))
    g = torch.Generator(device="cpu").manual_seed(n + offset)
    base = torch.randint(0, 256, (n + offset,), generator=g, dtype=torch.uint8).to(cuda)
    x = base[offset:].view(shape)  # a storage offset: any alignment
    before = fused_normalize.launches
    out = fused_normalize(x, dtype=dtype)
    torch.cuda.synchronize()
    assert fused_normalize.launches == before + 1
    ref = fused_normalize_reference(x, dtype=dtype)
    assert out.dtype == dtype and out.shape == x.shape
    assert torch.equal(out, ref)


def test_normalize_kernel_on_a_transposed_view(cuda):
    from vimoclip_tpu_torch.ops.kernels.normalize import fused_normalize

    x = torch.randint(0, 256, (2, 3, 40, 50), dtype=torch.uint8, device=cuda).permute(0, 2, 3, 1)
    assert torch.equal(fused_normalize(x), fused_normalize(x.contiguous()))


def _stage1_items(n, hw, seed=0):
    rng = np.random.default_rng(seed)
    return [{"video_id": f"s{i}", "rgb_emb": rng.standard_normal((6, 16)).astype(np.float32),
             "motion_frames": rng.integers(0, 256, (5, *hw, 3), dtype=np.uint8),
             "labels": np.eye(5, dtype=np.float32)[i % 5]} for i in range(n)]


_TINY_VIT = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=1, num_heads=2,
                 intermediate_size=128, projection_dim=16)


@pytest.mark.parametrize("hw, launches", [((32, 32), 1), ((36, 48), 0)],
                         ids=["no-resize", "resize"])
def test_stage1_bf16_step_launches_k5_once(cuda, tmp_path, hw, launches):
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig
    from vimoclip_tpu_torch.ops.kernels.normalize import fused_normalize
    from vimoclip_tpu_torch.train.student_trainer import StudentTrainer

    items = _stage1_items(8, hw)
    trainer = StudentTrainer(items, items, checkpoint_dir=str(tmp_path), num_classes=5,
                             vision_config=ClipVisionConfig(**_TINY_VIT), batch_size=4,
                             num_workers=1, lr=1e-3, device="cuda")
    before = fused_normalize.launches
    vals, logits = trainer.train_step(trainer.train_loader.collate(items[:4]))
    torch.cuda.synchronize()
    assert fused_normalize.launches == before + launches
    assert logits.shape == (4, 5) and torch.isfinite(vals).all()
    assert trainer.eval_step(trainer.val_loader.collate(items[4:])).isfinite().all()
    assert fused_normalize.launches == before + 2 * launches


def test_export_chunk_path_on_card(cuda):
    from vimoclip_tpu_torch.export import MotionEmbeddingExporter
    from vimoclip_tpu_torch.models import init_parameters_
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
    from vimoclip_tpu_torch.ops.kernels.normalize import fused_normalize
    from vimoclip_tpu_torch.ops.preprocess import clip_preprocess

    cfg = ClipVisionConfig(**_TINY_VIT)
    tower = init_parameters_(ClipVisionEncoder(cfg), torch.Generator().manual_seed(0))
    exp = MotionEmbeddingExporter(tower.state_dict(), cfg, chunk_size=16, device="cuda")
    frames = np.random.default_rng(1).integers(0, 256, (11, 32, 32, 3), dtype=np.uint8)
    before = fused_normalize.launches
    emb = exp._embed_chunk(frames)
    assert fused_normalize.launches == before + 1
    assert emb.shape == (11, 16) and np.isfinite(emb).all()
    padded = torch.zeros(16, 32, 32, 3, dtype=torch.uint8, device=cuda)
    padded[:11] = torch.from_numpy(frames).to(cuda)
    with torch.inference_mode():
        ref = exp.encoder(clip_preprocess(padded, 32, dtype=torch.bfloat16)).float()[:11]
    np.testing.assert_array_equal(emb, ref.cpu().numpy())


def _synthetic_decoder(videos):
    """A ``decode_fn`` over in-memory uint8 videos keyed by path."""
    def decode(path, chunk_size):
        frames = videos[path]
        for i in range(0, len(frames), chunk_size):
            yield frames[i:i + chunk_size]
    return decode


def _tiny_extractor(videos, **kw):
    from vimoclip_tpu_torch.extraction import ClipExtractor
    from vimoclip_tpu_torch.models import init_parameters_
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder

    cfg = ClipVisionConfig(**_TINY_VIT)
    tower = init_parameters_(ClipVisionEncoder(cfg), torch.Generator().manual_seed(0))
    return ClipExtractor(tower.state_dict(), cfg, batch_size=8, device="cuda",
                         decode_fn=_synthetic_decoder(videos), **kw)


@pytest.mark.parametrize("hw, per_dispatch", [((32, 32), 1), ((36, 48), 0)],
                         ids=["no-resize", "resize"])
def test_extractor_equals_sequential_and_counts_k5(cuda, hw, per_dispatch):
    """Frames packed across videos in padded 8-frame batches give the
    embeddings of each video run alone in padded batches; K5 launches once
    per dispatch when the frames have the encoder's size."""
    from vimoclip_tpu_torch.ops.batching import pad_to_batch
    from vimoclip_tpu_torch.ops.kernels.normalize import fused_normalize
    from vimoclip_tpu_torch.ops.preprocess import clip_preprocess

    rng = np.random.default_rng(2)
    videos = {f"v{t}": rng.integers(0, 256, (t, *hw, 3), dtype=np.uint8) for t in (5, 11, 3)}
    extractor = _tiny_extractor(videos, decode_workers=2)
    got = {}
    before = fused_normalize.launches
    errors = extractor.extract([(k, k) for k in videos], lambda v, e: got.__setitem__(v, e))
    assert errors == {} and set(got) == set(videos)
    assert fused_normalize.launches == before + per_dispatch * 3  # 19 frames, batch 8
    for vid, frames in videos.items():
        ref = []
        for i in range(0, len(frames), 8):
            x = torch.from_numpy(pad_to_batch(frames[i:i + 8], 8)).to(cuda)
            with torch.inference_mode():
                emb = extractor.encoder(clip_preprocess(x, 32, dtype=torch.bfloat16))
            ref.append(emb.float()[:len(frames[i:i + 8])].cpu().numpy())
        np.testing.assert_array_equal(got[vid], np.concatenate(ref))


def test_coalesced_predict_batch_matches_solo_calls(cuda, monkeypatch):
    """The daemon's pooled call on the card: ``predict_batch`` over clips of
    two resolutions (K5 on the 32x32 ones) against each clip alone, with one
    fusion call (two K1 launches at one layer) per call."""
    from vimoclip_tpu_torch import serving
    from vimoclip_tpu_torch.config import TFAMModelConfig
    from vimoclip_tpu_torch.models import init_parameters_
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
    from vimoclip_tpu_torch.models.tfam import TFAM
    from vimoclip_tpu_torch.ops.kernels.normalize import fused_normalize

    rng = np.random.default_rng(5)
    clips = {f"c{i}": rng.integers(0, 256, (t, *hw, 3), dtype=np.uint8)
             for i, (t, hw) in enumerate([(9, (32, 32)), (20, (36, 48)), (13, (32, 32)),
                                          (6, (36, 48))])}
    monkeypatch.setattr(serving, "read_video",
                        lambda path, max_frames=None: clips[path][:max_frames])
    g = torch.Generator().manual_seed(0)
    cfg = ClipVisionConfig(**_TINY_VIT)
    tcfg = TFAMModelConfig(d_model=16, nhead=2, num_layers=1, dim_feedforward=32,
                           attention_impl="flash")
    pred = serving.ViMoCLIPPredictor(
        init_parameters_(ClipVisionEncoder(cfg), g).state_dict(), cfg,
        init_parameters_(ClipVisionEncoder(cfg), g).state_dict(), cfg,
        init_parameters_(TFAM(tcfg, num_classes=7), g).state_dict(), tcfg, num_classes=7,
        frame_batch=8, length_bucket=8, device="cuda")
    fwd, k5 = flash_attention.launches["fwd"], fused_normalize.launches
    pooled = pred.predict_batch(list(clips), top_k=3)
    torch.cuda.synchronize()
    assert flash_attention.launches["fwd"] == fwd + 2
    assert fused_normalize.launches > k5
    for p, vid in zip(pooled, clips):
        solo = pred.predict_batch([vid], top_k=3)[0]
        assert p.video_id == vid and np.isfinite(p.probabilities).all()
        np.testing.assert_allclose(p.probabilities, solo.probabilities, atol=1e-3, rtol=0)


@pytest.mark.parametrize("rows", [8, 16, 17, 512])
def test_int_mm_is_the_exact_product_on_card(cuda, rows):
    """``torch._int_mm`` behind ``ops/quant.int_mm``: the int32 sums bit for
    bit against the exact product (float64 sums of int8 products are exact
    below 2^53), including at <= 16 rows, which the wrapper pads."""
    from vimoclip_tpu_torch.ops.quant import int_mm

    g = torch.Generator(device="cpu").manual_seed(rows)
    a = torch.randint(-127, 128, (rows, 768), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (2304, 768), generator=g, dtype=torch.int8)
    got = int_mm(a.to(cuda), b.to(cuda))
    assert got.dtype == torch.int32 and got.shape == (rows, 2304)
    exact = a.double() @ b.double().t()
    assert torch.equal(got.cpu().double(), exact)


def test_merged_tower_flash_matches_eager_at_full_width(cuda):
    """ViT-B/16 at full width merging 16 tokens a block, float32: K1 at every
    token count the schedule leaves (197 down to 21) against the eager
    attention, per-frame cosine >= 0.9999. In bf16 the two paths round
    differently enough to change which tokens merge on noise frames (cosine
    0.998 there, chip_smoke.py phase 13); float32 keeps the merges equal."""
    import dataclasses

    from vimoclip_tpu_torch.models import init_parameters_
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder

    cfg = ClipVisionConfig.vit_b_16()
    g = torch.Generator().manual_seed(0)
    state = init_parameters_(ClipVisionEncoder(cfg), g).state_dict()
    pixels = torch.randn(8, 224, 224, 3, generator=g).to(cuda)
    out = {}
    for impl in ("xla", "flash"):
        enc = ClipVisionEncoder(dataclasses.replace(cfg, token_merge_r=16,
                                                    attention_impl=impl))
        enc.load_state_dict(state)
        enc = enc.to(cuda).eval()
        before = flash_attention.launches["fwd"]
        with torch.inference_mode():
            out[impl] = enc(pixels).double()
        torch.cuda.synchronize()
        assert flash_attention.launches["fwd"] - before == (12 if impl == "flash" else 0)
    cos = torch.nn.functional.cosine_similarity(out["flash"], out["xla"], dim=-1)
    assert cos.min().item() >= 0.9999, cos


def test_merged_tower_flash_matches_eager_with_the_same_merges_in_bf16(cuda):
    """ViT-B/16 at full width merging 16 tokens a block, bf16: K1 against the
    eager attention with both towers applying the merges the eager run chose
    (``bipartite_merge``'s ``plan``), so only the kernel's rounding is left;
    per-frame cosine >= 0.9999 (chip_smoke.py phase 13 holds the same at
    batch 256)."""
    import dataclasses

    from vimoclip_tpu_torch.models import clip_vit, init_parameters_
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
    from vimoclip_tpu_torch.ops.tome import bipartite_merge, merge_plan

    cfg = dataclasses.replace(ClipVisionConfig.vit_b_16(), token_merge_r=16)
    g = torch.Generator().manual_seed(0)
    state = init_parameters_(ClipVisionEncoder(cfg), g).state_dict()
    pixels = torch.randn(8, 224, 224, 3, generator=g).to(cuda, torch.bfloat16)
    plans, out = [], {}

    def record(x, sizes, step):
        plans.append(merge_plan(x, step))
        return bipartite_merge(x, sizes, step, plan=plans[-1])

    try:
        for impl in ("xla", "flash"):
            replay = iter(plans)
            clip_vit.bipartite_merge = record if impl == "xla" else (
                lambda x, sizes, step, replay=replay: bipartite_merge(
                    x, sizes, step, plan=next(replay)))
            enc = ClipVisionEncoder(dataclasses.replace(cfg, attention_impl=impl),
                                    dtype=torch.bfloat16)
            enc.load_state_dict(state)
            enc = enc.to(cuda).eval()
            with torch.inference_mode():
                out[impl] = enc(pixels).double()
    finally:
        clip_vit.bipartite_merge = bipartite_merge
    assert len(plans) == 11 and next(replay, None) is None
    cos = torch.nn.functional.cosine_similarity(out["flash"], out["xla"], dim=-1)
    assert cos.min().item() >= 0.9999, cos


# K1 under ToMe (as chip_smoke.py's K1_TOME_*, where the readings are): max|d|
# / max|ref|, and the gain sum(got * ref) / sum(ref * ref) - 1, which an
# unmasked zero key shifts
K1_TOME_REL = 2e-2
K1_TOME_GAIN = 1e-4


def _k1_readings(ref, got):
    ref, got = ref.double(), got.double()
    return (((got - ref).abs().max() / ref.abs().max()).item(),
            ((got * ref).sum() / (ref * ref).sum()).item() - 1.0)


@pytest.mark.parametrize("n, r", [(197, 16), (50, 4)], ids=["vit_b_16", "vit_b_32"])
def test_k1_at_every_merged_token_count(cuda, n, r):
    """bf16 K1 on q/k/v of a packed projection of the layer-normed merged
    stream (~N(0, 1), as a block makes them), at each token count of the
    tower's ToMe schedule: TMA reads them in place and K1 agrees with its
    plain version within limits that refuse a key dropped at the tail, a
    key read past the end (the next frame's first token) and an unmasked
    zero key past the end, each planted at every count."""
    import torch.nn.functional as F

    from vimoclip_tpu_torch.ops.kernels.flash_attention import tma_legal
    from vimoclip_tpu_torch.ops.tome import bipartite_merge, merge_schedule

    def refused(rel, gain):
        return rel > K1_TOME_REL or abs(gain) > K1_TOME_GAIN

    g = torch.Generator(device="cpu").manual_seed(n)
    b, h, d = 8, 12, 64
    e = h * d
    x = torch.randn(b, n, e, generator=g).to(cuda)
    w = (torch.randn(3 * e, e, generator=g) * e ** -0.5).to(cuda, torch.bfloat16)
    sizes = torch.ones(b, n, device=cuda)
    for step in merge_schedule(n, 12, r) + [0]:
        t = x.shape[1]
        qkv = F.linear(F.layer_norm(x, (e,)).to(torch.bfloat16), w)
        q, k, v = (y.view(b, t, h, d).transpose(1, 2) for y in qkv.split(e, dim=-1))
        assert x.is_contiguous() and all(tma_legal(y) for y in (q, k, v))
        ref = flash_attention_reference(q, k, v)
        assert not refused(*_k1_readings(ref, flash_attention(q, k, v))), t
        zero = torch.zeros_like(k[:, :, :1])
        for fk, fv in ((k[:, :, :-1], v[:, :, :-1]),
                       (torch.cat([k, k[:, :, :1].roll(-1, 0)], 2),
                        torch.cat([v, v[:, :, :1].roll(-1, 0)], 2)),
                       (torch.cat([k, zero], 2), torch.cat([v, zero], 2))):
            assert refused(*_k1_readings(ref, flash_attention_reference(q, fk, fv))), t
        if step:
            x, sizes = bipartite_merge(x, sizes, step)


def test_replica_extraction_splits_each_dispatch(cuda):
    """Two replicas of the tower on the one card: each packed 8-frame batch
    splits into two 4-frame blocks, K5 launches once per replica dispatch,
    and the embeddings equal one tower's on each block."""
    from vimoclip_tpu_torch.ops.kernels.normalize import fused_normalize
    from vimoclip_tpu_torch.ops.preprocess import clip_preprocess

    rng = np.random.default_rng(3)
    videos = {f"v{t}": rng.integers(0, 256, (t, 32, 32, 3), dtype=np.uint8) for t in (5, 11)}
    extractor = _tiny_extractor(videos, devices=["cuda:0", "cuda:0"])
    assert len(extractor.replicas) == 2
    got = {}
    before = fused_normalize.launches
    errors = extractor.extract([(k, k) for k in videos], lambda v, e: got.__setitem__(v, e))
    assert errors == {} and fused_normalize.launches == before + 2 * 2  # 16 frames
    stack = np.concatenate([videos["v5"], videos["v11"]])
    with torch.inference_mode():
        ref = torch.cat([extractor.encoder(clip_preprocess(
            torch.from_numpy(stack[i:i + 4]).to(cuda), 32, dtype=torch.bfloat16)).float()
            for i in range(0, 16, 4)]).cpu().numpy()
    np.testing.assert_array_equal(np.concatenate([got["v5"], got["v11"]]), ref)


def test_world_one_nccl_step_equals_the_single_card_step(cuda, tmp_path):
    """A TFAM step with dropout in a one-rank NCCL group (the mesh, the
    collectives, the global draws) equals the step without a process group,
    bit for bit: every collective of one rank is the identity."""
    import torch.distributed as dist

    from vimoclip_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        LoggingConfig,
        TFAMModelConfig,
        TrainingConfig,
    )
    from vimoclip_tpu_torch.data.embedding_dataset import collate_pad
    from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer

    cfg = ExperimentConfig(
        training=TrainingConfig(batch_size=4, num_workers=1, device="cuda", seed=5,
                                half_precision=True),
        logging=LoggingConfig(), data=DataConfig(num_classes=12),
        model=TFAMModelConfig(d_model=128, nhead=4, num_layers=2, dim_feedforward=256,
                              dropout=0.1, mlp_dropout=0.1, attention_impl="flash"))
    rng = np.random.default_rng(6)
    items = [{"video_id": f"v{i}",
              "embeddings": rng.standard_normal((n, 128)).astype(np.float32),
              "motion_embeddings": rng.standard_normal((n - 1, 128)).astype(np.float32),
              "labels": (rng.random(12) < 0.3).astype(np.float32)}
             for i, n in enumerate((40, 90, 64, 17))]
    batch = {k: v for k, v in collate_pad(items, bucket=32).items() if k != "video_id"}
    out = []
    for grouped in (False, True):
        if grouped:
            dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "s"), 1),
                                    rank=0, world_size=1)
        try:
            trainer = TFAMTrainer(cfg, str(tmp_path / f"l{grouped}"),
                                  str(tmp_path / f"c{grouped}"), items, items)
            assert (trainer.mesh is not None) == grouped
            loss, logits = trainer.train_step(batch)
            out.append((loss, logits, [p.grad.clone() for p in trainer.model.parameters()
                                       if p.grad is not None]))
        finally:
            if grouped:
                dist.destroy_process_group()
    (l0, z0, g0), (l1, z1, g1) = out
    assert torch.equal(l0, l1) and torch.equal(z0, z1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# ---------------------------------------------------------------------------
# global dropout offsets and the ring (sequence parallelism)
# ---------------------------------------------------------------------------


def _philox_mask(seed, rows, cols, rate):
    """The keep mask with counter (row, col // 4) computed here from
    Philox4x32-10 itself: what the kernels drew before they took offsets."""
    from vimoclip_tpu_torch.ops.kernels.flash_attention import keep_threshold, philox4x32

    r = torch.arange(rows, dtype=torch.int64).view(1, 1, rows, 1)
    g = torch.arange(cols // 4, dtype=torch.int64).view(1, 1, 1, cols // 4)
    key = (seed.cpu().to(torch.int64) & 0xFFFFFFFF)[:, :, None, None]
    words = torch.stack(torch.broadcast_tensors(*philox4x32(r, g, 0, 0, key, 0)), -1)
    return words.reshape(*words.shape[:3], cols) < keep_threshold(rate)


def _seeds(device, b=2, h=3):
    return expand_seed(torch.tensor([11, -5])[:b], b, h, device=device)


@pytest.mark.parametrize("kind, t, n", [("fwd_lse", 1024, 4), ("bwd_dqkv", 1024, 2),
                                        ("bwd_dq", 2048, 2)])
def test_offset_kernels_draw_the_whole_calls_bits(cuda, kind, t, n):
    """Each (query block, key block) of an n-way split, drawn by the kernel
    with its global offsets, holds the cut of the whole sequence's bits,
    bit for bit (K1' by its output, K2 by dv, K3 by the keep-bit buffer it
    fills for K4)."""
    from vimoclip_tpu_torch.ops.kernels.flash_attention import (
        dropout_keep_mask,
        kernel_keep_bits,
    )

    seed = _seeds(cuda)
    whole = dropout_keep_mask(seed.cpu(), t, t, 0.1)
    blk = t // n
    for qi, ki in ((0, 0), (n - 1, 0), (0, n - 1), (n - 1, n - 1)):
        got = kernel_keep_bits(kind, seed, blk, blk, 0.1, row0=qi * blk, col0=ki * blk).cpu()
        assert torch.equal(got, whole[..., qi * blk:(qi + 1) * blk, ki * blk:(ki + 1) * blk])


@pytest.mark.parametrize("kind, rows, cols", [("fwd_lse", 192, 256), ("bwd_dqkv", 128, 384),
                                              ("bwd_dq", 128, 640)])
def test_zero_offsets_draw_the_unshifted_bits(cuda, kind, rows, cols):
    """With both offsets 0 the kernels draw the bits they drew without them."""
    from vimoclip_tpu_torch.ops.kernels.flash_attention import kernel_keep_bits

    seed = _seeds(cuda)
    got = kernel_keep_bits(kind, seed, rows, cols, 0.1).cpu()
    assert torch.equal(got, _philox_mask(seed, rows, cols, 0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("tk", [256, 768], ids=["dqkv", "dq+dkv"])
def test_offset_kernels_match_plain(cuda, dtype, tk):
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa

    q, k, v, mask = _inputs(2, 3, 192, tk, 64, dtype, cuda, seed=4)
    seed = _seeds(cuda)
    at = dict(row0=320, col0=tk * 3)
    out, lse = fa.forward_lse(q, k, v, mask, seed, 0.1, **at)
    ref, ref_lse = flash_attention_reference(q, k, v, mask, 0.1, seed=seed, return_lse=True,
                                             **at)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    grad = torch.randn_like(out)
    got = fa.backward(q, k, v, mask, seed, 0.1, out, lse, grad, **at)
    want = flash_attention_backward_reference(q, k, v, mask, out, lse, grad, 0.1, seed=seed,
                                              **at)
    for a, b in zip(got, want):
        assert _rel(a, b) <= GRAD_TOL[dtype]
    base = fa.forward_lse(q, k, v, mask, seed, 0.1)[0]
    assert not torch.equal(base, out)  # the offsets move the bits
    assert torch.equal(base, fa.forward_lse(q, k, v, mask, seed, 0.1, 0, 0)[0])


@pytest.mark.parametrize("n, t", [(2, 2048), (4, 1024)])
def test_ring_matches_one_call_on_card(cuda, n, t):
    """The in-process ring over n shards in bf16 with dropout 0.1 and padded
    keys against one K1' + K3/K4 call on the whole sequence with the same
    seeds: output 1e-2, gradients 5e-3 relative L2; K1' n times a shard
    forward, the backward kernels n times a shard."""
    _ring_against_one_call(cuda, n, t, 64)


def test_ring_at_head_dim_256_matches_one_call_on_card(cuda):
    """The same at head dim 256: the wide kernels in every ring block."""
    _ring_against_one_call(cuda, 2, 1024, 256)


@pytest.mark.parametrize("strategy", ["ring", "allgather"])
def test_fully_masked_row_gets_softmax_gradients_on_card(cuda, strategy):
    """Row 0 has every key masked: ring and all-gather over 2 shards, float32
    with dropout 0.1, give plain autograd's gradients of a softmax over all
    keys with the kernels' keep mask (the one call gives Tk times them on
    that row); every row within the float32 kernels' tolerance."""
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa
    from vimoclip_tpu_torch.parallel.sequence import LocalRing, sequence_parallel_attention

    t, rate = 1024, 0.1
    q, k, v, mask = _inputs(2, 4, t, t, 64, torch.float32, cuda, seed=10)
    seed = _seeds(cuda, 2, 4)
    qs = [x.clone().requires_grad_() for x in (q, k, v)]
    got = sequence_parallel_attention(*qs, LocalRing(2), mask, strategy=strategy,
                                      dropout_rate=rate, dropout_seed=seed)
    scores = qs[0] @ qs[1].transpose(-1, -2) / 8.0 + torch.where(mask[:, None, None, :],
                                                                  -1e9, 0.0)
    keep = fa.dropout_keep_mask(seed, t, t, rate)
    want = (torch.softmax(scores, dim=-1) * keep / (1.0 - rate)) @ qs[2]
    g = torch.randn_like(want)
    assert _rel(got, want) <= TOL[torch.float32]
    for a, b in zip(torch.autograd.grad(got, qs, g), torch.autograd.grad(want, qs, g)):
        assert torch.isfinite(a).all()
        assert _rel(a, b) <= GRAD_TOL[torch.float32]
        assert b[0].abs().max().item() > 1e-4  # the masked row has a gradient


def _ring_against_one_call(cuda, n, t, d):
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa
    from vimoclip_tpu_torch.parallel.sequence import LocalRing, sequence_parallel_attention

    q, k, v, mask = _inputs(2, 4, t, t, d, torch.bfloat16, cuda, seed=9, masked_rows=())
    mask[:, t - t // n - 64:] = True  # the last block holds padding only
    seed = _seeds(cuda, 2, 4)
    qs = [x.clone().requires_grad_() for x in (q, k, v)]
    one = flash_attention(*qs, mask, 0.1, seed)
    g = torch.randn_like(one)
    want = torch.autograd.grad(one, qs, g)
    fa.reset_launch_counts()
    ring = sequence_parallel_attention(*qs, LocalRing(n), mask, dropout_rate=0.1,
                                       dropout_seed=seed)
    got = torch.autograd.grad(ring, qs, g)
    torch.cuda.synchronize()
    launches = dict(flash_attention.launches)
    assert launches[fa.launch_kind("fwd_lse", d)] == n * n
    kind = "bwd_dqkv" if t // n <= 512 else "bwd_dq"
    assert launches[fa.launch_kind(kind, d)] == n * n
    assert torch.isfinite(ring).all()
    assert (ring.float() - one.float()).abs().max().item() <= 1e-2
    for a, b in zip(got, want):
        assert ((a.float() - b.float()).norm() / b.float().norm()).item() <= 5e-3
