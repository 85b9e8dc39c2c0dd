"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA H100:  python -m pytest -m cuda tests/test_torch_cuda.py
Without a card every test here skips (decided inside the fixture)."""

import numpy as np
import pytest
import torch

from vimoclip_tpu_torch.ops.attention import MultiHeadAttention
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
], ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_reference(cuda, shape, dtype):
    q, k, v, mask = _inputs(*shape, dtype, cuda)
    before = flash_attention.launches["fwd"]
    out = flash_attention(q, k, v, key_padding_mask=mask)
    torch.cuda.synchronize()
    assert flash_attention.launches["fwd"] == before + 1
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
    big = torch.randn(1, 1, 8, 160, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(big, big, big)


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


@pytest.mark.parametrize("tk", [384, 1024], ids=["dqkv", "dq+dkv"])
def test_backward_is_deterministic(cuda, tk):
    q, k, v, mask = _inputs(4, 8, 384, tk, 64, torch.bfloat16, cuda)
    g = torch.randn(4, 8, 384, 64, device=cuda).to(torch.bfloat16)
    first, _ = _train_call(q, k, v, mask, 0.1, 9, g)
    second, _ = _train_call(q, k, v, mask, 0.1, 9, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("tq, tk", [(40, 64), (40, 299), (40, 512), (130, 299), (300, 512)],
                         ids=lambda v: str(v))
def test_single_pass_kernels_match_plain(cuda, tq, tk, d, rate):
    """bf16 K1, K1' and K2 (keys within one 512-key tile) against their plain
    versions: Tq below one tile, ragged Tk, head dims 32 (the 64-column
    kernels), 64 and 128 (two chunks)."""
    b, h = 2, 3
    q, k, v, mask = _inputs(b, h, tq, tk, d, torch.bfloat16, cuda, seed=tq + tk + d)
    g = torch.randn(b, tq, h, d, device=cuda).to(torch.bfloat16).transpose(1, 2)
    before = dict(flash_attention.launches)
    got, ref = _train_call(q, k, v, mask, rate, 77, g)
    with torch.no_grad():
        out1 = flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    after = flash_attention.launches
    assert after["fwd_lse"] == before["fwd_lse"] + 1 and after["fwd"] == before["fwd"] + 1
    assert after["bwd_dqkv"] == before["bwd_dqkv"] + 1
    assert (out1.float() - flash_attention_reference(q, k, v, mask).float()).abs().max() <= TOL[
        torch.bfloat16]
    assert (got[0].float() - ref[0].float()).abs().max().item() <= TOL[torch.bfloat16]
    for name, a, r in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
        assert torch.isfinite(a.float()).all(), name
        assert _rel(a, r) <= GRAD_TOL[torch.bfloat16], (name, _rel(a, r))


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
def test_single_pass_kernels_read_packed_heads(cuda, d, offset):
    # heads split out of a packed projection; offset 1 leaves every bf16 row
    # misaligned, so the wrapper hands the TMA kernels padded copies
    b, t, h = 2, 260, 4
    x = torch.randn(b, t, 3 * h * d + offset, device=cuda).bfloat16()[..., offset:]
    q, k, v = (y.view(b, t, h, d).transpose(1, 2) for y in x.split(h * d, -1))
    g = torch.randn(b, t, h, d, device=cuda).bfloat16().transpose(1, 2)
    got, ref = _train_call(q, k, v, None, 0.1, 21, g)
    assert (got[0].float() - ref[0].float()).abs().max().item() <= TOL[torch.bfloat16]
    for a, r in zip(got[1:], ref[1:]):
        assert _rel(a, r) <= GRAD_TOL[torch.bfloat16]


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p0.1"])
def test_single_pass_backward_fully_masked_rows(cuda, rate):
    # K2 with two batch rows whose every key is ignored: P = 1 on each key
    b, h, tq, tk, d = 4, 2, 130, 300, 64
    q, k, v, mask = _inputs(b, h, tq, tk, d, torch.bfloat16, cuda, seed=4, masked_rows=(0, 2))
    g = torch.randn(b, h, tq, d, device=cuda).bfloat16()
    got, ref = _train_call(q, k, v, mask, rate, 13, g)
    for name, a, r in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
        assert torch.isfinite(a.float()).all(), name
        assert _rel(a, r) <= GRAD_TOL[torch.bfloat16], (name, _rel(a, r))
        assert a[0].float().abs().max().item() > 0 and a[2].float().abs().max().item() > 0


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("d", [32, 128])
def test_single_pass_backward_is_deterministic(cuda, d, rate):
    q, k, v, mask = _inputs(2, 4, 200, 450, d, torch.bfloat16, cuda)
    g = torch.randn(2, 4, 200, d, device=cuda).bfloat16()
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
    eager = t < MultiHeadAttention._AUTO_FLASH_MIN_T_NODROP
    assert flash_attention.launches["fwd"] == before["fwd"] + (0 if eager else 1)


def test_auto_without_dropout_follows_the_measured_crossover(cuda):
    """``auto`` in eval mode takes K1 from the no-dropout crossover on and the
    eager path below it."""
    n = MultiHeadAttention._AUTO_FLASH_MIN_T_NODROP
    mha = MultiHeadAttention(64, 4, dropout=0.1, implementation="auto").to(cuda).eval()
    for t in sorted({max(1, n - 1), n, 2 * n}):
        before = flash_attention.launches["fwd"]
        with torch.no_grad():
            out = mha(torch.randn(2, t, 64, device=cuda))
        assert torch.isfinite(out).all()
        assert flash_attention.launches["fwd"] == before + (1 if t >= n else 0), t


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
