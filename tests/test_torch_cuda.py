"""The port's CUDA kernel against its plain PyTorch version, on the card.

Run on a machine with an NVIDIA H100:  python -m pytest -m cuda tests/test_torch_cuda.py
Without a card every test here skips (decided inside the fixture)."""

import numpy as np
import pytest
import torch

from vimoclip_tpu_torch.ops.attention import MultiHeadAttention
from vimoclip_tpu_torch.ops.kernels.flash_attention import (
    flash_attention,
    flash_attention_reference,
)

pytestmark = pytest.mark.cuda

# f32: the kernel and the reference sum in different orders -> ~1e-6.
# bf16: p is rounded to bf16 relative to the running max in the kernel and
# to the final max in the reference, and the output is bf16 (rel. 2^-8).
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [
    (3, 8, 384, 384, 64), (3, 8, 384, 256, 64), (3, 8, 384, 299, 64),
    (3, 8, 2048, 2048, 64), (2, 2, 130, 77, 16), (2, 2, 70, 200, 128),
    (1, 3, 65, 65, 80), (2, 2, 33, 47, 20),
], ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_reference(cuda, shape, dtype):
    q, k, v, mask = _inputs(*shape, dtype, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, key_padding_mask=mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
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
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, dropout_rate=0.1, dropout_seed=1)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    big = torch.randn(1, 1, 8, 160, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(big, big, big)


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
