"""The port's dropout against the JAX package's, on the CPU: the 8-bit-mask
dropout's quantised keep probability and exact rescale, the Bernoulli head
dropout, and attention dropout on the eager and flash paths drawing the same
Philox mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimoclip_tpu.ops.dropout import thin_dropout as jax_thin_dropout
from vimoclip_tpu_torch.ops.attention import MultiHeadAttention
from vimoclip_tpu_torch.ops.dropout import Dropout, bernoulli_dropout, thin_dropout

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_thin_dropout_quantisation_and_rescale_match_jax(rate, dtype):
    x = np.random.default_rng(0).uniform(0.5, 2.0, (64, 257)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    theirs = np.asarray(jax_thin_dropout(jnp.asarray(x, jd), rate,
                                         jax.random.key(1)).astype(jnp.float32))
    ours = thin_dropout(torch.from_numpy(x).to(td), rate, torch.Generator().manual_seed(1))
    assert ours.dtype == td
    ours = ours.float().numpy()
    keep_prob = round((1 - rate) * 256) / 256
    # kept values are x / keep_prob rounded to the dtype, in both packages
    scaled = (torch.from_numpy(x).to(td) / torch.tensor(keep_prob, dtype=td)).float().numpy()
    for out in (ours, theirs):
        kept = out != 0
        np.testing.assert_array_equal(out[kept], scaled[kept])
        frac = kept.mean()
        assert abs(frac - keep_prob) <= 5 * (keep_prob * (1 - keep_prob) / x.size) ** 0.5


@pytest.mark.parametrize("rate, expect", [(0.0, "same"), (0.001, "same"), (0.999, "zeros")])
def test_thin_dropout_edges_match_jax(rate, expect):
    x = np.arange(1.0, 13.0, dtype=np.float32).reshape(3, 4)
    theirs = np.asarray(jax_thin_dropout(jnp.asarray(x), rate, jax.random.key(0)))
    ours = thin_dropout(torch.from_numpy(x), rate, torch.Generator()).numpy()
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, x if expect == "same" else np.zeros_like(x))
    with pytest.raises(ValueError):
        thin_dropout(torch.from_numpy(x), 1.5, torch.Generator())


def test_dropout_module_and_bernoulli_dropout():
    x = torch.ones(200, 300)
    drop = Dropout(0.2)
    assert torch.equal(drop.eval()(x), x)
    with pytest.raises(ValueError, match="generator"):
        drop.train()(x)
    y = bernoulli_dropout(x, 0.2, torch.Generator().manual_seed(3))
    kept = y != 0
    assert torch.allclose(y[kept], torch.tensor(1 / 0.8))
    assert abs(kept.float().mean().item() - 0.8) < 5 * (0.16 / x.numel()) ** 0.5
    assert torch.equal(bernoulli_dropout(x, 0.0, torch.Generator()), x)


def test_attention_dropout_same_on_eager_and_flash_paths():
    """With dropout on, both paths draw one seed per (row, head) from the
    generator and drop where the kernels' Philox bits say: their outputs and
    gradients agree to rounding."""
    torch.manual_seed(0)
    mha = MultiHeadAttention(32, 4, dropout=0.3).train()
    x = torch.randn(2, 20, 32)
    kv = torch.randn(2, 17, 32)
    mask = torch.rand(2, 17) < 0.3
    outs, grads = [], []
    for impl in ("xla", "flash"):
        mha.implementation = impl
        mha.zero_grad()
        out = mha(x, kv=kv, key_padding_mask=mask, generator=torch.Generator().manual_seed(4))
        out.sum().backward()
        outs.append(out.detach())
        grads.append(mha.in_proj_weight.grad.clone())
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=0)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-4, rtol=1e-5)
    mha.eval()
    with torch.no_grad():
        assert not torch.allclose(mha(x, kv=kv, key_padding_mask=mask), outs[1])
    with pytest.raises(ValueError, match="generator"):
        mha.train()(x)
