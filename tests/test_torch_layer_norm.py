"""The fused residual add + LayerNorm + cast between the vision towers'
GEMMs (``ops/kernels/layer_norm.py``) on the CPU: its plain version is the
eager composition it replaces, bit for bit; the towers that carry a pending
residual from block to block give what the per-block eager order gave, in
float32 and bf16, with int8 linears and with ToMe merges; training on the
CPU keeps PyTorch's math and gradients; the kernel's route where autograd
records (``_AddLayerNorm``: the kernel forward, PyTorch's LayerNorm backward
on its mean and rstd) gives the plain version's gradients, with a PyTorch
stand-in for the launch; no CPU call counts a launch. The kernel itself is
held to the plain version on the card (``tests/test_torch_cuda.py``)."""

import dataclasses

import pytest
import torch

from vimoclip_tpu_torch.models import clip_vit, siglip_vit
from vimoclip_tpu_torch.models.clip_vit import (
    ClipVisionConfig,
    ClipVisionEncoder,
    layer_norm,
    norm_dtype,
)
from vimoclip_tpu_torch.models.siglip_vit import SiglipVisionConfig, SiglipVisionEncoder
from vimoclip_tpu_torch.ops import attention
from vimoclip_tpu_torch.ops.attention import dense
from vimoclip_tpu_torch.ops.kernels import layer_norm as fused
from vimoclip_tpu_torch.ops.kernels.layer_norm import add_layer_norm, add_layer_norm_reference
from vimoclip_tpu_torch.ops.tome import bipartite_merge, merge_schedule

torch.set_num_threads(1)

CLIP = ClipVisionConfig(image_size=32, patch_size=8, hidden_size=32, num_layers=3,
                        num_heads=2, intermediate_size=64, projection_dim=16)
SIGLIP = SiglipVisionConfig(image_size=28, patch_size=14, hidden_size=32, num_layers=3,
                            num_heads=2, intermediate_size=48)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _ln(hidden=36, seed=0):
    g = torch.Generator().manual_seed(seed)
    ln = torch.nn.LayerNorm(hidden, eps=1e-6)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.1 * torch.randn(hidden, generator=g))
        ln.bias.copy_(0.1 * torch.randn(hidden, generator=g))
    return ln


def _tower(cfg, dtype, seed=0):
    """A tiny tower of ``cfg``'s kind in ``dtype``, every weight drawn from
    ``seed`` (LayerNorms off their 1 / 0 init)."""
    g = torch.Generator().manual_seed(seed)
    kind = SiglipVisionEncoder if isinstance(cfg, SiglipVisionConfig) else ClipVisionEncoder
    tower = kind(cfg, dtype).eval()
    with torch.no_grad():
        for p in tower.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g) + (p.ndim == 1) * 0.5)
    return tower


def _pixels(cfg, n=3, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, cfg.image_size, cfg.image_size, 3, generator=g)


def _clip_eager(enc, pixels, return_hidden=False):
    """``ClipVisionEncoder.forward`` in the per-block eager order the
    towers ran before the pending residual: x + attn(LN(x)), then
    x + MLP(LN(x)), each LayerNorm float32 into the linear's own cast."""
    cfg, dt = enc.config, enc.dtype
    b = pixels.shape[0]
    cls = enc.class_embedding.to(dt).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, enc.patchify(pixels)], dim=1) + enc.positional_embedding.to(dt)
    x = layer_norm(x, enc.ln_pre)
    schedule, sizes = [0] * (cfg.num_layers - 1), None
    if cfg.token_merge_r:
        schedule = merge_schedule(cfg.num_patches + 1, cfg.num_layers, cfg.token_merge_r)
        sizes = torch.ones(x.shape[:2], dtype=torch.float32)
    for i, blk in enumerate(enc.transformer.resblocks):
        x = x + blk.attn(layer_norm(x, blk.ln_1))
        h = dense(layer_norm(x, blk.ln_2), blk.mlp.c_fc, dt)
        x = x + dense(blk.act(h), blk.mlp.c_proj, dt)
        if i < cfg.num_layers - 1 and schedule[i]:
            x, sizes = bipartite_merge(x, sizes, schedule[i])
    embeds = layer_norm(x[:, 0, :], enc.ln_post).to(dt) @ enc.proj.to(dt)
    return (embeds, x) if return_hidden else embeds


def _siglip_eager(enc, pixels):
    """``SiglipVisionEncoder.forward`` in the per-block eager order."""
    x = enc.patchify(pixels).float() + enc.embeddings.position_embedding.weight.float()
    for blk in enc.encoder.layers:
        x = x + blk.self_attn(layer_norm(x, blk.layer_norm1))
        x = x + blk.mlp.run(layer_norm(x, blk.layer_norm2), blk.dtype)
    return enc.head(layer_norm(x, enc.post_layernorm)).to(enc.dtype)


@pytest.mark.parametrize("delta", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_plain_version_is_the_eager_composition(delta, out):
    g = torch.Generator().manual_seed(3)
    x = 3 * torch.randn(5, 7, 36, generator=g) + 1
    d = None if delta is None else torch.randn(5, 7, 36, generator=g).to(DTYPES[delta])
    ln = _ln()
    want_x = x if d is None else x + d
    want_h = layer_norm(want_x, ln).to(DTYPES[out])
    before = add_layer_norm.launches
    for fn in (add_layer_norm_reference, add_layer_norm):
        got_x, got_h = fn(x, d, ln, DTYPES[out])
        assert got_x.dtype == torch.float32 and got_h.dtype == DTYPES[out]
        assert torch.equal(got_x, want_x) and torch.equal(got_h, want_h)
    assert add_layer_norm.launches == before
    if d is None:
        assert add_layer_norm(x, None, ln, DTYPES[out])[0] is x


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("merge", [0, 2], ids=["no_merge", "tome"])
def test_clip_tower_equals_the_per_block_eager_order(quant, dtype, merge):
    cfg = dataclasses.replace(CLIP, matmul_quant=quant, token_merge_r=merge)
    enc = _tower(cfg, DTYPES[dtype])
    pixels = _pixels(cfg)
    before = add_layer_norm.launches
    with torch.no_grad():
        got, hidden = enc(pixels, return_hidden=True)
        want, want_hidden = _clip_eager(enc, pixels, return_hidden=True)
    assert add_layer_norm.launches == before
    if merge:
        assert hidden.shape[1] < cfg.num_patches + 1
    assert torch.equal(got, want) and torch.equal(hidden, want_hidden)


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_siglip_tower_equals_the_per_block_eager_order(quant, dtype):
    cfg = dataclasses.replace(SIGLIP, matmul_quant=quant)
    enc = _tower(cfg, DTYPES[dtype])
    pixels = _pixels(cfg)
    before = add_layer_norm.launches
    with torch.no_grad():
        got = enc(pixels)
        want = _siglip_eager(enc, pixels)
    assert add_layer_norm.launches == before
    assert torch.equal(got, want)


@pytest.mark.parametrize("cfg", [CLIP, SIGLIP], ids=["clip", "siglip"])
def test_training_keeps_the_plain_math_and_gradients(cfg):
    """Under autograd the plain version runs: the student's loss and every
    parameter's gradient equal the per-block eager order's, bit for bit."""
    eager = _clip_eager if cfg is CLIP else _siglip_eager
    grads = []
    for fn in (lambda enc, px: enc(px), eager):
        enc = _tower(cfg, torch.bfloat16).train()
        before = add_layer_norm.launches
        fn(enc, _pixels(cfg)).float().square().sum().backward()
        assert add_layer_norm.launches == before
        grads.append({n: p.grad for n, p in enc.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for name, g in grads[0].items():
        assert g is not None and torch.isfinite(g).all(), name
        assert torch.equal(g, grads[1][name]), name


def test_recording_autograd_takes_the_plain_version_off_the_cpu():
    """The route, autograd recording or not: CPU tensors take the plain
    version, CUDA ones the kernel (through ``_AddLayerNorm`` where autograd
    records), and a device that is neither is refused: off the CPU no call
    falls back to the plain version."""
    ln = _ln().to("meta")
    x = torch.empty(4, 36, device="meta", requires_grad=True)
    before = add_layer_norm.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        add_layer_norm(x, None, ln, torch.bfloat16)
    with torch.no_grad(), pytest.raises(ValueError, match="cuda or cpu"):
        add_layer_norm(x, None, ln, torch.bfloat16)
    assert add_layer_norm.launches == before
    x = torch.randn(4, 36, requires_grad=True)
    out_x, h = add_layer_norm(x, None, _ln(), torch.bfloat16)
    assert out_x is x and h.dtype == torch.bfloat16 and h.requires_grad
    assert add_layer_norm.launches == before


def _stand_in_launch(calls):
    """``layer_norm._launch`` in PyTorch on the CPU: the kernel's arithmetic
    (one float32 add, the mean, the centred variance, rsqrt), recording the
    ``stats`` flag of each call in ``calls``."""
    def launch(x, delta, weight, bias, eps, out_dtype, stats=False):
        calls.append(stats)
        x_out = x if delta is None else x + delta
        mean = x_out.mean(-1, keepdim=True)
        rstd = torch.rsqrt((x_out - mean).square().mean(-1, keepdim=True) + eps)
        h = torch.addcmul(bias, (x_out - mean) * rstd, weight).to(out_dtype)
        return x_out, h, (mean if stats else None), (rstd if stats else None)
    return launch


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("delta", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_kernel_route_under_autograd_gives_the_plain_gradients(monkeypatch, delta, out):
    """Where autograd records, the kernel's route asks the launch for each
    row's mean and rstd and backs through PyTorch's LayerNorm backward on
    them: x, delta, weight and bias get the plain version's gradients, to
    the order of the sums; without autograd no statistics are asked for."""
    calls = []
    monkeypatch.setattr(fused, "_launch", _stand_in_launch(calls))
    g = torch.Generator().manual_seed(5)
    ln = _ln()
    x = (3 * torch.randn(5, 7, 36, generator=g) + 1).requires_grad_()
    d = None if delta is None else (
        torch.randn(5, 7, 36, generator=g).to(DTYPES[delta]).requires_grad_())
    gx, gh = torch.randn(2, 5, 7, 36, generator=g)
    got = []
    for fn in (fused._kernel, add_layer_norm_reference):
        for t in (x, d, ln.weight, ln.bias):
            if t is not None:
                t.grad = None
        x_out, h = fn(x, d, ln, DTYPES[out])
        assert h.dtype == DTYPES[out] and (d is not None or x_out is x)
        ((x_out * gx).sum() + (h.float() * gh).sum()).backward()
        got.append([h] + [t.grad for t in (x, d, ln.weight, ln.bias) if t is not None])
    assert calls == [True]
    for a, b in zip(*got):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _rel(a, b) <= 1e-6
    with torch.no_grad():
        fused._kernel(x, d, ln, DTYPES[out])
    assert calls == [True, False]


@pytest.mark.parametrize("cfg", [CLIP, SIGLIP], ids=["clip", "siglip"])
def test_towers_train_through_the_kernel_route(monkeypatch, cfg):
    """The student's case on the card, with the stand-in launch: a float32
    tower trained through ``_AddLayerNorm`` at every LayerNorm it fuses
    gives the per-block eager order's loss and gradients, to the order of
    the LayerNorms' sums."""
    calls = []
    monkeypatch.setattr(fused, "_launch", _stand_in_launch(calls))
    module, eager = (clip_vit, _clip_eager) if cfg is CLIP else (siglip_vit, _siglip_eager)
    monkeypatch.setattr(module, "add_layer_norm", fused._kernel)
    got = []
    for fn in (lambda enc, px: enc(px), eager):
        enc = _tower(cfg, torch.float32).train()
        loss = fn(enc, _pixels(cfg)).float().square().sum()
        loss.backward()
        got.append((loss.detach(), {n: p.grad for n, p in enc.named_parameters()}))
    assert calls == [True] * (2 * cfg.num_layers + (cfg is SIGLIP))
    assert _rel(got[0][0], got[1][0]) <= 1e-6
    assert got[0][1].keys() == got[1][1].keys()
    for name, grad in got[0][1].items():
        assert _rel(grad, got[1][1][name]) <= 1e-5, name


@pytest.mark.parametrize("kind", ["clip", "siglip"])
@pytest.mark.parametrize("quant", [None, "int8"])
def test_layer_norms_write_what_the_next_linear_takes(monkeypatch, kind, quant):
    """A bf16 tower's LayerNorms hand the first attention projection and
    the first MLP linear of each block bf16 rows; with int8 linears, which
    quantise their input as it comes, float32 rows."""
    cfg = dataclasses.replace(CLIP if kind == "clip" else SIGLIP, matmul_quant=quant)
    enc = _tower(cfg, torch.bfloat16)
    seen = []  # (in features, out features, input dtype) of every linear

    def spy(real):
        def linear(x, w, *args):
            seen.append((w.shape[1], w.shape[0], x.dtype))
            return real(x, w, *args)
        return linear

    monkeypatch.setattr(attention.F, "linear", spy(attention.F.linear))
    monkeypatch.setattr(attention, "int8_linear", spy(attention.int8_linear))
    with torch.no_grad():
        enc(_pixels(cfg))
    e = cfg.hidden_size
    want = torch.float32 if quant else torch.bfloat16
    assert norm_dtype(quant, torch.bfloat16) == want
    # in each block the packed q/k/v projection (3E rows) and the MLP's
    # first linear (intermediate rows) read the LayerNorms' rows, E wide;
    # SigLIP's head (plain linears) comes after the blocks
    normed = [dt for k, n, dt in seen if k == e and n in (3 * e, cfg.intermediate_size)]
    assert normed[:2 * cfg.num_layers] == [want] * (2 * cfg.num_layers)


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    ln = _ln(36)
    x = torch.randn(4, 36)
    bad = [
        (torch.randn(4, 35), None, _ln(35), torch.bfloat16, ValueError, "multiple of 4"),
        (torch.randn(4, 2052), None, _ln(2052), torch.bfloat16, ValueError, "multiple of 4"),
        (x, None, _ln(32), torch.bfloat16, ValueError, "normalized_shape"),
        (x.bfloat16(), None, ln, torch.bfloat16, TypeError, "float32 residual"),
        (x, None, ln, torch.float16, TypeError, "float32 or bfloat16"),
        (x, torch.randn(4, 36).half(), ln, torch.bfloat16, ValueError, "same shape"),
        (x, torch.randn(2, 36), ln, torch.bfloat16, ValueError, "same shape"),
        (torch.randn(36, 4).t(), None, ln, torch.bfloat16, ValueError, "contiguous"),
        (x, torch.randn(36, 4).t(), ln, torch.bfloat16, ValueError, "contiguous"),
    ]
    before = add_layer_norm.launches
    for x_, d, ln_, out, exc, match in bad:
        with pytest.raises(exc, match=match):
            fused._launch(x_, d, ln_.weight, ln_.bias, ln_.eps, out)
    assert add_layer_norm.launches == before
