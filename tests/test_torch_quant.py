"""The port's dynamic int8 matmuls (``vimoclip_tpu_torch/ops/quant.py``)
against ``vimoclip_tpu/ops/quant.py`` on the CPU: the int8 codes and scales,
the int32 sums, ``Int8Linear`` against ``Int8Dense``, the attention
projections in every ``head_proj`` mode, and a quantised tower."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from torch import nn

from vimoclip_tpu.models.clip_vit import ClipVisionConfig as JConfig
from vimoclip_tpu.models.clip_vit import ClipVisionEncoder as JEncoder
from vimoclip_tpu.ops import quant as jq
from vimoclip_tpu.ops.attention import MultiHeadAttention as JMHA
from vimoclip_tpu_torch.models import convert
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
from vimoclip_tpu_torch.ops import quant
from vimoclip_tpu_torch.ops.attention import MultiHeadAttention

torch.set_num_threads(1)

# a tower of hidden 64: 4 layers, 17 tokens
GEOM = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=4,
            num_heads=4, intermediate_size=128, projection_dim=32)
# the rescale is one float32 product of the same operands in both packages;
# 1e-6 relative leaves room for XLA fusing it with the cast
OUT_RTOL = 1e-6


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,dims", [((17, 64), -1), ((64, 24), 0), ((3, 5, 32), -1),
                                        ((2, 4, 9, 16), (1, 3))],
                         ids=["rows", "columns", "tokens", "heads"])
def test_quantize_absmax_matches_jax(shape, dims, dtype):
    """Codes equal to JAX's, element for element (0 mismatches: the same
    float32 division and round-half-to-even in both); scales within 1e-7
    relative."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 3.0
    x[(0,) * len(shape)] = 0.0
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    jqv, js = jq.quantize_absmax(jx, dims)
    tq, ts = quant.quantize_absmax(tx, dims)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == js.shape
    mismatches = int((tq.numpy() != np.asarray(jqv)).sum())
    assert mismatches == 0, f"{mismatches} codes differ from JAX's"
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)


def test_quantize_rowwise_roundtrip_bound_and_zero_rows():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(17, 64)).astype(np.float32)) * 3
    q, scale = quant.quantize_rowwise(x)
    assert scale.shape == (17, 1)
    assert ((q.float() * scale - x).abs() <= scale / 2 + 1e-7).all()
    assert q.abs().max().item() == 127
    zq, zs = quant.quantize_rowwise(torch.zeros(4, 8), dim=0)
    assert zs.shape == (1, 8) and (zq == 0).all() and torch.isfinite(zs).all()


@pytest.mark.parametrize("rows", [1, 8, 16, 17, 40])
def test_int_mm_is_the_exact_product(rows):
    rng = np.random.default_rng(rows)
    a = rng.integers(-127, 128, (rows, 96), dtype=np.int8)
    b = rng.integers(-127, 128, (24, 96), dtype=np.int8)
    got = quant.int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)
    with pytest.raises(TypeError):
        quant.int_mm(torch.from_numpy(a).float(), torch.from_numpy(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dynamic_matmul_matches_jax(dtype):
    """The int32 accumulator equal to JAX's ``dot_general``; the output
    within 1e-6 relative."""
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(5, 7, 32)).astype(np.float32), dtype)
    w = rng.normal(size=(32, 24)).astype(np.float32)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))

    jxq, _ = jq.quantize_rowwise(x, axis=-1)
    jwq, _ = jq.quantize_rowwise(jnp.asarray(w), axis=0)
    jacc = lax.dot_general(jxq, jwq, (((2,), (0,)), ((), ())),
                           preferred_element_type=jnp.int32)
    txq, _ = quant.quantize_rowwise(tx.reshape(-1, 32))
    twq, _ = quant.quantize_rowwise(torch.from_numpy(w).t(), dim=1)
    tacc = quant.int_mm(txq, twq).reshape(5, 7, 24)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))

    ref = jq.int8_dynamic_matmul(x, jnp.asarray(w))
    got = quant.int8_dynamic_matmul(tx, torch.from_numpy(w))
    assert got.dtype == getattr(torch, dtype) and got.shape == (5, 7, 24)
    assert _rel(got.float().numpy(), np.asarray(ref.astype(jnp.float32))) <= (
        OUT_RTOL if dtype == "float32" else 2 ** -8)
    with pytest.raises(ValueError, match="shape mismatch"):
        quant.int8_dynamic_matmul(torch.zeros(2, 3), torch.zeros(4, 5))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_int8_linear_matches_int8_dense(compute):
    """``Int8Linear`` (and ``dense`` on one) against ``Int8Dense`` with the
    same parameters: the bias in float32 after the rescale, then the cast."""
    from vimoclip_tpu_torch.ops.attention import dense

    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 20)).astype(np.float32)
    jd = jq.Int8Dense(12, dtype=getattr(jnp, compute))
    params = jd.init(jax.random.key(0), jnp.asarray(x))
    params = jax.tree.map(lambda p: p + 0.1, params)  # a nonzero bias
    ref = np.asarray(jd.apply(params, jnp.asarray(x)).astype(jnp.float32))

    lin = quant.Int8Linear(20, 12)
    lin.load_state_dict({"weight": torch.from_numpy(np.asarray(params["params"]["kernel"]).T.copy()),
                         "bias": torch.from_numpy(np.array(params["params"]["bias"]))},
                        strict=True)
    with torch.no_grad():
        got = dense(torch.from_numpy(x), lin, getattr(torch, compute))
        direct = lin(torch.from_numpy(x))
    assert got.dtype == getattr(torch, compute)
    assert _rel(got.float().numpy(), ref) <= OUT_RTOL
    assert _rel(direct.numpy(), ref) <= (OUT_RTOL if compute == "float32" else 2 ** -8)


def test_make_dense_switch_and_linear_layout():
    assert quant.make_dense(None) is nn.Linear
    assert quant.make_dense("none") is nn.Linear
    assert quant.make_dense("int8") is quant.Int8Linear
    with pytest.raises(ValueError, match="matmul_quant"):
        quant.make_dense("fp4")
    ref = nn.Linear(20, 12)
    q = quant.Int8Linear(20, 12)
    q.load_state_dict(ref.state_dict(), strict=True)
    x = torch.randn(6, 20, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        rel = ((q(x) - ref(x)).norm() / ref(x).norm()).item()
    assert 0 < rel < 0.03


def _mha_state(params) -> dict:
    p = params["params"]
    qkv = ("q_proj", "k_proj", "v_proj")
    return convert.to_tensors({
        "in_proj_weight": np.concatenate([np.asarray(p[n]["kernel"]).T for n in qkv]),
        "in_proj_bias": np.concatenate([np.asarray(p[n]["bias"]) for n in qkv]),
        "out_proj.weight": np.asarray(p["out_proj"]["kernel"]).T.copy(),
        "out_proj.bias": np.asarray(p["out_proj"]["bias"]),
    })


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("head_proj", ["split", "fused", "fused_qkv"])
def test_attention_int8_matches_jax(head_proj, cross):
    """Every ``head_proj`` of JAX's int8 attention against the port's one
    packed layout: the per-row scales of ``in_proj_weight`` are JAX's
    per-column scales of its q/k/v kernels."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    kv = rng.normal(size=(2, 5, 64)).astype(np.float32) if cross else None
    jm = JMHA(embed_dim=64, num_heads=4, quant="int8", head_proj=head_proj)
    params = jm.init(jax.random.key(0), jnp.asarray(x))
    params = jax.tree.map(lambda p: p + 0.01, params)
    ref = np.asarray(jm.apply(params, jnp.asarray(x),
                              None if kv is None else jnp.asarray(kv)))
    tm = MultiHeadAttention(64, 4, quant="int8", head_proj=head_proj).eval()
    tm.load_state_dict(_mha_state(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), None if kv is None else torch.from_numpy(kv))
    assert _rel(got.numpy(), ref) <= 1e-5
    exact = MultiHeadAttention(64, 4, head_proj=head_proj).eval()
    exact.load_state_dict(tm.state_dict(), strict=True)
    with torch.no_grad():
        assert not torch.allclose(exact(torch.from_numpy(x), None if kv is None
                                        else torch.from_numpy(kv)), got)


@pytest.fixture(scope="module")
def tower_params():
    return jax.jit(JEncoder(JConfig(**GEOM)).init)(
        jax.random.key(1), jnp.zeros((1, 32, 32, 3)))["params"]


def _jax_tower(cfg, params, pixels):
    return np.asarray(jax.jit(lambda p, x: JEncoder(cfg).apply({"params": p}, x))(
        params, pixels))


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_int8_tower_matches_jax(tower_params, impl):
    """A quantised tower in float32 within 1e-4 of JAX's; the patch
    embedding and ``proj`` stay float (only the blocks' linears are
    ``Int8Linear``)."""
    pixels = np.random.default_rng(5).standard_normal((3, 32, 32, 3)).astype(np.float32)
    ref = _jax_tower(JConfig(**GEOM, matmul_quant="int8"), tower_params, pixels)
    cfg = ClipVisionConfig(**GEOM, matmul_quant="int8", attention_impl=impl)
    enc = ClipVisionEncoder(cfg).eval()
    enc.load_state_dict(convert.to_tensors(
        convert.clip_vision_state_from_jax(tower_params, cfg, prefix="")), strict=True)
    kinds = {type(m) for m in enc.modules() if isinstance(m, nn.Linear)}
    assert kinds == {quant.Int8Linear}
    with torch.no_grad():
        got = enc(torch.from_numpy(pixels))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)
    exact = _jax_tower(JConfig(**GEOM), tower_params, pixels)
    assert not np.allclose(got.numpy(), exact, atol=1e-4)


def test_reference_checkpoint_loads_into_an_approximate_tower(tower_params, tmp_path):
    """A reference OpenAI-layout ``.pth`` loads with ``strict=True`` into a
    tower carrying both approximations: the parameters are nn.Linear's."""
    from vimoclip_tpu_torch.models.pretrained import load_clip_vision

    cfg = ClipVisionConfig(**GEOM)
    state = convert.to_tensors(convert.clip_vision_state_from_jax(tower_params, cfg))
    torch.save(state, tmp_path / "clip.pth")
    loaded_cfg, loaded = load_clip_vision(str(tmp_path / "clip.pth"))
    approx = dataclasses.replace(loaded_cfg, matmul_quant="int8", token_merge_r=2)
    enc = ClipVisionEncoder(approx)
    enc.load_state_dict(convert.to_tensors(loaded), strict=True)
    assert enc.state_dict().keys() == ClipVisionEncoder(loaded_cfg).state_dict().keys()
