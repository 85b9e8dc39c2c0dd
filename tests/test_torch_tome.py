"""The port's token merging (``vimoclip_tpu_torch/ops/tome.py``) against
``vimoclip_tpu/ops/tome.py`` on the CPU: the merge step (token order,
sizes, values, ties), the schedule, and merged towers with and without
int8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimoclip_tpu.models.clip_vit import ClipVisionConfig as JConfig
from vimoclip_tpu.models.clip_vit import ClipVisionEncoder as JEncoder
from vimoclip_tpu.ops import tome as jt
from vimoclip_tpu_torch.models import convert
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
from vimoclip_tpu_torch.ops import tome

torch.set_num_threads(1)

GEOM = dict(image_size=32, patch_size=4, hidden_size=64, num_layers=4,
            num_heads=4, intermediate_size=128, projection_dim=32)  # 65 tokens
# the merged values: the same float32 one-hot products and divisions in
# both packages, summed in the BLAS's order (a few ulps)
VALUE_TOL = 1e-5


def _both(x, sizes, r):
    jx, js = jt.bipartite_merge(jnp.asarray(x), jnp.asarray(sizes), r)
    tx, ts = tome.bipartite_merge(torch.from_numpy(np.array(x, copy=True)),
                                  torch.from_numpy(sizes.copy()), r)
    return (np.asarray(jx.astype(jnp.float32)), np.asarray(js),
            tx.float().numpy(), ts.numpy())


@pytest.mark.parametrize("b,n,c,r", [(3, 13, 8, 4), (2, 50, 32, 4), (2, 197, 16, 16),
                                     (1, 9, 4, 4)])
def test_merge_matches_jax(b, n, c, r):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    sizes = rng.integers(1, 5, (b, n)).astype(np.float32)
    jx, js, tx, ts = _both(x, sizes, r)
    assert tx.shape == (b, n - r, c) and ts.shape == (b, n - r)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=VALUE_TOL)


def test_merge_ties_on_duplicated_patches_match_jax():
    """A flat image region: body tokens drawn from three ±1 vectors, whose
    cosines are exact in any summation order, so every score ties exactly.
    Distinct sizes tag each token: equal output sizes mean the same first
    maximum and the same stable ranking as JAX."""
    rng = np.random.default_rng(7)
    b, n, c, r = 2, 33, 16, 8
    patterns = rng.choice([-1.0, 1.0], size=(3, c)).astype(np.float32)
    x = patterns[rng.integers(0, 3, (b, n))]
    x[:, 0] = rng.normal(size=(b, c))
    sizes = np.tile(np.arange(1, n + 1, dtype=np.float32), (b, 1))
    jx, js, tx, ts = _both(x, sizes, r)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=VALUE_TOL)


def test_merge_in_bfloat16_scores_in_float32():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 50, 32)).astype(np.float32)
    sizes = np.ones((2, 50), np.float32)
    jx, js = jt.bipartite_merge(jnp.asarray(x, jnp.bfloat16), jnp.asarray(sizes), 4)
    tx, ts = tome.bipartite_merge(torch.from_numpy(x).to(torch.bfloat16),
                                  torch.from_numpy(sizes), 4)
    assert tx.dtype == torch.bfloat16 and ts.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tx.float().numpy(), np.asarray(jx.astype(jnp.float32)),
                               rtol=2 ** -8, atol=0)


def test_chained_merges_carry_sizes_like_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 17, 6)).astype(np.float32)
    s = np.ones((2, 17), np.float32)
    jx, js = jt.bipartite_merge(*jt.bipartite_merge(jnp.asarray(x), jnp.asarray(s), 5), 3)
    tx, ts = tome.bipartite_merge(*tome.bipartite_merge(torch.from_numpy(x),
                                                        torch.from_numpy(s), 5), 3)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=VALUE_TOL)


def test_merge_conserves_mass_protects_cls_and_checks_r():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 11, 4)).astype(np.float32))
    s = torch.ones(2, 11)
    gx, gs = tome.bipartite_merge(x, s, 3)
    assert torch.allclose(gs.sum(-1), torch.full((2,), 11.0))
    assert torch.allclose((gx * gs[..., None]).sum(1), x.sum(1), atol=1e-5)
    assert torch.equal(gx[:, 0], x[:, 0])
    same_x, same_s = tome.bipartite_merge(x, s, 0)
    assert same_x is x and same_s is s
    with pytest.raises(ValueError, match="merge candidates"):
        tome.bipartite_merge(x[:, :9], s[:, :9], 5)  # (9 - 1) // 2 = 4 candidates


def test_merge_plan_is_the_step_and_replays_elsewhere():
    """``merge_plan`` is the matching ``bipartite_merge`` applies: handed
    back, the step is unchanged; taken from other values, it applies their
    merges (the sizes follow the plan alone)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 33, 8)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(2, 33, 8)).astype(np.float32))
    s = torch.from_numpy(rng.integers(1, 5, (2, 33)).astype(np.float32))
    for got, want in zip(tome.bipartite_merge(x, s, 6, plan=tome.merge_plan(x, 6)),
                         tome.bipartite_merge(x, s, 6)):
        assert torch.equal(got, want)
    _, ys = tome.bipartite_merge(y, s, 6)
    _, xs = tome.bipartite_merge(x, s, 6, plan=tome.merge_plan(y, 6))
    assert torch.equal(xs, ys) and not torch.equal(xs, tome.bipartite_merge(x, s, 6)[1])


@pytest.mark.parametrize("n,layers,r", [(197, 12, 16), (50, 12, 4), (50, 12, 8),
                                        (10, 4, 16), (65, 4, 8), (17, 2, 2)])
def test_schedule_matches_jax(n, layers, r):
    assert tome.merge_schedule(n, layers, r) == jt.merge_schedule(n, layers, r)


def test_schedules_of_the_two_towers():
    """The token counts K1 sees under ToMe: the teacher at r = 16 and the
    student at r = 4 (down to 8, below one 64-row tile)."""
    def counts(n, r):
        out = [n]
        for step in tome.merge_schedule(n, 12, r):
            out.append(out[-1] - step)
        return out

    assert counts(197, 16) == [197, 181, 165, 149, 133, 117, 101, 85, 69, 53, 37, 21]
    assert counts(50, 4) == [50, 46, 42, 38, 34, 30, 26, 22, 18, 14, 10, 8]


@pytest.fixture(scope="module")
def tower_params():
    return jax.jit(JEncoder(JConfig(**GEOM)).init)(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]


def _jax_tower(cfg, params, pixels, **kw):
    return jax.jit(lambda p, x: JEncoder(cfg).apply({"params": p}, x, **kw))(params, pixels)


@pytest.mark.parametrize("quant", [None, "int8"], ids=["tome", "int8+tome"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_merged_tower_matches_jax(tower_params, impl, quant):
    """A tower merging 8 tokens a block (65 -> 41 tokens) in float32 within
    1e-4 of JAX's, with and without int8."""
    pixels = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jcfg = JConfig(**GEOM, token_merge_r=8, matmul_quant=quant)
    ref, ref_hidden = _jax_tower(jcfg, tower_params, pixels, return_hidden=True)
    cfg = ClipVisionConfig(**GEOM, token_merge_r=8, matmul_quant=quant,
                           attention_impl=impl)
    enc = ClipVisionEncoder(cfg).eval()
    enc.load_state_dict(convert.to_tensors(
        convert.clip_vision_state_from_jax(tower_params, cfg, prefix="")), strict=True)
    with torch.no_grad():
        got, hidden = enc(torch.from_numpy(pixels), return_hidden=True)
    assert hidden.shape == (2, 41, 64)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(ref_hidden), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    exact = np.asarray(_jax_tower(JConfig(**GEOM), tower_params, pixels))
    assert not np.allclose(got.numpy(), exact, atol=1e-4)


def test_tower_replays_recorded_merges(tower_params):
    """The merges one tower run chose, recorded through ``merge_plan`` and
    handed back through ``bipartite_merge(plan=...)``: the same run again
    bit for bit, and the K1 path (its plain version here) on the same merges
    within 1e-5 (how the card holds K1 to eager attention in bf16)."""
    from vimoclip_tpu_torch.models import clip_vit

    pixels = torch.from_numpy(
        np.random.default_rng(6).standard_normal((2, 32, 32, 3)).astype(np.float32))
    plans, out = [], {}

    def record(x, sizes, step):
        plans.append(tome.merge_plan(x, step))
        return tome.bipartite_merge(x, sizes, step, plan=plans[-1])

    def tower(impl):
        cfg = ClipVisionConfig(**GEOM, token_merge_r=8, attention_impl=impl)
        enc = ClipVisionEncoder(cfg).eval()
        enc.load_state_dict(convert.to_tensors(
            convert.clip_vision_state_from_jax(tower_params, cfg, prefix="")), strict=True)
        with torch.no_grad():
            return enc(pixels)

    plain = tower("xla")
    try:
        clip_vit.bipartite_merge = record
        out["record"] = tower("xla")
        for impl in ("xla", "flash"):
            replay = iter(plans)
            clip_vit.bipartite_merge = (lambda x, sizes, step, replay=replay:
                                        tome.bipartite_merge(x, sizes, step, plan=next(replay)))
            out[impl] = tower(impl)
            assert next(replay, None) is None
    finally:
        clip_vit.bipartite_merge = tome.bipartite_merge
    assert len(plans) == 3
    assert torch.equal(out["record"], plain) and torch.equal(out["xla"], plain)
    torch.testing.assert_close(out["flash"], plain, atol=1e-5, rtol=0)
