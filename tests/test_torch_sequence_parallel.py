"""The port's sequence parallelism (``vimoclip_tpu_torch/parallel/sequence.py``)
on the CPU, against the JAX package's ``parallel/sequence.py`` on its
virtual devices and against the port's one-process paths.

- Ring and all-gather attention over n in-process shards (``LocalRing``)
  against JAX's ``sequence_parallel_attention`` on the same numpy inputs:
  outputs and gradients, key padding, a padding-only shard, data x seq,
  seq x model and the argument checks, at 1e-5 (float32); bf16 inputs at
  JAX's own 0.04.
- With dropout, the port's ring draws the bits one call on the whole
  sequence draws (global offsets): held to ``flash_attention`` with the same
  seeds at n = 2 and 4, at 1e-6; the keep fraction and the block bits.
- A fully masked row: ring and all-gather give JAX's q, k and v gradients
  (exact, by autodiff) at n = 2 and 4, and with dropout plain autograd's of
  the kernels' own keep mask, while the one call keeps the kernels' P = 1
  rule (Tk times the gradient there), as JAX's flash kernels do.
- Two gloo worlds, spawned once (two and four ranks): TFAM in all five
  fusion modes on ``attention_impl="ring"`` at seq 2 against JAX's TFAM ring
  and its ``xla`` path (2e-5); the trainer's step at seq 2 and data 2 x seq
  2, with dropout 0.1 and without, against the one-process step (loss 1e-6,
  gradients 1e-5): every mask is the one-process mask.

JAX is imported inside the tests that use it: the spawned ranks import this
module and need torch only.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vimoclip_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    LoggingConfig,
    TFAMModelConfig,
    TrainingConfig,
)
from vimoclip_tpu_torch.data.embedding_dataset import collate_pad
from vimoclip_tpu_torch.models.tfam import TFAM
from vimoclip_tpu_torch.ops.attention import MultiHeadAttention
from vimoclip_tpu_torch.ops.kernels import flash_attention as fa
from vimoclip_tpu_torch.parallel import TFAM_PARTITION_RULES, MeshConfig, create_mesh
from vimoclip_tpu_torch.parallel.mesh import Shard
from vimoclip_tpu_torch.parallel.partition import parallelize_
from vimoclip_tpu_torch.parallel.sequence import (
    LocalRing,
    ring_attention,
    sequence_parallel_attention,
)
from vimoclip_tpu_torch.train import tfam_trainer as tfam_trainer_module
from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer
from vimoclip_tpu_torch.utils.logging import SummaryWriter

torch.set_num_threads(1)

D, HEADS, LAYERS, FF, C, B = 32, 4, 2, 64, 6, 8
BUCKET = 16  # padded lengths split over seq 2 and 4 into blocks of 4k keys (dropout)
LOSS_TOL, GRAD_TOL = 1e-6, 1e-5
MODES = {"cross": dict(use_cross_attention=True),
         "rgb_only": dict(use_cross_attention=False, use_only_rgb=True),
         "flow_only": dict(use_cross_attention=False, use_only_flow=True),
         "concat_t": dict(use_cross_attention=False, concat_dim=1),
         "concat_c": dict(use_cross_attention=False, concat_dim=-1)}
# (name, world, data, seq, dropout) of the trainer's step
STEP_CASES = [("seq2", 2, 1, 2, 0.0), ("seq2_drop", 2, 1, 2, 0.1),
              ("dp2seq2", 4, 2, 2, 0.0), ("dp2seq2_drop", 4, 2, 2, 0.1),
              ("seq4_drop", 4, 1, 4, 0.1)]


def _qkv(seed, b=2, h=4, t=32, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3)]


def _ragged_mask(seed, b, t):
    """True = ignore key: random tail padding per row, >= 1 real key."""
    lengths = np.random.default_rng(seed).integers(1, t + 1, b)
    return np.arange(t)[None, :] >= lengths[:, None]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax_attention(q, k, v, mask=None, n=8, strategy="ring", dtype=None, mesh=None):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from vimoclip_tpu.parallel.sequence import sequence_parallel_attention as jsp

    mesh = mesh or Mesh(np.asarray(jax.devices()[:n]), axis_names=("seq",))
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    fn = jax.jit(lambda q, k, v: jsp(q, k, v, mesh, key_padding_mask=mask, strategy=strategy))
    return np.asarray(fn(*args), np.float32)


# ---------------------------------------------------------------------------
# ring / all-gather on in-process shards, against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["ring", "allgather"])
def test_matches_jax_and_dense(devices, strategy):
    q, k, v = _qkv(0)
    got = sequence_parallel_attention(*_t(q, k, v), LocalRing(8), strategy=strategy)
    np.testing.assert_allclose(got.numpy(), _jax_attention(q, k, v, strategy=strategy),
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), fa.flash_attention(*_t(q, k, v)).numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("strategy", ["ring", "allgather"])
def test_key_padding_matches_jax(devices, strategy):
    q, k, v = _qkv(1)
    mask = _ragged_mask(2, 2, 32)
    got = sequence_parallel_attention(*_t(q, k, v), LocalRing(8), torch.from_numpy(mask),
                                      strategy=strategy)
    np.testing.assert_allclose(got.numpy(), _jax_attention(q, k, v, mask, strategy=strategy),
                               atol=1e-5)


def test_fully_padded_shard_is_nan_free(devices):
    """Padding that spans whole shards (4-key blocks; 5 real keys leave six
    padding-only blocks, one real key seven): finite, and JAX's result."""
    q, k, v = _qkv(3)
    mask = np.arange(32)[None, :] >= np.array([5, 1])[:, None]
    got = sequence_parallel_attention(*_t(q, k, v), LocalRing(8), torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _jax_attention(q, k, v, mask), atol=1e-5)


def test_bf16_inputs(devices):
    q, k, v = _qkv(4)
    got = sequence_parallel_attention(*(t.bfloat16() for t in _t(q, k, v)), LocalRing(8))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _jax_attention(q, k, v), atol=0.04)


@pytest.mark.parametrize("strategy", ["ring", "allgather"])
def test_gradients_match_jax(devices, strategy):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from vimoclip_tpu.parallel.sequence import sequence_parallel_attention as jsp

    q, k, v = _qkv(5)
    mask = _ragged_mask(6, 2, 32)
    mesh = Mesh(np.asarray(jax.devices()[:8]), axis_names=("seq",))

    def loss(q, k, v):
        return (jsp(q, k, v, mesh, key_padding_mask=mask, strategy=strategy) ** 2).sum()

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    ts = [t.requires_grad_() for t in _t(q, k, v)]
    out = sequence_parallel_attention(*ts, LocalRing(8), torch.from_numpy(mask),
                                      strategy=strategy)
    got = torch.autograd.grad((out ** 2).sum(), ts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_ring_at_head_dim_256_matches_jax(devices):
    """Head dim 256 (the wide kernels' on the card): the ring over 2 shards
    with key padding against JAX's ``ring_attention`` on a seq-2 mesh,
    outputs and gradients at 1e-5."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from vimoclip_tpu.parallel.sequence import sequence_parallel_attention as jsp

    q, k, v = _qkv(30, b=2, h=2, t=16, d=256)
    mask = _ragged_mask(31, 2, 16)
    mesh = Mesh(np.asarray(jax.devices()[:2]), axis_names=("seq",))

    def loss(q, k, v):
        out = jsp(q, k, v, mesh, key_padding_mask=mask, strategy="ring")
        return (out ** 2).sum(), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                       has_aux=True))(
        *map(jnp.asarray, (q, k, v)))
    ts = [t.requires_grad_() for t in _t(q, k, v)]
    out = sequence_parallel_attention(*ts, LocalRing(2), torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5)
    got = torch.autograd.grad((out ** 2).sum(), ts)
    for g, w in zip(got, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_composes_with_data_axis(devices):
    """data 2 x seq 4: each data block of rows runs its own ring (and its
    rows' seeds); the joined result is JAX's on a (data 2, seq 4) mesh."""
    from vimoclip_tpu.parallel import MeshConfig as JMeshConfig
    from vimoclip_tpu.parallel import create_mesh as jcreate

    q, k, v = _qkv(7, b=4, t=24)
    mask = _ragged_mask(8, 4, 24)
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vimoclip_tpu.parallel.sequence import sequence_parallel_attention as jsp

    mesh = jcreate(JMeshConfig(data_parallel=2, seq_parallel=4))
    sh = NamedSharding(mesh, P("data", None, "seq", None))
    want = jax.jit(lambda q, k, v, m: jsp(q, k, v, mesh, key_padding_mask=m,
                                          batch_axis="data"))(
        *(jax.device_put(jnp.asarray(x), sh) for x in (q, k, v)),
        jax.device_put(jnp.asarray(mask), NamedSharding(mesh, P("data", "seq"))))
    tq, tk, tv, tm = _t(q, k, v, mask)
    got = torch.cat([sequence_parallel_attention(tq[r], tk[r], tv[r], LocalRing(4), tm[r])
                     for r in (slice(0, 2), slice(2, 4))])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_composes_with_model_axis(devices):
    """seq 4 x model 2: each model rank runs the ring on its heads; joined,
    JAX's result on a (model 2, seq 4) mesh."""
    from vimoclip_tpu.parallel import MeshConfig as JMeshConfig
    from vimoclip_tpu.parallel import create_mesh as jcreate

    q, k, v = _qkv(9, h=4, t=16)
    mask = _ragged_mask(10, 2, 16)
    mesh = jcreate(JMeshConfig(data_parallel=1, model_parallel=2, seq_parallel=4))
    want = _jax_attention(q, k, v, mask, mesh=mesh)
    tq, tk, tv, tm = _t(q, k, v, mask)
    got = torch.cat([sequence_parallel_attention(tq[:, h], tk[:, h], tv[:, h], LocalRing(4),
                                                 tm) for h in (slice(0, 2), slice(2, 4))], 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_validation_errors(devices):
    from vimoclip_tpu.parallel.sequence import sequence_parallel_attention as jsp

    q, k, v = _t(*_qkv(10, t=30))  # 30 % 8 != 0
    with pytest.raises(ValueError, match="divisible") as ours:
        sequence_parallel_attention(q, k, v, LocalRing(8))
    import jax
    from jax.sharding import Mesh

    with pytest.raises(ValueError) as theirs:
        jsp(*(x.numpy() for x in (q, k, v)), Mesh(np.asarray(jax.devices()), ("seq",)))
    assert str(ours.value) == str(theirs.value)
    q, k, v = _t(*_qkv(11))
    with pytest.raises(ValueError, match="requires dropout_seed"):
        sequence_parallel_attention(q, k, v, LocalRing(8), dropout_rate=0.1)
    with pytest.raises(ValueError, match="strategy"):
        sequence_parallel_attention(q, k, v, LocalRing(8), strategy="nope")
    with pytest.raises(ValueError, match="no 'seq' axis"):
        sequence_parallel_attention(q, k, v, None)
    with pytest.raises(ValueError, match="multiple of 4"):  # 6-key blocks with dropout
        ring_attention(list(q[..., :12, :].chunk(2, 2)), list(k[..., :12, :].chunk(2, 2)),
                       list(v[..., :12, :].chunk(2, 2)), None, LocalRing(2), 0.1, 3)
    with pytest.raises(ValueError, match="multiple of 4"):
        fa.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=1, col0=6)


# ---------------------------------------------------------------------------
# dropout at global coordinates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("strategy", ["ring", "allgather"])
def test_dropout_equals_one_call(n, strategy):
    """The ring drops what one call on the whole sequence drops with the
    same (B, H) seeds, at any n: outputs and gradients at 1e-6 (absolute
    and relative: the blocks merge in float32)."""
    q, k, v = (t.requires_grad_() for t in _t(*_qkv(20)))
    mask = torch.from_numpy(_ragged_mask(21, 2, 32))
    seeds = torch.tensor([[3, -7, 11, 5], [2**30, 9, -1, 4]], dtype=torch.int32)
    got = sequence_parallel_attention(q, k, v, LocalRing(n), mask, strategy=strategy,
                                      dropout_rate=0.3, dropout_seed=seeds)
    want = fa.flash_attention(q, k, v, mask, dropout_rate=0.3, dropout_seed=seeds)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-6,
                               rtol=1e-6)
    g = torch.randn_like(want)
    for a, b in zip(torch.autograd.grad(got, (q, k, v), g),
                    torch.autograd.grad(want, (q, k, v), g)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)
    nodrop = sequence_parallel_attention(q, k, v, LocalRing(n), mask, strategy=strategy)
    assert (got - nodrop).abs().max() > 1e-3  # it drops something


@pytest.mark.parametrize("n", [2, 4])
def test_block_bits_are_the_whole_calls(n):
    """Each (query block, key block)'s keep mask at its global offsets is the
    cut of the whole sequence's mask, bit for bit; the kept fraction is 1 - p."""
    seeds = fa.expand_seed(torch.tensor([7, 8]), 2, 3)
    whole = fa.dropout_keep_mask(seeds, 64, 96, 0.4)
    tq, tk = 64 // n, 96 // n
    for qi in range(n):
        for ki in range(n):
            block = fa.dropout_keep_mask(seeds, tq, tk, 0.4, row0=qi * tq, col0=ki * tk)
            assert torch.equal(block, whole[..., qi * tq:(qi + 1) * tq, ki * tk:(ki + 1) * tk])
    assert abs(whole.float().mean().item() - 0.6) < 0.01


def _masked_row_inputs():
    """Seed 30, (2, 4, 16, 16); batch row 1 has every key masked."""
    q, k, v = _qkv(30, t=16)
    mask = np.zeros((2, 16), bool)
    mask[1] = True
    return q, k, v, mask


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("strategy", ["ring", "allgather"])
def test_fully_masked_row_gets_jax_gradients(devices, strategy, n):
    """A row whose keys are all masked (no TFAM batch has one): the forward
    is the one call's and JAX's (uniform over all keys), and the q, k and v
    gradients equal JAX's ``sequence_parallel_attention`` on both rows,
    which autodiff makes exact. The one call keeps the kernels' P = 1 rule
    (JAX's flash kernels have it): its masked-row gradients stay Tk times
    these."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from vimoclip_tpu.parallel.sequence import sequence_parallel_attention as jsp

    q, k, v, mask = _masked_row_inputs()
    ts = [t.requires_grad_() for t in _t(q, k, v)]
    got = sequence_parallel_attention(*ts, LocalRing(n), torch.from_numpy(mask),
                                      strategy=strategy)
    one = fa.flash_attention(*ts, torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), one.detach().numpy(), atol=1e-5)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("seq",))
    np.testing.assert_allclose(got.detach().numpy(),
                               _jax_attention(q, k, v, mask, strategy=strategy, mesh=mesh),
                               atol=1e-5)
    g_got = torch.autograd.grad((got ** 2).sum(), ts)
    g_one = torch.autograd.grad((one ** 2).sum(), ts)
    loss = lambda *a: (jsp(*a, mesh, key_padding_mask=mask, strategy=strategy) ** 2).sum()
    g_jax = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    for a, b, c in zip(g_got, g_one, g_jax):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-5)
        np.testing.assert_allclose(b[0].numpy(), a[0].numpy(), atol=1e-5)
        np.testing.assert_allclose(b[1].numpy(), 16 * a[1].numpy(), atol=16e-5, rtol=1e-5)
        assert np.abs(a[1].numpy()).max() > 1e-3  # the masked row has a gradient


@pytest.mark.parametrize("strategy", ["ring", "allgather"])
def test_fully_masked_row_with_dropout_gets_softmax_gradients(strategy):
    """With dropout (p = 0.3, two shards) the bits cannot be JAX's, so the
    gradients on both rows are held to plain autograd of a softmax over all
    keys (the -1e9 bias on masked keys) that applies the kernels' keep mask
    at the global offsets with the pre-dropout denominator, at 1e-5."""
    q, k, v, mask = _masked_row_inputs()
    rate, seeds = 0.3, fa.expand_seed(torch.tensor([11, 12]), 2, 4)
    ts = [t.requires_grad_() for t in _t(q, k, v)]
    got = sequence_parallel_attention(*ts, LocalRing(2), torch.from_numpy(mask),
                                      strategy=strategy, dropout_rate=rate, dropout_seed=seeds)
    keep = fa.dropout_keep_mask(seeds, 16, 16, rate)
    scores = ts[0] @ ts[1].transpose(-1, -2) / 4.0
    scores = scores + torch.where(torch.from_numpy(mask)[:, None, None, :], -1e9, 0.0)
    want = (torch.softmax(scores, dim=-1) * keep / (1.0 - rate)) @ ts[2]
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-5)
    g = torch.randn(want.shape, generator=torch.Generator().manual_seed(31))
    for a, b in zip(torch.autograd.grad(got, ts, g), torch.autograd.grad(want, ts, g)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
        assert np.abs(a[1].numpy()).max() > 1e-3


def test_ring_needs_a_seq_group():
    mha = MultiHeadAttention(16, 2, implementation="ring").eval()
    with pytest.raises(ValueError, match="needs a seq group"):
        mha(torch.zeros(1, 4, 16))
    mha.shard = Shard(data=2)  # a mesh without a seq axis
    with pytest.raises(ValueError, match="needs a seq group"):
        mha(torch.zeros(1, 4, 16))


def test_tfam_refuses_indivisible_time():
    model = TFAM(TFAMModelConfig(d_model=D, nhead=HEADS, num_layers=1, dim_feedforward=FF,
                                 attention_impl="ring"), num_classes=C).eval()
    model.shard = Shard(seq=2)
    x = torch.zeros(1, 5, D)
    with pytest.raises(ValueError, match="pad to a bucket first"):
        model(x, torch.zeros(1, 4, D))


# ---------------------------------------------------------------------------
# the trainer's checks (no ranks needed: they come before any collective)
# ---------------------------------------------------------------------------


class _Mesh:
    """A stand-in for a ``DeviceMesh``, for the checks that read its shape."""

    def __init__(self, **dims):
        self.mesh_dim_names = tuple(dims)
        self.shape = tuple(dims.values())

    def size(self, i=None):
        return self.shape[i]


def config(data=-1, seq=1, pipe=1, dropout=0.0, impl="flash", bucket=BUCKET, accum=1,
           micro=None, max_len=None, **model) -> ExperimentConfig:
    return ExperimentConfig(
        training=TrainingConfig(batch_size=B, num_workers=1, lr=1e-3, device="cpu", seed=7,
                                data_parallel=data, seq_parallel=seq,
                                pipeline_parallel=pipe, pipeline_microbatches=micro,
                                grad_accum=accum),
        logging=LoggingConfig(),
        data=DataConfig(num_classes=C, length_bucket=bucket, max_seq_len=max_len),
        model=TFAMModelConfig(d_model=D, nhead=HEADS, num_layers=LAYERS, dim_feedforward=FF,
                              dropout=dropout, mlp_dropout=dropout, attention_impl=impl,
                              **model))


@pytest.mark.parametrize("cfg, mesh, words", [
    (config(pipe=2, use_cross_attention=False), None, "requires the cross-attention"),
    (config(seq=2), _Mesh(data=1, model=1), "has no 'seq' axis"),
    (config(pipe=2), _Mesh(data=1, model=1), "has no 'pipe' axis"),
    (config(seq=2, bucket=3), _Mesh(data=1, model=1, seq=2), "length_bucket"),
    (config(seq=2, max_len=31), _Mesh(data=1, model=1, seq=2), "max_seq_len"),
    (config(data=2, pipe=2, micro=8), _Mesh(data=2, pipe=2, model=1), "GPipe microbatches"),
])
def test_trainer_refuses_as_jax(tmp_path, cfg, mesh, words):
    with pytest.raises(ValueError, match=words):
        TFAMTrainer(cfg, str(tmp_path / "l"), str(tmp_path / "c"), train_dataset=[],
                    val_dataset=[], mesh=mesh)


def test_lone_process_is_told_the_ranks(tmp_path):
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4 -m "):
        TFAMTrainer(config(seq=2, pipe=2), str(tmp_path / "l"), str(tmp_path / "c"),
                    train_dataset=[], val_dataset=[])


# ---------------------------------------------------------------------------
# gloo worlds
# ---------------------------------------------------------------------------


def mode_inputs(mode: str):
    """JAX's TestTFAMRing inputs at the test's width: lengths per mode so the
    post-mode length splits over seq 2."""
    t = 17 if mode == "concat_c" else 16
    rng = np.random.default_rng(42)
    rgb = rng.standard_normal((2, t, D)).astype(np.float32)
    motion = rng.standard_normal((2, t, D)).astype(np.float32)
    lengths = np.array([t - 3, t // 2])
    mask_rgb = np.arange(t)[None, :] < lengths[:, None]
    mask_flow = np.arange(t)[None, :] < (lengths - 1)[:, None]
    if mode == "concat_t":
        rgb, mask_rgb = rgb[:, :-7], mask_rgb[:, :-7]
    return rgb, motion, mask_rgb, mask_flow


def mode_config(mode: str, impl: str) -> TFAMModelConfig:
    return TFAMModelConfig(d_model=D, nhead=HEADS, num_layers=LAYERS, dim_feedforward=FF,
                           dropout=0.0, mlp_dropout=0.0, attention_impl=impl, **MODES[mode])


def jax_mode_model(mode: str, impl: str = "xla", mesh=None):
    from vimoclip_tpu.config import TFAMModelConfig as JConfig
    from vimoclip_tpu.models.tfam import TFAM as JTFAM

    cfg = JConfig(d_model=D, nhead=HEADS, num_layers=LAYERS, dim_feedforward=FF, dropout=0.0,
                  mlp_dropout=0.0, attention_impl=impl, **MODES[mode])
    return JTFAM(cfg, num_classes=C, seq_mesh=mesh)


def train_batch() -> dict:
    rng = np.random.default_rng(3)
    lengths = [13, 11, 5, 7, 6, 4, 8, 3]
    items = [{"video_id": f"v{i}",
              "embeddings": rng.standard_normal((n, D)).astype(np.float32),
              "motion_embeddings": rng.standard_normal((n - 1, D)).astype(np.float32),
              "labels": (rng.random(C) < 0.3).astype(np.float32)}
             for i, n in enumerate(lengths)]
    return {k: v for k, v in collate_pad(items, bucket=BUCKET).items() if k != "video_id"}


def trainer(cfg, where, state):
    trainer = TFAMTrainer(cfg, log_dir=os.path.join(where, "logs"),
                          checkpoint_dir=os.path.join(where, "ck"), train_dataset=[],
                          val_dataset=[])
    local = state if trainer.partition is None else trainer.partition.local_state(state)
    trainer.model.load_state_dict(local)
    return trainer


def step(cfg, where, state) -> dict:
    t = trainer(cfg, where, state)
    eval_loss, eval_logits = t.eval_step(train_batch())  # TFAMTester's path
    loss, logits = t.train_step(train_batch())
    grads = {n: p.grad.detach().clone() for n, p in t.model.named_parameters()
             if p.grad is not None}
    if t.partition is not None:
        grads = {n: t.partition.full(n, g) for n, g in grads.items()}
    return {"loss": loss.item(), "logits": logits, "grads": grads,
            "eval": (eval_loss.item(), eval_logits)}


def _rank(rank: int, world: int, store: str, out: str, states: dict) -> None:
    import sys

    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None  # its import costs seconds a rank
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        if world == 2:
            mesh = create_mesh(MeshConfig(1, 1, seq_parallel=2), "cpu")
            for mode in MODES:
                model = TFAM(mode_config(mode, "ring"), num_classes=C).eval()
                model.load_state_dict(states[mode])
                parallelize_(model, TFAM_PARTITION_RULES, mesh)
                with torch.no_grad():
                    logits = model(*_t(*mode_inputs(mode)))
                if rank == 0:
                    torch.save(logits, os.path.join(out, f"mode_{mode}.pt"))
        for name, w, data, seq, drop in STEP_CASES:
            if w == world:
                got = step(config(data, seq, dropout=drop), os.path.join(out, name),
                           states["train"])
                if rank == 0:
                    torch.save(got, os.path.join(out, f"{name}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def states():
    """JAX's initial TFAM parameters per fusion mode (and the trainer's
    start), in the port's layout."""
    import jax

    from vimoclip_tpu_torch.models.convert import tfam_state_from_jax, to_tensors

    out = {}
    for mode in MODES:
        params = jax_mode_model(mode).init(jax.random.key(0), *mode_inputs(mode))["params"]
        out[mode] = to_tensors(tfam_state_from_jax(jax.device_get(params), LAYERS))
    out["train"] = out["cross"]
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, states):
    out = tmp_path_factory.mktemp("seq_worlds")
    for world in (2, 4):
        mp.spawn(_rank, args=(world, str(out / f"store{world}"), str(out), states),
                 nprocs=world, join=True)
    return out


@pytest.fixture(scope="module")
def one_process(tmp_path_factory, states):
    out = tmp_path_factory.mktemp("seq_one")
    with pytest.MonkeyPatch.context() as mpatch:  # no TensorBoard: its import is slow
        mpatch.setattr(tfam_trainer_module, "SummaryWriter", lambda log_dir: SummaryWriter(None))
        return {drop: step(config(dropout=drop), str(out / str(drop)), states["train"])
                for drop in (0.0, 0.1)}


@pytest.mark.parametrize("mode", list(MODES))
def test_tfam_ring_matches_jax_ring_and_xla(devices, worlds, states, mode):
    """Each fusion mode at seq 2 (time cut after the mode's prologue) equals
    JAX's TFAM on ``attention_impl="ring"`` over a seq mesh of 2 and its
    ``xla`` path, from the same weights."""
    import jax
    from jax.sharding import Mesh

    inputs = mode_inputs(mode)
    got = torch.load(worlds / f"mode_{mode}.pt").numpy()
    params = jax_mode_model(mode).init(jax.random.key(0), *inputs)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("seq",))
    want_ring = np.asarray(jax.jit(jax_mode_model(mode, "ring", mesh).apply)(params, *inputs))
    want_xla = np.asarray(jax.jit(jax_mode_model(mode).apply)(params, *inputs))
    np.testing.assert_allclose(got, want_ring, atol=2e-5)
    np.testing.assert_allclose(got, want_xla, atol=2e-5)


@pytest.mark.parametrize("case", [c[0] for c in STEP_CASES])
def test_seq_step_equals_one_process(worlds, one_process, case):
    drop = {c[0]: c[4] for c in STEP_CASES}[case]
    got, want = torch.load(worlds / f"{case}.pt", weights_only=False), one_process[drop]
    assert abs(got["loss"] - want["loss"]) < LOSS_TOL
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"].numpy(), atol=1e-5)
    assert abs(got["eval"][0] - want["eval"][0]) < LOSS_TOL  # eval_step, dropout off
    np.testing.assert_allclose(got["eval"][1].numpy(), want["eval"][1].numpy(), atol=1e-5)
    assert got["grads"].keys() == want["grads"].keys()
    for name, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(), atol=GRAD_TOL,
                                   rtol=0, err_msg=name)


def test_stage2_cli_trains_and_tests_under_torchrun_with_seq_and_pipe(tmp_path, monkeypatch):
    """``vimo-tfam-torch`` with ``training.parallelism: {seq: 2, pipe: 2,
    microbatches: 2}`` under ``torchrun`` on four gloo ranks: trains an
    epoch with dropout 0.1, then ``TFAMTester`` evaluates the best
    checkpoint through the same paths; rank 0 alone writes the results and
    a one-card ``best_model.pth`` that loads strictly."""
    import json
    import subprocess
    import sys

    import yaml

    from test_torch_parallel_entry import without_tensorflow
    from vimoclip_tpu.data import EmbeddingWriter

    without_tensorflow(tmp_path, monkeypatch)
    rng = np.random.default_rng(11)
    rgb, mot = str(tmp_path / "rgb.h5"), str(tmp_path / "mot.h5")
    with EmbeddingWriter(rgb, num_classes=C, embed_dim=D) as wr, \
            EmbeddingWriter(mot, embed_dim=D) as wm:
        for i in range(8):
            t = int(rng.integers(5, 15))
            wr.write_video(f"v{i}.mp4", rng.standard_normal((t, D)).astype(np.float32),
                           labels=(rng.random(C) < 0.3).astype(np.float32))
            wm.write_video(f"v{i}", rng.standard_normal((t - 1, D)).astype(np.float32))
    cfg = {"training": {"mode": "both", "seed": 3, "epochs": 1, "batch_size": 4,
                        "num_workers": 1, "device": "cpu",
                        "parallelism": {"seq": 2, "pipe": 2, "microbatches": 2}},
           "data": {"num_classes": C, "train_dataset_path": rgb, "val_dataset_path": rgb,
                    "flow_dataset_path": mot, "length_bucket": 8},
           "model": {"d_model": D, "nhead": HEADS, "num_layers": LAYERS,
                     "dim_feedforward": FF, "dropout": 0.1, "mlp_dropout": 0.1,
                     "attention_impl": "flash"}}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ["PYTHONPATH"]]),
               OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node=4", "-m", "vimoclip_tpu_torch.cli.tfam_train_eval",
                    "--config", str(path), "--run-name", "r", "--results-dir",
                    str(tmp_path / "results")], check=True, cwd=tmp_path, env=env,
                   timeout=240)
    (saved,) = (tmp_path / "results").glob("results_*.json")
    results = json.loads(saved.read_text())
    assert np.isfinite(results["metrics"]["loss"]) and len(results["videos"]) == 8
    best = tmp_path / "cfg" / "checkpoints" / "r" / "best" / "best_model.pth"
    model = TFAM(TFAMModelConfig(**cfg["model"]), num_classes=C)
    model.load_state_dict(torch.load(best, weights_only=True), strict=True)
