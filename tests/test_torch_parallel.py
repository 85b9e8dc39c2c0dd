"""The port's data and tensor parallelism (``vimoclip_tpu_torch/parallel``)
on the CPU over gloo, against the port's one-process step and the JAX
package's sharded step.

Two gloo worlds are spawned once for the module (``torch.multiprocessing``,
a ``FileStore`` under ``tmp_path``): two ranks run the TFAM step at data 2
and at model 2; four ranks run it at data 2 x model 2, and the student step
and the gathered checkpoint. Rank 0 saves each case's loss and full
(gathered) gradients; the tests compare them per case:

- against the one-process step from the same weights on the same batch:
  loss within 1e-6, gradients within 1e-5, with dropout 0.1 too (the masks
  are drawn at the global shape and cut per rank, so they are the
  one-process masks), on a batch of equal clips and on one of unequal clips
  whose longest sits in one rank's rows (the global ``batch_max``);
- the (2, 2) step against JAX's step on ``create_mesh(MeshConfig(2, 2))``
  from the same weights (``models/convert.py``): loss 1e-5, gradients rtol
  5e-4 / atol 1e-5, as ``tests/test_tfam_sharded.py``.

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
from vimoclip_tpu_torch.data.segment_dataset import collate_segments
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig
from vimoclip_tpu_torch.models.tfam import TFAM
from vimoclip_tpu_torch.parallel import (
    STUDENT_PARTITION_RULES,
    TFAM_PARTITION_RULES,
    MeshConfig,
    shard_batch,
)
from vimoclip_tpu_torch.train import student_trainer as student_trainer_module
from vimoclip_tpu_torch.train import tfam_trainer as tfam_trainer_module
from vimoclip_tpu_torch.train.student_trainer import StudentTrainer
from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer
from vimoclip_tpu_torch.utils.logging import SummaryWriter

torch.set_num_threads(1)

D, HEADS, LAYERS, FF, C, B, T = 64, 4, 2, 128, 10, 8, 12
STUDENT = ClipVisionConfig(image_size=32, patch_size=16, hidden_size=64, num_layers=2,
                           num_heads=4, intermediate_size=128, projection_dim=32)
SC, SEQ = 5, 4  # student classes, teacher frames per segment

LOSS_TOL, GRAD_TOL = 1e-6, 1e-5

# (name, world, data, model, dropout, attention, batch)
TFAM_CASES = [
    ("dp2", 2, 2, 1, 0.0, "xla", "equal"),
    ("dp2_drop", 2, 2, 1, 0.1, "xla", "equal"),
    ("dp2_unequal", 2, 2, 1, 0.0, "xla", "unequal"),
    ("tp2", 2, 1, 2, 0.0, "xla", "equal"),
    ("tp2_drop", 2, 1, 2, 0.1, "flash", "unequal"),
    ("dp2tp2", 4, 2, 2, 0.0, "xla", "equal"),
    ("dp2tp2_drop", 4, 2, 2, 0.1, "xla", "equal"),
    ("dp2tp2_drop_flash", 4, 2, 2, 0.1, "flash", "unequal"),
    ("dp2tp2_unequal", 4, 2, 2, 0.0, "xla", "unequal"),
    ("dp2tp2_accum", 4, 2, 2, 0.1, "xla", "unequal"),
]
# (name, data, model, grad_clip), all on the four-rank world
STUDENT_CASES = [("student_dp2tp2", 2, 2, None), ("student_clip", 2, 2, 1e-3)]


def tfam_config(data=-1, model=1, dropout=0.0, impl="xla", accum=1) -> ExperimentConfig:
    return ExperimentConfig(
        training=TrainingConfig(batch_size=B, num_workers=1, lr=1e-3, device="cpu", seed=7,
                                data_parallel=data, model_parallel=model,
                                grad_accum=accum),
        logging=LoggingConfig(),
        data=DataConfig(num_classes=C),
        model=TFAMModelConfig(d_model=D, nhead=HEADS, num_layers=LAYERS,
                              dim_feedforward=FF, dropout=dropout, mlp_dropout=dropout,
                              attention_impl=impl))


def tfam_batch(kind: str) -> dict:
    """B clips of T frames, or of unequal lengths with the longest (T) in
    the first two rows only: the rows data rank 0 keeps."""
    rng = np.random.default_rng(3)
    lengths = [T] * B if kind == "equal" else [T, T - 2, 5, 7, 6, 4, 8, 3]
    items = [{"video_id": f"v{i}",
              "embeddings": rng.standard_normal((n, D)).astype(np.float32),
              "motion_embeddings": rng.standard_normal((n - 1, D)).astype(np.float32),
              "labels": (rng.random(C) < 0.2).astype(np.float32)}
             for i, n in enumerate(lengths)]
    return {k: v for k, v in collate_pad(items).items() if k != "video_id"}


def jax_tfam():
    """JAX's TFAM at the test's geometry and its initial parameters."""
    import jax

    from vimoclip_tpu.config import TFAMModelConfig as JConfig
    from vimoclip_tpu.models.tfam import TFAM as JTFAM

    model = JTFAM(config=JConfig(d_model=D, nhead=HEADS, num_layers=LAYERS,
                                 dim_feedforward=FF, dropout=0.0, mlp_dropout=0.0),
                  num_classes=C)
    batch = tfam_batch("equal")
    params = model.init(jax.random.key(0), *(batch[k] for k in (
        "embeddings", "motion_embeddings", "mask_rgb", "mask_motion")))["params"]
    return model, params


@pytest.fixture(scope="module")
def weights():
    """JAX's initial TFAM parameters in the port's layout (``models/convert.py``),
    the start of every TFAM case."""
    import jax

    from vimoclip_tpu_torch.models.convert import tfam_state_from_jax, to_tensors

    model, params = jax_tfam()
    return to_tensors(tfam_state_from_jax(jax.device_get(params), LAYERS))


def student_items(n: int = 8) -> list[dict]:
    rng = np.random.default_rng(5)
    return [{"video_id": f"s{i}",
             "rgb_emb": rng.standard_normal((SEQ, STUDENT.projection_dim)).astype(np.float32),
             "motion_frames": rng.integers(0, 256, (SEQ - 1, 32, 32, 3), dtype=np.uint8),
             "labels": np.eye(SC, dtype=np.float32)[rng.integers(SC)]} for i in range(n)]


def tfam_trainer(cfg, where, state):
    items = [{"video_id": "x", "embeddings": np.zeros((2, D), np.float32),
              "motion_embeddings": np.zeros((1, D), np.float32),
              "labels": np.zeros(C, np.float32)}] * B
    trainer = TFAMTrainer(cfg, log_dir=os.path.join(where, "logs"),
                          checkpoint_dir=os.path.join(where, "ck"),
                          train_dataset=items, val_dataset=items)
    local = state if trainer.partition is None else trainer.partition.local_state(state)
    trainer.model.load_state_dict(local)
    return trainer


def student_trainer(where, data=-1, model=1, grad_clip=None):
    """The tower's weights drawn from the seed, the same on every rank."""
    items = student_items()
    return StudentTrainer(items, items, checkpoint_dir=os.path.join(where, "ck"),
                          vision_config=STUDENT, num_classes=SC,
                          lr=1e-3, batch_size=B, num_workers=1, half_precision=False,
                          device="cpu", seed=9, grad_clip=grad_clip,
                          data_parallel=data, model_parallel=model)


def full_grads(model, partition) -> dict:
    out = {}
    for name, p in model.named_parameters():
        if p.grad is not None:  # e.g. the projection a fusion mode leaves unused
            g = p.grad.detach()
            out[name] = (g if partition is None else partition.full(name, g)).clone()
    return out


def tfam_step(cfg, batch_kind, where, state) -> dict:
    trainer = tfam_trainer(cfg, where, state)
    loss, logits = trainer.train_step(tfam_batch(batch_kind))
    return {"loss": loss.item(), "logits": logits,
            "grads": full_grads(trainer.model, trainer.partition), "trainer": trainer}


def student_step(where, **kw) -> dict:
    trainer = student_trainer(where, **kw)
    vals, _ = trainer.train_step(collate_segments(student_items()))
    return {"loss": vals, "grads": full_grads(trainer.model, trainer.partition)}


def _rank(rank: int, world: int, store: str, out: str, weights: dict) -> None:
    """One rank of a gloo world: every case of this world size, in order."""
    import sys

    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None  # its import costs seconds a rank
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        for name, w, data, model, drop, impl, kind in TFAM_CASES:
            if w != world:
                continue
            accum = 2 if name.endswith("accum") else 1
            got = tfam_step(tfam_config(data, model, drop, impl, accum), kind,
                            os.path.join(out, name), weights)
            trainer = got.pop("trainer")
            if name == "dp2tp2":  # the gathered checkpoint, then a resume
                trainer.ckpt.save(trainer.state, "best")
                again = tfam_trainer(tfam_config(data, model), os.path.join(out, name),
                                     weights)
                again.ckpt.restore(again.state, "best")
                got["resumed_equal"] = all(
                    torch.equal(a, b) for a, b in zip(trainer.model.state_dict().values(),
                                                      again.model.state_dict().values()))
                got["params"] = trainer.partition.full_state(trainer.model.state_dict())
            if rank == 0:
                torch.save(got, os.path.join(out, f"{name}.pt"))
        if world == 4:
            for name, data, model, clip in STUDENT_CASES:
                got = student_step(os.path.join(out, name), data=data, model=model,
                                   grad_clip=clip)
                if rank == 0:
                    torch.save(got, os.path.join(out, f"{name}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, weights):
    """Rank 0's results of every case, by name, from the two gloo worlds."""
    out = tmp_path_factory.mktemp("worlds")
    for world in (2, 4):
        mp.spawn(_rank, args=(world, str(out / f"store{world}"), str(out), weights),
                 nprocs=world, join=True)
    names = [c[0] for c in TFAM_CASES] + [c[0] for c in STUDENT_CASES]
    return {n: torch.load(out / f"{n}.pt", weights_only=False) for n in names}, out


@pytest.fixture(scope="module")
def one_process(tmp_path_factory, weights):
    """The port's one-process steps (no process group) from the same weights."""
    out = tmp_path_factory.mktemp("one")
    results = {}
    with pytest.MonkeyPatch.context() as mpatch:  # no TensorBoard: its import is slow
        for module in (tfam_trainer_module, student_trainer_module):
            mpatch.setattr(module, "SummaryWriter", lambda log_dir: SummaryWriter(None))
        _one_process_steps(out, weights, results)
    return results


def _one_process_steps(out, weights, results):
    for name, _, _, _, drop, impl, kind in TFAM_CASES:
        accum = 2 if name.endswith("accum") else 1
        got = tfam_step(tfam_config(dropout=drop, impl=impl, accum=accum), kind,
                        str(out / name), weights)
        got.pop("trainer")
        results[name] = got
    for name, _, _, clip in STUDENT_CASES:
        results[name] = student_step(str(out / name), grad_clip=clip)


def _assert_grads(got: dict, want: dict, tol: float = GRAD_TOL) -> None:
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=tol,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("case", [c[0] for c in TFAM_CASES])
def test_tfam_step_equals_one_process(worlds, one_process, case):
    got, want = worlds[0][case], one_process[case]
    assert abs(got["loss"] - want["loss"]) < LOSS_TOL
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"].numpy(), atol=1e-5)
    _assert_grads(got["grads"], want["grads"])


@pytest.mark.parametrize("case", [c[0] for c in STUDENT_CASES])
def test_student_step_equals_one_process(worlds, one_process, case):
    """The clipped case leaves the gradients clipped at the global norm
    (taken over the model group's shards and the replicated parameters
    once): equal to the one-process clip."""
    got, want = worlds[0][case], one_process[case]
    np.testing.assert_allclose(got["loss"].numpy(), want["loss"].numpy(), atol=LOSS_TOL)
    _assert_grads(got["grads"], want["grads"])


def test_unequal_batch_pools_over_the_global_batch_max(weights):
    """The unequal batch's longest clips sit in data rank 0's rows: a rank
    pooling over its own rows' maximum would give other logits (this is why
    the sharded case above can equal the one-process step)."""
    batch = tfam_batch("unequal")
    half = {k: v[B // 2:] for k, v in batch.items()}
    assert half["mask_rgb"].sum(1).max() < batch["mask_rgb"].sum(1).max()
    torch.manual_seed(0)
    model = TFAM(tfam_config().model, num_classes=C).eval()
    model.load_state_dict(weights)
    args = lambda b: [torch.from_numpy(b[k]) for k in
                      ("embeddings", "motion_embeddings", "mask_rgb", "mask_motion")]
    with torch.no_grad():
        whole = model(*args(batch))[B // 2:]
        alone = model(*args(half))
    assert (whole - alone).abs().max() > 1e-3


def test_tfam_dp2_tp2_step_matches_jax_mesh(worlds, mesh8):
    """The four-rank step against JAX's on a (2, 2) mesh of the virtual CPU
    devices, from the same weights."""
    import jax
    import jax.numpy as jnp

    from vimoclip_tpu import losses as jax_losses
    from vimoclip_tpu.parallel import MeshConfig as JMeshConfig
    from vimoclip_tpu.parallel import TFAM_PARTITION_RULES as JRULES
    from vimoclip_tpu.parallel import batch_sharding, create_mesh, shard_params
    from vimoclip_tpu_torch.models.convert import tfam_state_from_jax, to_tensors

    model, params = jax_tfam()
    batch = tfam_batch("equal")
    arrays = [jnp.asarray(batch[k]) for k in
              ("embeddings", "motion_embeddings", "mask_rgb", "mask_motion", "labels")]

    def loss_fn(p, rgb, motion, mr, mf, y):
        logits = model.apply({"params": p}, rgb, motion, mr, mf, deterministic=True)
        return jax_losses.bce_with_logits(logits, y)

    mesh = create_mesh(JMeshConfig(2, 2), devices=jax.devices()[:4])
    sharded = shard_params(params, JRULES, mesh)
    args = [jax.device_put(a, batch_sharding(mesh)) for a in arrays]
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(sharded, *args)
    want = to_tensors(tfam_state_from_jax(jax.device_get(grads), LAYERS))
    got = worlds[0]["dp2tp2"]
    assert abs(got["loss"] - float(loss)) < 1e-5
    for name, g in want.items():
        if name in got["grads"]:
            np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(), rtol=5e-4,
                                       atol=1e-5, err_msg=name)
        else:  # a parameter the cross-attention mode leaves unused
            assert not g.abs().max(), name


def test_gathered_checkpoint_loads_strict_and_resumes(worlds):
    """Rank 0 wrote the full state in the reference layout: it loads with
    ``strict=True`` into a one-process TFAM and equals the gathered
    parameters; every rank restored it and cut it again to its slices."""
    got = worlds[0]["dp2tp2"]
    assert got["resumed_equal"]
    ck = worlds[1] / "dp2tp2" / "ck" / "best"
    state = torch.load(ck / "best_model.pth", weights_only=True)
    model = TFAM(tfam_config().model, num_classes=C)
    model.load_state_dict(state, strict=True)
    for name, value in got["params"].items():
        assert torch.equal(state[name], value), name
    full = torch.load(ck / "state.pt", weights_only=True)
    # AdamW's moments are saved whole too: one per parameter, full shape
    shapes = [p.shape for p in model.parameters()]
    moments = full["optimizer"]["state"]
    assert moments and all(m["exp_avg"].shape == shapes[i] for i, m in moments.items())


def _jax_spec_transposed(spec) -> tuple:
    return tuple(reversed(tuple(spec)))


def test_mesh_config_resolves_as_jax():
    from vimoclip_tpu.parallel import MeshConfig as JMeshConfig

    cases = [(-1, 1, 1, 1, 8), (-1, 2, 1, 1, 8), (4, 2, 1, 1, 8), (2, 1, 1, 1, 8),
             (-1, 3, 1, 1, 8), (8, 2, 1, 1, 8), (-1, 2, 2, 1, 8), (-1, 1, 1, 3, 8),
             (-1, 1, 1, 1, 1), (3, 1, 1, 1, 2)]
    for dp, mp_, sp, pp, n in cases:
        ours, theirs = MeshConfig(dp, mp_, sp, pp), JMeshConfig(dp, mp_, sp, pp)
        try:
            want = theirs.resolve(n)
        except ValueError as err:
            with pytest.raises(ValueError, match=str(err).split(" ")[0]):
                ours.resolve(n)
            with pytest.raises(ValueError) as mine:
                ours.resolve(n)
            assert str(mine.value) == str(err)
        else:
            assert ours.resolve(n) == want


@pytest.mark.parametrize("which", ["tfam", "student"])
def test_rules_cover_every_split_parameter_as_jax(which):
    """No dead rule against the port's real ``state_dict``, and each
    parameter's spec is JAX's spec of the same weight, transposed (the
    packed q/k/v takes the spec of JAX's q, k and v kernels)."""
    import jax

    from vimoclip_tpu.config import TFAMModelConfig as JConfig
    from vimoclip_tpu.models.clip_vit import ClipVisionConfig as JVision
    from vimoclip_tpu.models.student import StudentModel as JStudent
    from vimoclip_tpu.models.tfam import TFAM as JTFAM
    from vimoclip_tpu.parallel import STUDENT_PARTITION_RULES as JSTUDENT
    from vimoclip_tpu.parallel import TFAM_PARTITION_RULES as JTFAM_RULES
    from vimoclip_tpu_torch.models.student import StudentModel

    if which == "tfam":
        ours = TFAM(tfam_config().model, num_classes=C).state_dict()
        rules, jrules = TFAM_PARTITION_RULES, JTFAM_RULES
        jmodel = JTFAM(config=JConfig(d_model=D, nhead=HEADS, num_layers=LAYERS,
                                      dim_feedforward=FF), num_classes=C)
        jparams = jax.eval_shape(jmodel.init, jax.random.key(0),
                                 np.zeros((1, 4, D), np.float32),
                                 np.zeros((1, 3, D), np.float32), np.ones((1, 4), bool),
                                 np.ones((1, 3), bool))["params"]
        jax_path = _tfam_jax_path
    else:
        ours = StudentModel(STUDENT, num_classes=SC).state_dict()
        rules, jrules = STUDENT_PARTITION_RULES, JSTUDENT
        jvis = JVision(**{f.name: getattr(STUDENT, f.name)
                          for f in dataclasses.fields(JVision)
                          if hasattr(STUDENT, f.name)})
        jparams = jax.eval_shape(JStudent(vision_config=jvis, num_classes=SC).init,
                                 jax.random.key(0),
                                 np.zeros((1, 2, 32, 32, 3), np.uint8))["params"]
        jax_path = _student_jax_path
    assert rules.unused_rules(ours) == []
    jspecs = jrules.tree_specs(jparams)
    split = 0
    for name, value in ours.items():
        spec = rules.spec_for(name, value.ndim)
        path = jax_path(name)
        if path is None:  # no JAX counterpart (torch-only layout): replicated
            assert spec == (None,) * value.ndim, name
            continue
        node = jspecs
        for key in path:
            node = node[key]
        assert spec == _jax_spec_transposed(node) or (
            spec == (None,) * value.ndim and tuple(node) in ((), (None,) * value.ndim)
        ), (name, spec, node)
        split += "model" in spec
    assert split == (9 * LAYERS if which == "tfam" else 6 * STUDENT.num_layers)


def _tfam_jax_path(name: str):
    parts = name.split(".")
    if parts[0] != "layers":
        return None
    layer, rest = f"layers_{parts[1]}", parts[2:]
    kind = rest[-1] == "weight" and "kernel" or rest[-1]
    if rest[0] in ("self_attn", "cross_attn"):
        sub = {"in_proj_weight": ("q_proj", "kernel"), "in_proj_bias": ("q_proj", "bias"),
               "out_proj": ("out_proj", kind)}
        key = rest[1] if rest[1].startswith("in_proj") else "out_proj"
        return (layer, rest[0], *sub[key])
    if rest[0] == "ffn":
        return (layer, {"0": "ffn_dense1", "3": "ffn_dense2"}[rest[1]], kind)
    return None


def _student_jax_path(name: str):
    parts = name.split(".")
    if parts[:2] != ["visual_encoder", "transformer"]:
        return None
    layer, rest = f"layers_{parts[3]}", parts[4:]
    kind = rest[-1] == "weight" and "kernel" or rest[-1]
    if rest[0] == "attn":
        if rest[1].startswith("in_proj"):
            return ("visual_encoder", layer, "attn", "q_proj",
                    "kernel" if rest[1].endswith("weight") else "bias")
        return ("visual_encoder", layer, "attn", "out_proj", kind)
    if rest[0] == "mlp":
        return ("visual_encoder", layer, {"c_fc": "mlp_fc1", "c_proj": "mlp_fc2"}[rest[1]],
                kind)
    return None


def test_shard_batch_keeps_the_microbatches():
    """Under gradient accumulation a rank keeps its block of every
    one-process microbatch (so each microbatch pools and drops as alone)."""

    class Mesh:
        def __init__(self, rank):
            self.rank = rank

        def size(self, dim):
            return 2

        def get_local_rank(self, name):
            return self.rank

    batch = {"x": np.arange(8), "ids": list("abcdefgh"), "t": torch.arange(8), "n": 3}
    assert shard_batch(batch, None) is batch
    one = shard_batch(batch, Mesh(1))
    assert one["x"].tolist() == [4, 5, 6, 7] and one["ids"] == list("efgh")
    two = shard_batch(batch, Mesh(1), microbatches=2)
    assert two["x"].tolist() == [2, 3, 6, 7] and two["t"].tolist() == [2, 3, 6, 7]
    assert two["ids"] == list("cdgh") and two["n"] == 3
