"""The port's pipeline parallelism (``vimoclip_tpu_torch/parallel/pipelining.py``)
on the CPU over gloo, against the JAX package's ``parallel/pipelining.py``
on its virtual devices and against the port's one-process step.

- ``split_microbatches`` / ``merge_microbatches`` against JAX's, and the
  layers each stage holds against JAX's ``stack_stage_params``; their
  argument checks.
- Two gloo worlds, spawned once (two and four ranks), hold:
  - ``pipeline_apply`` on JAX's residual-MLP stages, 4 layers over pipe 2 at
    2 and 4 microbatches: outputs and gradients (stage parameters and
    input) against JAX's ``pipeline_apply`` on a pipe mesh of 2 (1e-6,
    1e-5);
  - ``tfam_cross_pipeline_logits`` at pipe 2 with 2 and 4 microbatches,
    ``use_pe`` on and off, and at pipe 2 x seq 2: logits (1e-5) and the
    BCE loss's gradients (2e-5) against JAX's on the same weights;
  - the trainer's step at pipe 2 and pipe 2 x seq 2 against the one-process
    step, dropout off (loss 1e-6, gradients 1e-5); with dropout 0.1 the
    masks are drawn per (stage, microbatch), not the one-process ones: the
    step is finite, the same for the same step and differs from the
    dropout-free step;
  - a pipe-trained checkpoint, gathered on rank 0 with every stage's layers
    and Adam moments, loads strictly into the one-process model and
    resumes on the stages.

JAX is imported inside the tests that use it: the spawned ranks import this
module and need torch only.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vimoclip_tpu_torch import losses
from vimoclip_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    LoggingConfig,
    TFAMModelConfig,
    TrainingConfig,
)
from vimoclip_tpu_torch.data.embedding_dataset import collate_pad
from vimoclip_tpu_torch.models.tfam import TFAM
from vimoclip_tpu_torch.parallel import TFAM_PARTITION_RULES, MeshConfig, create_mesh
from vimoclip_tpu_torch.parallel.partition import parallelize_
from vimoclip_tpu_torch.parallel.pipelining import (
    keep_stage_layers_,
    merge_microbatches,
    pipeline_apply,
    split_microbatches,
    stage_layers,
    tfam_cross_pipeline_logits,
)
from vimoclip_tpu_torch.train import tfam_trainer as tfam_trainer_module
from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer
from vimoclip_tpu_torch.utils.logging import SummaryWriter

torch.set_num_threads(1)

D, HEADS, LAYERS, FF, C, B, T, TM = 16, 2, 4, 32, 5, 8, 12, 10
BUCKET = 8
LOSS_TOL, GRAD_TOL = 1e-6, 1e-5
MLP_D, MLP_LAYERS, MLP_BATCH = 6, 4, 8
# (name, pipe, seq, n_micro, use_pe) of tfam_cross_pipeline_logits
TFAM_CASES = [("m2", 2, 1, 2, False), ("m4", 2, 1, 4, False), ("m2_pe", 2, 1, 2, True),
              ("m4_pe", 2, 1, 4, True), ("seq2", 2, 2, 2, False)]
# (name, world, pipe, seq, dropout) of the trainer's step
STEP_CASES = [("pipe2", 2, 2, 1, 0.0), ("pipe2_drop", 2, 2, 1, 0.1),
              ("pipe2seq2", 4, 2, 2, 0.0)]


# ---------------------------------------------------------------------------
# helpers against JAX's
# ---------------------------------------------------------------------------


def test_split_merge_as_jax():
    import jax

    from vimoclip_tpu.parallel.pipelining import split_microbatches as jsplit

    x = np.arange(8 * 3 * 2, dtype=np.float32).reshape(8, 3, 2)
    m = np.arange(8) % 3 == 0
    ours = split_microbatches((torch.from_numpy(x), torch.from_numpy(m)), 4)
    theirs = jax.device_get(jsplit((x, m), 4))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), b)
    back = merge_microbatches(ours)
    assert torch.equal(back[0], torch.from_numpy(x)) and torch.equal(back[1],
                                                                      torch.from_numpy(m))
    with pytest.raises(ValueError, match="not divisible"):
        split_microbatches(torch.zeros(6, 4), 4)


def test_stage_layers_as_jax():
    """Stage s holds the layers JAX stacks at stage s (consecutive ones),
    under their one-process names; an indivisible depth is refused."""
    import jax

    from vimoclip_tpu.parallel.pipelining import stack_stage_params as jstack

    layers = [{"i": np.array([i])} for i in range(8)]
    stacked = jax.device_get(jstack(layers, 4))["i"]
    for s in range(4):
        assert list(stage_layers(8, 4, s)) == stacked[s, :, 0].tolist()
    model = TFAM(model_config(), num_classes=C)
    keep_stage_layers_(model, 1, 2)
    assert list(model.layers) == ["2", "3"]
    assert {n.split(".")[1] for n in model.state_dict() if n.startswith("layers.")} == {"2", "3"}
    with pytest.raises(ValueError, match="not divisible"):
        stage_layers(3, 2, 0)
    with pytest.raises(ValueError, match="not divisible"):
        jstack(layers[:3], 2)


def test_refuses_without_a_pipe_axis_and_outside_cross_mode():
    with pytest.raises(ValueError, match="no 'pipe' axis"):
        pipeline_apply(lambda x, m: x, (torch.zeros(2, 1, 3),), None)
    model = TFAM(model_config(use_cross_attention=False), num_classes=C)
    with pytest.raises(ValueError, match="cross-attention"):
        tfam_cross_pipeline_logits(model, torch.zeros(2, 4, D), torch.zeros(2, 4, D))
    with pytest.raises(ValueError, match="no 'pipe' axis"):
        tfam_cross_pipeline_logits(TFAM(model_config(), num_classes=C),
                                   torch.zeros(2, 4, D), torch.zeros(2, 4, D))


# ---------------------------------------------------------------------------
# the cases the ranks run
# ---------------------------------------------------------------------------


def mlp_layers() -> list[dict]:
    rng = np.random.default_rng(1)
    return [{"w": (rng.standard_normal((MLP_D, MLP_D)) * 0.3).astype(np.float32),
             "b": (rng.standard_normal(MLP_D) * 0.1).astype(np.float32)}
            for _ in range(MLP_LAYERS)]


def mlp_input() -> np.ndarray:
    return np.random.default_rng(2).standard_normal((MLP_BATCH, MLP_D)).astype(np.float32)


def mlp_case(n_micro: int, rank: int) -> dict:
    """JAX's residual-MLP stages: 2 layers per stage, (x @ w + b) -> tanh."""
    per = MLP_LAYERS // 2
    mine = [{k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
            for p in mlp_layers()[rank * per:(rank + 1) * per]]

    def stage_fn(xin, m):
        (h,) = xin
        for p in mine:
            h = h + torch.tanh(h @ p["w"] + p["b"])
        return (h,)

    x = torch.from_numpy(mlp_input()).requires_grad_()
    (out,) = pipeline_apply(stage_fn, split_microbatches((x,), n_micro),
                            dist.group.WORLD, [t for p in mine for t in p.values()])
    out = merge_microbatches(out)
    (out ** 2).sum().backward()
    return {"out": out.detach(), "x_grad": x.grad,
            "grads": [{k: t.grad for k, t in p.items()} for p in mine]}


def model_config(use_pe=False, dropout=0.0, impl="flash", **kw) -> TFAMModelConfig:
    return TFAMModelConfig(d_model=D, nhead=HEADS, num_layers=LAYERS, dim_feedforward=FF,
                           dropout=dropout, mlp_dropout=dropout, use_pe=use_pe,
                           attention_impl=impl, **kw)


def tfam_inputs():
    """Bucket-like shapes: T and Tm divide seq 2."""
    rng = np.random.default_rng(6)
    rgb = rng.standard_normal((B, T, D)).astype(np.float32)
    mot = rng.standard_normal((B, TM, D)).astype(np.float32)
    lengths = rng.integers(2, T + 1, B)
    mask_rgb = np.arange(T)[None, :] < lengths[:, None]
    mask_flow = np.arange(TM)[None, :] < np.minimum(lengths - 1, TM)[:, None]
    labels = (rng.random((B, C)) < 0.3).astype(np.float32)
    return rgb, mot, mask_rgb, mask_flow, labels


def tfam_case(state, pipe, seq, n_micro, use_pe) -> dict:
    mesh = create_mesh(MeshConfig(1, 1, seq_parallel=seq, pipeline_parallel=pipe), "cpu")
    model = TFAM(model_config(use_pe, impl="ring_inner" if seq > 1 else "flash"),
                 num_classes=C).eval()
    model.load_state_dict(state)
    part = parallelize_(model, TFAM_PARTITION_RULES, mesh)
    *inputs, labels = (torch.from_numpy(a) for a in tfam_inputs())
    logits = tfam_cross_pipeline_logits(model, *inputs, n_micro=n_micro)
    loss = losses.bce_with_logits(logits, labels)
    (loss / seq).backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    if seq > 1:
        dist.all_reduce(flat, group=part.shard.seq_group)
    offset = 0
    for n, g in grads.items():
        grads[n] = flat[offset:offset + g.numel()].view_as(g)
        offset += g.numel()
    return {"logits": logits.detach(), "loss": loss.item(),
            "grads": part.full_state(grads)}


def config(pipe=1, seq=1, dropout=0.0, micro=None) -> ExperimentConfig:
    return ExperimentConfig(
        training=TrainingConfig(batch_size=B, num_workers=1, lr=1e-3, device="cpu", seed=7,
                                seq_parallel=seq, pipeline_parallel=pipe,
                                pipeline_microbatches=micro),
        logging=LoggingConfig(), data=DataConfig(num_classes=C, length_bucket=BUCKET),
        model=model_config(dropout=dropout))


def train_batch() -> dict:
    rng = np.random.default_rng(3)
    items = [{"video_id": f"v{i}",
              "embeddings": rng.standard_normal((n, D)).astype(np.float32),
              "motion_embeddings": rng.standard_normal((n - 1, D)).astype(np.float32),
              "labels": (rng.random(C) < 0.3).astype(np.float32)}
             for i, n in enumerate([13, 11, 5, 7, 6, 4, 8, 3])]
    return {k: v for k, v in collate_pad(items, bucket=BUCKET).items() if k != "video_id"}


def trainer(cfg, where, state):
    t = TFAMTrainer(cfg, log_dir=os.path.join(where, "logs"),
                    checkpoint_dir=os.path.join(where, "ck"), train_dataset=[], val_dataset=[])
    t.model.load_state_dict(state if t.partition is None else t.partition.local_state(state))
    return t


def step(cfg, where, state, again: bool = False) -> dict:
    t = trainer(cfg, where, state)
    eval_loss, eval_logits = t.eval_step(train_batch())  # TFAMTester's path
    loss, logits = t.train_step(train_batch())
    grads = {n: p.grad.detach().clone() for n, p in t.model.named_parameters()
             if p.grad is not None}
    if t.partition is not None:
        grads = t.partition.full_state(grads)
    out = {"loss": loss.item(), "logits": logits, "grads": grads, "trainer": t,
           "eval": (eval_loss.item(), eval_logits)}
    if again:  # the same step from the same state: the same masks
        out["again"] = trainer(cfg, where, state).train_step(train_batch())[0].item()
    return out


def _rank(rank: int, world: int, store: str, out: str, states: dict) -> None:
    import sys

    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None  # its import costs seconds a rank
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    save = (lambda obj, name: torch.save(obj, os.path.join(out, f"{name}.pt"))) \
        if rank == 0 else (lambda obj, name: None)
    try:
        if world == 2:
            for n_micro in (2, 4):
                got = mlp_case(n_micro, rank)
                # each stage's parameter gradients, gathered on rank 0
                parts = [None] * world
                dist.all_gather_object(parts, got.pop("grads"))
                save(dict(got, grads=[g for part in parts for g in part]), f"mlp{n_micro}")
        for name, pipe, seq, n_micro, use_pe in TFAM_CASES:
            if pipe * seq == world:
                save(tfam_case(states["pe" if use_pe else "plain"], pipe, seq, n_micro,
                               use_pe), f"tfam_{name}")
        for name, w, pipe, seq, drop in STEP_CASES:
            if w != world:
                continue
            got = step(config(pipe, seq, drop), os.path.join(out, name), states["plain"],
                       again=drop > 0)
            t = got.pop("trainer")
            if name == "pipe2":  # the gathered checkpoint, then a resume on the stages
                t.ckpt.save(t.state, "best")
                again = trainer(config(pipe, seq), os.path.join(out, name), states["plain"])
                again.ckpt.restore(again.state, "best")
                got["resumed_equal"] = all(
                    torch.equal(a, b) for a, b in zip(t.model.state_dict().values(),
                                                      again.model.state_dict().values()))
                got["resumed_moments"] = all(
                    torch.equal(a["exp_avg"], b["exp_avg"]) for a, b in zip(
                        t.state.optimizer.state_dict()["state"].values(),
                        again.state.optimizer.state_dict()["state"].values()))
                got["params"] = t.partition.full_state(t.model.state_dict())
                got["layers_held"] = sorted(t.model.layers.keys())
            save(got, name)
    finally:
        dist.destroy_process_group()


def jax_tfam(use_pe: bool):
    import jax

    from vimoclip_tpu.config import TFAMModelConfig as JConfig
    from vimoclip_tpu.models.tfam import TFAM as JTFAM

    cfg = JConfig(d_model=D, nhead=HEADS, num_layers=LAYERS, dim_feedforward=FF, dropout=0.1,
                  mlp_dropout=0.1, use_pe=use_pe)
    model = JTFAM(config=cfg, num_classes=C)
    params = model.init(jax.random.key(1), *tfam_inputs()[:4])["params"]
    return cfg, params


@pytest.fixture(scope="module")
def states():
    import jax

    from vimoclip_tpu_torch.models.convert import tfam_state_from_jax, to_tensors

    return {key: to_tensors(tfam_state_from_jax(jax.device_get(jax_tfam(pe)[1]), LAYERS))
            for key, pe in (("plain", False), ("pe", True))}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, states):
    out = tmp_path_factory.mktemp("pipe_worlds")
    for world in (2, 4):
        mp.spawn(_rank, args=(world, str(out / f"store{world}"), str(out), states),
                 nprocs=world, join=True)
    return out


@pytest.fixture(scope="module")
def one_process(tmp_path_factory, states):
    out = tmp_path_factory.mktemp("pipe_one")
    with pytest.MonkeyPatch.context() as mpatch:  # no TensorBoard: its import is slow
        mpatch.setattr(tfam_trainer_module, "SummaryWriter", lambda log_dir: SummaryWriter(None))
        got = step(config(), str(out / "one"), states["plain"])
    got.pop("trainer")
    return got


def _load(worlds, name):
    return torch.load(worlds / f"{name}.pt", weights_only=False)


@pytest.mark.parametrize("n_micro", [2, 4])
def test_pipeline_apply_matches_jax(devices, worlds, n_micro):
    import jax
    import jax.numpy as jnp

    from vimoclip_tpu.parallel import MeshConfig as JMeshConfig
    from vimoclip_tpu.parallel import create_mesh as jcreate
    from vimoclip_tpu.parallel.pipelining import merge_microbatches as jmerge
    from vimoclip_tpu.parallel.pipelining import pipeline_apply as japply
    from vimoclip_tpu.parallel.pipelining import split_microbatches as jsplit
    from vimoclip_tpu.parallel.pipelining import stack_stage_params as jstack

    def stage_fn(stage_p, x):
        def one(x, lp):
            return x + jnp.tanh(x @ lp["w"] + lp["b"]), None

        return jax.lax.scan(one, x, stage_p)[0]

    mesh = jcreate(JMeshConfig(data_parallel=1, pipeline_parallel=2), devices=devices[:2])

    def loss(stage_p, x):
        out = jmerge(japply(stage_fn, stage_p, jsplit(x, n_micro), mesh))
        return (out ** 2).sum(), out

    (_, want), (g_p, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jstack(mlp_layers(), 2), jnp.asarray(mlp_input()))
    got = _load(worlds, f"mlp{n_micro}")
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got["x_grad"].numpy(), np.asarray(g_x), atol=GRAD_TOL)
    per = MLP_LAYERS // 2
    for layer, mine in enumerate(got["grads"]):
        for k, g in mine.items():
            np.testing.assert_allclose(g.numpy(), np.asarray(g_p[k])[layer // per, layer % per],
                                       atol=GRAD_TOL)


@pytest.mark.parametrize("case", [c[0] for c in TFAM_CASES])
def test_tfam_pipeline_matches_jax(devices, worlds, states, case):
    """Logits against JAX's ``tfam_cross_pipeline_logits`` on a (pipe[, seq])
    mesh (1e-5), and the BCE loss's gradients of every parameter, gathered
    over the stages, against JAX's (2e-5)."""
    import jax

    from vimoclip_tpu import losses as jlosses
    from vimoclip_tpu.parallel import MeshConfig as JMeshConfig
    from vimoclip_tpu.parallel import create_mesh as jcreate
    from vimoclip_tpu.parallel.pipelining import tfam_cross_pipeline_logits as jlogits
    from vimoclip_tpu_torch.models.convert import tfam_state_from_jax, to_tensors

    _, pipe, seq, n_micro, use_pe = {c[0]: c for c in TFAM_CASES}[case]
    cfg, params = jax_tfam(use_pe)
    mesh = jcreate(JMeshConfig(data_parallel=1, pipeline_parallel=pipe, seq_parallel=seq),
                   devices=devices[:pipe * seq])
    *inputs, labels = tfam_inputs()

    def loss(p):
        logits = jlogits(p, cfg, mesh, *inputs, n_micro=n_micro,
                         seq_axis="seq" if seq > 1 else None)
        return jlosses.bce_with_logits(logits, labels), logits

    (want_loss, want_logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    want = to_tensors(tfam_state_from_jax(jax.device_get(grads), LAYERS))
    got = _load(worlds, f"tfam_{case}")
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want_logits), atol=1e-5)
    assert abs(got["loss"] - float(want_loss)) < 1e-5
    for name, g in want.items():
        if name in got["grads"]:
            np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(), atol=2e-5,
                                       err_msg=name)
        else:  # the projection the cross-attention mode leaves unused
            assert not g.abs().max(), name


@pytest.mark.parametrize("case", ["pipe2", "pipe2seq2"])
def test_pipe_step_equals_one_process(worlds, one_process, case):
    got, want = _load(worlds, case), one_process
    assert abs(got["loss"] - want["loss"]) < LOSS_TOL
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"].numpy(), atol=1e-5)
    assert abs(got["eval"][0] - want["eval"][0]) < LOSS_TOL  # eval_step, dropout off
    np.testing.assert_allclose(got["eval"][1].numpy(), want["eval"][1].numpy(), atol=1e-5)
    assert got["grads"].keys() == want["grads"].keys()
    for name, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(), atol=GRAD_TOL,
                                   rtol=0, err_msg=name)


def test_pipe_step_with_dropout_draws_per_stage_and_microbatch(worlds, one_process):
    got = _load(worlds, "pipe2_drop")
    assert np.isfinite(got["loss"]) and got["loss"] == got["again"]
    assert all(torch.isfinite(g).all() for g in got["grads"].values())
    assert got["grads"].keys() == one_process["grads"].keys()
    assert abs(got["loss"] - one_process["loss"]) > 1e-4  # the masks act


def test_pipe_checkpoint_loads_into_one_process_model(worlds):
    got = _load(worlds, "pipe2")
    assert got["layers_held"] == ["0", "1"]  # rank 0 holds stage 0's layers
    assert got["resumed_equal"] and got["resumed_moments"]
    ck = worlds / "pipe2" / "ck" / "best"
    state = torch.load(ck / "best_model.pth", weights_only=True)
    model = TFAM(model_config(), num_classes=C)
    model.load_state_dict(state, strict=True)
    assert list(state) == list(model.state_dict())  # the one-process order
    for name, value in got["params"].items():
        assert torch.equal(state[name], value), name
    full = torch.load(ck / "state.pt", weights_only=True)
    shapes = [p.shape for p in model.parameters()]
    moments = full["optimizer"]["state"]
    # every stage's layers carry their moments, indexed as the one-process
    # optimizer indexes them
    layer_params = sum(1 for n, _ in model.named_parameters() if n.startswith("layers."))
    assert sum(1 for i in moments if i < layer_params) == layer_params
    assert all(m["exp_avg"].shape == shapes[i] for i, m in moments.items())
    opt = torch.optim.AdamW(model.parameters())
    opt.load_state_dict(full["optimizer"])
