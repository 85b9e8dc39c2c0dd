"""The port's stage-2 training against the JAX package's, on the CPU: the
learning-rate schedule, AdamW against optax, a dropout-0 trajectory from
converted weights on the same batches (eager and flash attention), gradient
accumulation, checkpoints, mid-epoch resume, preemption and the
``tfam_train_eval`` CLI end to end."""

import dataclasses
import glob
import json
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vimoclip_tpu import losses as jax_losses
from vimoclip_tpu.config import TFAMModelConfig as JModelConfig
from vimoclip_tpu.data import EmbeddingWriter
from vimoclip_tpu.models.tfam import TFAM as JTFAM
from vimoclip_tpu.models.torch_compat import tfam_params_from_checkpoint
from vimoclip_tpu.train.state import TrainState as JTrainState
from vimoclip_tpu.train.state import cosine_annealing_schedule as jax_schedule
from vimoclip_tpu.train.state import make_adamw as jax_make_adamw
from vimoclip_tpu_torch.cli import tfam_train_eval
from vimoclip_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    LoggingConfig,
    TFAMModelConfig,
    TrainingConfig,
)
from vimoclip_tpu_torch.models.convert import tfam_state_from_jax, to_tensors
from vimoclip_tpu_torch.models.tfam import TFAM
from vimoclip_tpu_torch.train.state import (
    CheckpointManager,
    TrainState,
    cosine_annealing_schedule,
    make_adamw,
)
from vimoclip_tpu_torch.train.tfam_trainer import TFAMTester, TFAMTrainer, format_table
from vimoclip_tpu_torch.utils.preemption import PreemptionGuard

torch.set_num_threads(1)
D, C, LAYERS = 16, 5, 2


def _items(n, seed=0, t_range=(5, 13)):
    """Paired embeddings whose labels follow a per-class centre."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((C, D)).astype(np.float32)
    items = []
    for i in range(n):
        t, c = int(rng.integers(*t_range)), int(rng.integers(C))
        labels = np.zeros(C, np.float32)
        labels[c] = 1.0
        items.append({
            "video_id": f"v{i:03d}.mp4",
            "embeddings": (centres[c] + 0.3 * rng.standard_normal((t, D))).astype(np.float32),
            "motion_embeddings": (centres[c] + 0.3 * rng.standard_normal((t - 1, D))
                                  ).astype(np.float32),
            "labels": labels,
        })
    return items


def _write_h5(tmp_path, items):
    rgb, mot = str(tmp_path / "rgb.h5"), str(tmp_path / "mot.h5")
    with EmbeddingWriter(rgb, num_classes=C, embed_dim=D) as wr, \
         EmbeddingWriter(mot, embed_dim=D) as wm:
        for it in items:
            wr.write_video(it["video_id"], it["embeddings"], labels=it["labels"])
            wm.write_video(it["video_id"].split(".")[0], it["motion_embeddings"])
    return rgb, mot


def _model_cfg(**kw):
    base = dict(d_model=D, nhead=2, num_layers=LAYERS, dim_feedforward=32, dropout=0.0,
                mlp_dropout=0.0, attention_impl="xla")
    return TFAMModelConfig(**(base | kw))


def _config(epochs=3, batch=4, **training):
    return ExperimentConfig(
        training=TrainingConfig(**({"epochs": epochs, "batch_size": batch, "num_workers": 1,
                                    "lr": 1e-3, "device": "cpu", "seed": 49} | training)),
        logging=LoggingConfig(),
        data=DataConfig(num_classes=C, length_bucket=8),
        model=_model_cfg(),
    )


def test_lr_schedule_matches_jax():
    epochs, steps = 3, 4
    lin = torch.nn.Linear(2, 2)
    opt = make_adamw(lin.parameters(), 1e-4)
    sched = cosine_annealing_schedule(opt, 1e-4, epochs, steps, 1e-6)
    want = jax_schedule(1e-4, epochs, steps, 1e-6)
    for step in range(epochs * steps):
        assert opt.param_groups[0]["lr"] == pytest.approx(float(want(step)), rel=1e-6)
        if step % steps:  # constant within an epoch
            assert opt.param_groups[0]["lr"] == pytest.approx(float(want(step - 1)), rel=1e-6)
        opt.step()
        sched.step()


def test_adamw_steps_match_optax():
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((7, 3)).astype(np.float32)
    grads = [rng.standard_normal((7, 3)).astype(np.float32) for _ in range(5)]
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_adamw([param], 1e-2, weight_decay=0.1)
    sched = cosine_annealing_schedule(opt, 1e-2, 2, 3, 1e-6)
    tx = jax_make_adamw(jax_schedule(1e-2, 2, 3, 1e-6), weight_decay=0.1)
    state = JTrainState.create({"w": jnp.asarray(p0)}, tx)
    for g in grads:
        param.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
        state = state.apply_gradients({"w": jnp.asarray(g)})
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(state.params["w"]),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_dropout0_trajectory_matches_jax(impl, tmp_path):
    """3 epochs x 2 steps from the same (converted) weights on the same
    shuffled batches: the port's trainer step (eager attention, or the
    autograd Function's plain K1'/K2 on the CPU) tracks the JAX recipe,
    losses and parameters within 1e-5. Left out of the parameter comparison:
    the key-projection biases, whose gradient is zero in exact arithmetic (a
    bias on every key shifts a row's scores by one constant), so each
    package's rounding noise there becomes +-lr Adam steps."""
    epochs = 3
    cfg = _config(epochs=epochs)
    cfg = dataclasses.replace(cfg, model=_model_cfg(attention_impl=impl))
    items = _items(8)
    trainer = TFAMTrainer(cfg, log_dir=str(tmp_path / "logs"), checkpoint_dir=str(tmp_path / "ck"),
                          train_dataset=items, val_dataset=items)
    jcfg = JModelConfig(**{f.name: getattr(_model_cfg(), f.name)
                           for f in dataclasses.fields(JModelConfig)})
    jmodel = JTFAM(config=jcfg, num_classes=C)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 4, D)), jnp.zeros((1, 3, D)),
                         jnp.ones((1, 4), bool), jnp.ones((1, 3), bool))["params"]
    trainer.model.load_state_dict(to_tensors(tfam_state_from_jax(params, LAYERS)))
    steps = len(trainer.train_loader)
    assert steps == 2
    state = JTrainState.create(params, jax_make_adamw(
        jax_schedule(1e-3, epochs, steps, 1e-6), weight_decay=0.1))

    @jax.jit
    def jax_step(state, batch):
        def loss_fn(p):
            logits = jmodel.apply({"params": p}, batch["embeddings"],
                                  batch["motion_embeddings"], batch["mask_rgb"],
                                  batch["mask_motion"], deterministic=True)
            return jax_losses.bce_with_logits(logits, batch["labels"])

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads), loss

    ours, theirs = [], []
    for epoch in range(epochs):
        trainer.train_loader.set_epoch(epoch)
        for batch in trainer.train_loader:
            arrays = {k: v for k, v in batch.items() if k != "video_id"}
            state, loss = jax_step(state, {k: jnp.asarray(v) for k, v in arrays.items()})
            theirs.append(float(loss))
            ours.append(trainer.train_step(arrays)[0].item())
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)
    assert ours[-1] < ours[0]
    final = tfam_state_from_jax(jax.device_get(state.params), LAYERS)
    got = trainer.model.state_dict()
    for key, value in final.items():
        ours_value = got[key].numpy()
        if key.endswith("in_proj_bias"):
            keep = np.r_[0:D, 2 * D:3 * D]
            ours_value, value = ours_value[keep], value[keep]
        np.testing.assert_allclose(ours_value, value, atol=1e-5, rtol=0, err_msg=key)


def test_grad_accum_equals_full_batch(tmp_path):
    """Two equal microbatches, gradients summed then averaged: the same
    update as one step on the whole batch (masked pooling, so each
    microbatch pools as the whole batch does)."""
    items = _items(8)
    trainers = []
    for accum in (1, 2):
        cfg = _config(grad_accum=accum)
        cfg = dataclasses.replace(cfg, model=_model_cfg(masked_pooling=True))
        trainers.append(TFAMTrainer(cfg, log_dir=str(tmp_path / f"logs{accum}"),
                                    checkpoint_dir=str(tmp_path / f"ck{accum}"), train_dataset=items,
                                    val_dataset=items))
    batch = next(iter(trainers[0].train_loader))
    losses = [t.train_step(batch)[0].item() for t in trainers]
    assert losses[0] == pytest.approx(losses[1], abs=1e-6)
    a, b = (t.model.state_dict() for t in trainers)
    for key in a:
        torch.testing.assert_close(a[key], b[key], atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="grad_accum"):
        TFAMTrainer(_config(grad_accum=3), str(tmp_path / "l3"), str(tmp_path / "c3"),
                    items, items)


def test_mid_epoch_resume_is_bit_identical(tmp_path):
    """A run resumed from a mid-epoch checkpoint redraws the same batches and
    dropout masks and ends bit for bit where the uninterrupted run ends."""
    items = _items(12)
    cfg = _config(epochs=2, checkpoint_every_steps=1)
    cfg = dataclasses.replace(cfg, model=_model_cfg(dropout=0.1, mlp_dropout=0.1,
                                                    attention_impl="flash"))
    full = TFAMTrainer(cfg, str(tmp_path / "logs_a"), str(tmp_path / "a"), items, items)
    full.train()
    assert full.state.step == 6
    # keep what an interrupted run would have left: step_4 = epoch 1, batch 1
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    for name in ("step_5", "step_6"):
        shutil.rmtree(tmp_path / "b" / name)
    with open(tmp_path / "b" / "step_4" / "extra.json") as f:
        assert json.load(f)["batch_in_epoch"] == 1
    cfg.training.resume = True
    resumed = TFAMTrainer(cfg, str(tmp_path / "logs_b"), str(tmp_path / "b"), items, items)
    resumed.train()
    assert resumed.state.step == 6
    a, b = full.model.state_dict(), resumed.model.state_dict()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert resumed.history[-1]["val_loss"] == full.history[-1]["val_loss"]


def test_preemption_cuts_a_resume_checkpoint(tmp_path, monkeypatch):
    items = _items(12)
    trainer = TFAMTrainer(_config(epochs=2), str(tmp_path / "logs"), str(tmp_path / "ck"),
                          items, items)
    step = trainer.train_step

    def step_then_signal(batch):
        out = step(batch)
        if trainer.state.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(trainer, "train_step", step_then_signal)
    trainer.train()
    assert trainer.preempted and trainer.state.step == 2
    with open(tmp_path / "ck" / "step_2" / "extra.json") as f:
        assert json.load(f) == {"epoch": 0, "batch_in_epoch": 2}
    assert signal.getsignal(signal.SIGTERM) is not None  # the guard restored it


def test_preemption_guard_latches_and_restores():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested
    assert signal.getsignal(signal.SIGTERM) == before


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_checkpoint_roundtrip_and_pruning(tmp_path, async_save):
    def make():
        torch.manual_seed(0)
        model = TFAM(_model_cfg(), num_classes=C)
        opt = make_adamw(model.parameters(), 1e-3)
        return TrainState(model, opt, cosine_annealing_schedule(opt, 1e-3, 2, 2))

    state = make()
    for p in state.model.parameters():
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    state.scheduler.step()
    state.step = 1
    ckpt = CheckpointManager(str(tmp_path), keep_steps=2, async_save=async_save)
    for n in range(1, 3):
        ckpt.save(state, f"step_{n}", extra={"epoch": n})
    assert ckpt.save_if_best(state, 0.5) and not ckpt.save_if_best(state, 0.4)
    ckpt.save(state, "step_3", extra={"epoch": 3})  # carries the running best
    ckpt.wait_until_finished()
    assert sorted(os.listdir(tmp_path)) == ["best", "step_2", "step_3"]
    assert ckpt.latest_step_name() == "step_3"
    fresh = make()
    other = CheckpointManager(str(tmp_path))
    assert other.restore(fresh, "step_3") == {"epoch": 3, "best_metric": 0.5}
    assert other.best_metric == 0.5 and fresh.step == 1
    for key, value in state.state_dict()["model"].items():
        assert torch.equal(fresh.model.state_dict()[key], value)
    assert fresh.scheduler.state_dict() == state.scheduler.state_dict()
    # best/ also holds a reference-format state dict, loaded strictly
    ref = torch.load(tmp_path / "best" / "best_model.pth", weights_only=True)
    TFAM(_model_cfg(), num_classes=C).load_state_dict(ref, strict=True)


def test_trainer_needs_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    items = _items(4)
    with pytest.raises(RuntimeError, match="cpu"):
        TFAMTrainer(_config(device="cuda"), str(tmp_path / "l"), str(tmp_path / "c"),
                    items, items)
    with pytest.raises(SystemExit):
        tfam_train_eval.main(["--config", "unused.yaml", "--device", "cpu"])


def test_cli_trains_tests_and_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    items = _items(16)
    rgb, mot = _write_h5(tmp_path, items)
    (tmp_path / "classes.csv").write_text("id,name\n" + "".join(
        f"{c},action_{c}\n" for c in range(C)))
    cfg = {
        "training": {"mode": "both", "seed": 49, "lr": "3e-3", "epochs": 2, "batch_size": 4,
                     "num_workers": 2, "device": "cpu", "loss": "bce", "metric": "map"},
        "logging": {"log_dir": "logs", "checkpoint_dir": "checkpoints"},
        "data": {"num_classes": C, "class_names_dir": str(tmp_path / "classes.csv"),
                 "train_dataset_path": rgb, "val_dataset_path": rgb,
                 "flow_dataset_path": mot, "length_bucket": 8},
        "model": {"d_model": D, "nhead": 2, "num_layers": LAYERS, "dim_feedforward": 32,
                  "use_cross_attention": True, "dropout": 0.1, "mlp_dropout": 0.1,
                  "attention_impl": "flash"},
    }
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    tfam_train_eval.main(["--config", str(path), "--run-name", "r1",
                          "--results-dir", str(tmp_path / "results")])
    saved = glob.glob(str(tmp_path / "results" / "results_*.json"))
    assert len(saved) == 1
    with open(saved[0]) as f:
        results = json.load(f)
    assert 0.0 < results["metrics"]["mAP"] <= 1.0 and "loss" in results["metrics"]
    assert len(results["videos"]) == 16
    video = results["videos"][0]
    assert len(video["predictions"]) == 5
    assert video["true_labels"][0]["class_name"].startswith("action_")

    ckpt_dir = tmp_path / "tiny" / "checkpoints" / "r1"
    assert sorted(os.listdir(ckpt_dir)) == ["best", "step_4", "step_8"]
    best = str(ckpt_dir / "best" / "best_model.pth")
    model = TFAM(TFAMModelConfig(**cfg["model"]), num_classes=C)
    model.load_state_dict(torch.load(best, weights_only=True), strict=True)
    params = tfam_params_from_checkpoint(best, num_layers=LAYERS, d_model=D)
    jcfg = JModelConfig(**cfg["model"])
    x = items[0]
    args = [x["embeddings"][None], x["motion_embeddings"][None]]
    want = np.asarray(JTFAM(config=jcfg, num_classes=C).apply({"params": params}, *args))
    with torch.no_grad():
        got = model.eval()(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    # resume: two more epochs continue from the last step checkpoint
    cfg["training"] |= {"resume": True, "epochs": 4, "mode": "train"}
    path.write_text(yaml.safe_dump(cfg))
    tfam_train_eval.main(["--config", str(path), "--run-name", "r1"])
    assert "step_16" in os.listdir(ckpt_dir)


def test_tester_loads_reference_checkpoint_and_prints_table(tmp_path, capsys):
    items = _items(8)
    trainer = TFAMTrainer(_config(), str(tmp_path / "logs"), str(tmp_path / "ck"),
                          items, items)
    other = TFAM(_model_cfg(), num_classes=C)
    torch.save({"state_dict": {f"module.{k}": v for k, v in other.state_dict().items()}},
               tmp_path / "best_model.pth")
    tester = TFAMTester(trainer, results_dir=str(tmp_path / "results"))
    tester.load_torch_checkpoint(str(tmp_path / "best_model.pth"))
    for key, value in other.state_dict().items():
        assert torch.equal(trainer.model.state_dict()[key], value)
    results = tester.evaluate(top_k=2)
    assert len(results["videos"]) == 8 and results["metrics"]["mAP"] > 0
    out = capsys.readouterr().out
    assert "Videos evaluated: 8" in out and "Probability" in out
    table = format_table([("a", "0.5", "Yes")], ("Class", "Probability", "Correct"))
    assert table.splitlines() == ["+-------+-------------+---------+",
                                  "| Class | Probability | Correct |",
                                  "+-------+-------------+---------+",
                                  "|   a   |     0.5     |   Yes   |",
                                  "+-------+-------------+---------+"]
