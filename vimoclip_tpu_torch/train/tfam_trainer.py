"""Stage-2 trainer and evaluator for TFAM (the port's copy of
``vimoclip_tpu/train/tfam_trainer.py``), on one CUDA card or, when the
config says ``training.device: cpu``, on the CPU.

Reference parity (TFAM/train_and_eval.py):
- ``TFAMTrainer``: AdamW wd 0.1 with per-epoch cosine annealing to
  ``eta_min``, BCE with logits (AK multilabel) or CE (MN single-label),
  micro mAP or accuracy over the whole epoch, best-by-val-metric
  checkpointing, TensorBoard scalars, ``drop_last`` loaders.
- ``TFAMTester``: loads the best checkpoint (or a reference
  ``best_model.pth``), computes loss and metric, writes per-video top-k
  predictions with class names to ``results/results_<ts>.json`` and prints a
  summary.

Beyond the reference, as in JAX: ``grad_accum`` (equal microbatches,
gradients summed then averaged, one optimizer step), checkpoints every N
steps, mid-epoch resume that redraws the same batches and dropout masks
(batches from the epoch seed, dropout from ``KeyChain(seed)("dropout",
step)``), and preemption (SIGTERM/SIGINT cut a resume checkpoint).

Spans (``utils/profiling.py::annotate``, recorded only under a profiler):
``train_epoch`` opens ``vimo.train.data_wait`` around each fetch of the next
batch, and ``vimo.train.loss_fetch`` and ``vimo.train.metric`` after each
step; ``train_step`` is ``vimo.train.step``, with ``forward``, ``backward``
and ``optimizer`` inside. They do not overlap, so their host times add up.

Attention runs where ``model.attention_impl`` says: with ``flash`` (or
``auto`` past its crossover) a training step runs K1' forward and K2 or
K3 + K4 backward per attention site, and ``validate`` runs K1.

Data and tensor parallelism (JAX: the trainer's mesh): under ``torchrun``,
or with a process group already up, the ranks form a ``(data, model)``
mesh from ``training.data_parallel`` / ``model_parallel``
(``parallel/mesh.py``) and the model is cut by ``TFAM_PARTITION_RULES``.
Every rank loads and collates the same global batch and keeps its rows;
gradients are averaged over ``data``; losses and logits come back global
(logits gathered before mAP, which does not split by rank); rank 0 alone
logs to TensorBoard, prints and writes checkpoints. The kernels run on each
rank's (B/data, H/model) slice. A lone process with neither set above 1 is
the one-card path, untouched.

Sequence and pipeline parallelism (``training.parallelism: {seq, pipe,
microbatches}``, JAX's ``train/tfam_trainer.py``), with the same checks and
messages: ``seq`` > 1 alone runs the model on ``attention_impl: ring``
(each rank a block of the trunk's time, ``models/tfam.py``); ``pipe`` > 1
(cross-attention mode only) runs ``parallel.pipelining.
tfam_cross_pipeline_logits`` over ``microbatches`` GPipe microbatches
(default: the number of stages), its stages on ``ring_inner`` when ``seq``
is above 1 too. Each rank keeps its block of every GPipe microbatch of the
global batch (``shard_batch``). Every seq rank runs the head on the same
pooled features: its loss is divided by ``seq`` for the backward and the
gradients are summed over ``seq`` (and averaged over ``data``), which gives
the one-process gradient of every parameter; the reported loss is not
divided. The kernels run in every ring step and pipeline stage.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

import numpy as np
import torch

from vimoclip_tpu_torch import losses
from vimoclip_tpu_torch.config import ExperimentConfig, check_training_config
from vimoclip_tpu_torch.data.embedding_dataset import PairedEmbeddingDataset, collate_pad
from vimoclip_tpu_torch.data.pipeline import BatchLoader, prefetch_to_device, to_device
from vimoclip_tpu_torch.metrics import (
    DeviceMultilabelAveragePrecision,
    MultilabelAveragePrecision,
    TopKAccuracy,
)
from vimoclip_tpu_torch.models.tfam import TFAM
from vimoclip_tpu_torch.parallel.mesh import (
    PIPE_AXIS,
    SEQ_AXIS,
    MeshConfig,
    any_rank,
    local_device,
    shard_batch,
    training_mesh,
)
from vimoclip_tpu_torch.parallel.partition import TFAM_PARTITION_RULES, parallelize_
from vimoclip_tpu_torch.parallel.pipelining import tfam_cross_pipeline_logits
from vimoclip_tpu_torch.prng import KeyChain
from vimoclip_tpu_torch.train.state import (
    CheckpointManager,
    TrainState,
    cosine_annealing_lr,
    cosine_annealing_schedule,
    make_adamw,
)
from vimoclip_tpu_torch.utils.device import resolve_device
from vimoclip_tpu_torch.utils.logging import StepTimer, SummaryWriter, progress
from vimoclip_tpu_torch.utils.preemption import PreemptionGuard
from vimoclip_tpu_torch.utils.profiling import annotate

_INPUTS = ("embeddings", "motion_embeddings", "mask_rgb", "mask_motion")


def _make_metric(config: ExperimentConfig):
    if config.training.metric == "accuracy":
        return TopKAccuracy(top_k=1)
    if config.training.device_metric:
        return DeviceMultilabelAveragePrecision(num_labels=config.num_classes)
    return MultilabelAveragePrecision(num_labels=config.num_classes)


def _metric_update(metric, logits: torch.Tensor, labels: torch.Tensor) -> None:
    if getattr(metric, "device_resident", False):
        metric.update(logits, labels)
    else:
        metric.update(logits.float().cpu().numpy(), labels.cpu().numpy())


class TFAMTrainer:
    """``train_dataset`` / ``val_dataset``: map-style datasets of
    ``PairedEmbeddingDataset`` items; by default they are read from the
    config's HDF5 paths. ``mesh``: a ``DeviceMesh`` to train on instead of
    the one built from the config (it must carry the axes asked for)."""

    def __init__(self, config: ExperimentConfig, log_dir: str, checkpoint_dir: str,
                 train_dataset=None, val_dataset=None, mesh=None):
        self.config = config
        tcfg = check_training_config(config.training)
        mcfg = config.model
        if tcfg.pipeline_parallel > 1 and not (
                mcfg.use_cross_attention and not mcfg.use_only_rgb and not mcfg.use_only_flow):
            raise ValueError(
                "training.parallelism: pipe requires the cross-attention fusion mode "
                "(parallel.tfam_cross_pipeline_logits pipelines that path; other modes "
                "fit one card)")
        self.device = resolve_device(local_device(tcfg.device))
        self.mesh = mesh if mesh is not None else training_mesh(
            MeshConfig(tcfg.data_parallel, tcfg.model_parallel, tcfg.seq_parallel,
                       tcfg.pipeline_parallel),
            self.device, "vimoclip_tpu_torch.cli.tfam_train_eval")
        for flag, field, value, axis in (("seq", "seq_parallel", tcfg.seq_parallel, SEQ_AXIS),
                                         ("pipe", "pipeline_parallel",
                                          tcfg.pipeline_parallel, PIPE_AXIS)):
            if value > 1 and (self.mesh is None or axis not in self.mesh.mesh_dim_names):
                shape = None if self.mesh is None else dict(
                    zip(self.mesh.mesh_dim_names, self.mesh.shape))
                raise ValueError(
                    f"training.parallelism: {flag}={value} but the provided mesh {shape} "
                    f"has no {axis!r} axis — build it with create_mesh(MeshConfig("
                    f"{field}={value})) or drop the parallelism setting")
        n_data = 1 if self.mesh is None else self.mesh.size(0)
        if tcfg.grad_accum > 1 and tcfg.batch_size % tcfg.grad_accum:
            raise ValueError(
                f"training.grad_accum={tcfg.grad_accum} must divide "
                f"batch_size={tcfg.batch_size} (equal microbatches keep the "
                "accumulated gradient identical to the full batch)")
        rows = tcfg.batch_size // max(tcfg.grad_accum, 1)
        if rows % n_data:
            raise ValueError(
                f"batch_size/grad_accum = {rows} microbatch rows must divide the "
                f"mesh's data axis ({n_data}) — lower grad_accum or raise batch_size")
        # GPipe microbatches per step (or per accumulation microbatch)
        self.n_micro = 1
        if tcfg.pipeline_parallel > 1:
            self.n_micro = tcfg.pipeline_microbatches or tcfg.pipeline_parallel
            if rows % self.n_micro or (rows // self.n_micro) % n_data:
                raise ValueError(
                    f"batch_size/grad_accum = {rows} rows must split into {self.n_micro} "
                    f"GPipe microbatches that each divide the data axis ({n_data}) — raise "
                    "batch_size or lower grad_accum/microbatches")
        if tcfg.seq_parallel > 1:
            # every collated batch pads T up to a length_bucket multiple (capped
            # at max_seq_len), and the ring cuts T over the seq axis
            n_seq, bucket = tcfg.seq_parallel, config.data.length_bucket
            if not bucket or bucket % n_seq:
                raise ValueError(
                    f"training.parallelism: seq={n_seq} needs data.length_bucket to be a "
                    f"multiple of it (got {bucket!r}) — padded sequence lengths must shard "
                    "evenly over the seq axis")
            cap = config.data.max_seq_len
            if cap is not None and cap % n_seq:
                raise ValueError(
                    f"training.parallelism: seq={n_seq} needs data.max_seq_len ({cap}) "
                    "divisible by it — capped batches pad to exactly max_seq_len")
            # the ring over the trainer's seq group; inside pipeline stages its
            # ring_inner name
            mcfg = dataclasses.replace(mcfg, attention_impl=(
                "ring" if tcfg.pipeline_parallel == 1 else "ring_inner"))
        self.dtype = torch.bfloat16 if tcfg.half_precision else torch.float32
        self.keys = KeyChain(tcfg.seed)
        # torch's default initialisers (the reference's), from the
        # experiment seed and nothing else
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.keys.seed("init"))
            model = TFAM(mcfg, num_classes=config.num_classes, dtype=self.dtype)
        model.to(self.device)
        self.partition = self.shard = None
        if self.mesh is not None:
            self.partition = parallelize_(model, TFAM_PARTITION_RULES, self.mesh)
            self.shard = self.partition.shard
        self.is_main = self.shard is None or self.mesh.get_rank() == 0
        self.metric = _make_metric(config)
        self.metric_name = "accuracy" if tcfg.metric == "accuracy" else "mAP"
        self.loss_fn = (losses.cross_entropy_loss if tcfg.loss == "ce"
                        else losses.bce_with_logits)
        self.writer = SummaryWriter(log_dir if self.is_main else None)
        self.ckpt = CheckpointManager(checkpoint_dir, keep_steps=tcfg.keep_checkpoints,
                                      async_save=tcfg.async_checkpoint)

        dcfg = config.data
        if train_dataset is None:
            train_dataset = PairedEmbeddingDataset(
                dcfg.train_dataset_path, dcfg.motion_dataset_path,
                num_frames=dcfg.num_frames, max_frames=dcfg.max_frames)
        if val_dataset is None:
            val_dataset = PairedEmbeddingDataset(
                dcfg.val_dataset_path, dcfg.motion_dataset_path,
                num_frames=dcfg.num_frames, max_frames=dcfg.max_frames)
        self.collate = lambda items: collate_pad(items, bucket=dcfg.length_bucket,
                                                 max_seq_len=dcfg.max_seq_len)
        self.train_loader = BatchLoader(train_dataset, tcfg.batch_size, self.collate,
                                        shuffle=True, drop_last=True, seed=tcfg.seed,
                                        num_workers=tcfg.num_workers)
        self.val_loader = BatchLoader(val_dataset, tcfg.batch_size, self.collate,
                                      shuffle=False, drop_last=True,
                                      num_workers=tcfg.num_workers)

        steps_per_epoch = max(len(self.train_loader), 1)
        optimizer = make_adamw(model.parameters(), tcfg.lr, tcfg.weight_decay)
        self.lr_at = cosine_annealing_lr(tcfg.lr, tcfg.epochs, steps_per_epoch, tcfg.eta_min)
        scheduler = cosine_annealing_schedule(optimizer, tcfg.lr, tcfg.epochs,
                                              steps_per_epoch, tcfg.eta_min)
        self.state = TrainState(model, optimizer, scheduler, partition=self.partition)
        self._preempt = None  # the PreemptionGuard while train() runs
        self.preempted = False
        self.history: list[dict] = []

    @property
    def model(self) -> TFAM:
        return self.state.model

    # ------------------------------------------------------------------
    def _logits(self, batch: dict, generator=None) -> torch.Tensor:
        inputs = [batch[k] for k in _INPUTS]
        if self.shard is not None and self.shard.pipe > 1:
            return tfam_cross_pipeline_logits(self.model, *inputs, n_micro=self.n_micro,
                                              generator=generator)
        return self.model(*inputs, generator=generator)

    def _backward(self, loss: torch.Tensor) -> None:
        # every seq rank runs the head on the same features: 1/seq of the
        # loss each, summed over seq by average_gradients_
        seq = 1 if self.shard is None else self.shard.seq
        (loss / seq if seq > 1 else loss).backward()

    def _global(self, loss: torch.Tensor, logits: torch.Tensor):
        """The global batch's loss and logits from this rank's (whose rows
        are its block of each GPipe microbatch, gathered per microbatch)."""
        if self.shard is None:
            return loss, logits
        return self.shard.mean_over_data(loss), torch.cat(
            [self.shard.gather_rows(part) for part in logits.chunk(self.n_micro)])

    def _stop_requested(self) -> bool:
        """A preemption signal, agreed by every rank under a mesh."""
        requested = self._preempt is not None and self._preempt.requested
        return requested if self.shard is None else any_rank(requested, self.device)

    def train_step(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step on a collated global batch (numpy or on the
        device); dropout draws from the step's own stream. Returns the
        detached loss and logits of the global batch."""
        with annotate("vimo.train.step"):
            accum = self.config.training.grad_accum
            batch = to_device(shard_batch(batch, self.mesh, max(accum, 1) * self.n_micro),
                              self.device)
            generator = self.keys("dropout", self.state.step, device=self.device)
            model, opt = self.model, self.state.optimizer
            model.train()
            opt.zero_grad(set_to_none=True)
            if accum <= 1:
                with annotate("vimo.train.forward"):
                    logits = self._logits(batch, generator)
                    loss = self.loss_fn(logits, batch["labels"])
                with annotate("vimo.train.backward"):
                    self._backward(loss)
                loss, logits = self._global(loss.detach(), logits.detach())
            else:
                rows = batch["labels"].shape[0] // accum
                loss_sum, parts = 0.0, []
                for i in range(accum):
                    mb = {k: batch[k][i * rows:(i + 1) * rows] for k in (*_INPUTS, "labels")}
                    with annotate("vimo.train.forward"):
                        part = self._logits(mb, generator)
                        mb_loss = self.loss_fn(part, mb["labels"])
                    with annotate("vimo.train.backward"):
                        self._backward(mb_loss)  # gradients add up in .grad
                    mb_loss, part = self._global(mb_loss.detach(), part.detach())
                    loss_sum = loss_sum + mb_loss
                    parts.append(part)
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(accum)
                loss, logits = loss_sum / accum, torch.cat(parts)
            if self.shard is not None:
                self.shard.average_gradients_(model.parameters())
            with annotate("vimo.train.optimizer"):
                opt.step()
                self.state.scheduler.step()
            self.state.step += 1
            return loss.detach(), logits.detach()

    @torch.no_grad()
    def eval_step(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Loss and logits of a collated global batch, dropout off."""
        batch = to_device(shard_batch(batch, self.mesh, self.n_micro), self.device)
        self.model.eval()
        logits = self._logits(batch)
        return self._global(self.loss_fn(logits, batch["labels"]), logits)

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int, skip_batches: int = 0) -> tuple[float, float]:
        self.metric.reset()
        self.train_loader.set_epoch(epoch, start_batch=skip_batches)
        total_loss, n = 0.0, 0
        every = self.config.training.checkpoint_every_steps
        timer = StepTimer()
        last = None
        # every rank uploads the global batch and keeps its rows on the card
        batches = iter(progress(prefetch_to_device(self.train_loader, self.device),
                                desc=f"epoch {epoch + 1}",
                                total=len(self.train_loader) - skip_batches))
        while True:
            with annotate("vimo.train.data_wait"):
                batch = next(batches, None)
            if batch is None:
                break
            loss, logits = self.train_step(batch)
            with annotate("vimo.train.loss_fetch"):
                total_loss += float(loss)
            n += 1
            last = (logits, batch["labels"])
            with annotate("vimo.train.metric"):
                _metric_update(self.metric, logits, batch["labels"])
            timer.tick(batch["labels"].shape[0])
            done = skip_batches + n
            if self._stop_requested():
                extra = {"epoch": epoch}
                if done < len(self.train_loader):
                    extra["batch_in_epoch"] = done
                self.ckpt.save(self.state, f"step_{self.state.step}", extra=extra)
                break
            if every and n % every == 0 and done < len(self.train_loader):
                self.ckpt.save(self.state, f"step_{self.state.step}",
                               extra={"epoch": epoch, "batch_in_epoch": done})
        train_loss = total_loss / max(n, 1)
        train_metric = self.metric.compute()
        self.writer.add_scalar("Loss/train", train_loss, epoch)
        self.writer.add_scalar(f"{self.metric_name}/train", train_metric, epoch)
        self.writer.add_scalar("perf/train_clips_per_sec", timer.examples_per_sec, epoch)
        if last is not None:  # final-batch dumps, reference train.py:146-153
            logits_np = last[0].float().cpu().numpy()
            labels_np = last[1].cpu().numpy()
            self.writer.add_histogram("train/final_batch_logits", logits_np, epoch)
            self.writer.add_histogram("train/final_batch_labels", labels_np, epoch)
            self.writer.add_text("train/final_batch_logits", str(logits_np), epoch)
            self.writer.add_text("train/final_batch_labels", str(labels_np), epoch)
        return train_loss, train_metric

    def validate(self, epoch: int | None = None) -> tuple[float, float]:
        self.metric.reset()
        total_loss, n = 0.0, 0
        for batch in prefetch_to_device(self.val_loader, self.device):
            loss, logits = self.eval_step(batch)
            total_loss += float(loss)
            n += 1
            _metric_update(self.metric, logits, batch["labels"])
        val_loss = total_loss / max(n, 1)
        val_metric = self.metric.compute()
        if epoch is not None:
            self.writer.add_scalar("Loss/val", val_loss, epoch)
            self.writer.add_scalar(f"{self.metric_name}/val", val_metric, epoch)
        return val_loss, val_metric

    def train(self) -> float:
        tcfg = self.config.training
        start_epoch, skip = 0, 0
        if tcfg.resume:
            latest = self.ckpt.latest_step_name()
            if latest:
                extra = self.ckpt.restore(self.state, latest)
                if "batch_in_epoch" in extra:  # mid-epoch checkpoint
                    start_epoch, skip = int(extra["epoch"]), int(extra["batch_in_epoch"])
                else:
                    start_epoch = int(extra.get("epoch", -1)) + 1
                logging.info("resumed from %s at epoch %d batch %d",
                             latest, start_epoch, skip)
        start = time.time()
        self.preempted = False
        with PreemptionGuard() as guard:
            self._preempt = guard
            try:
                return self._train_epochs(start_epoch, skip, self.ckpt.best_metric, start)
            finally:
                self.preempted = guard.requested
                self._preempt = None

    def _train_epochs(self, start_epoch: int, skip: int, best: float,
                      start: float) -> float:
        tcfg = self.config.training
        for epoch in range(start_epoch, tcfg.epochs):
            train_loss, train_metric = self.train_epoch(epoch, skip_batches=skip)
            skip = 0
            if self._stop_requested():
                self.ckpt.wait_until_finished()
                self.writer.close()
                logging.info("preempted during epoch %d: checkpoint saved; rerun with "
                             "training.resume to continue bit-identically", epoch)
                return best
            val_loss, val_metric = self.validate(epoch)
            if self.ckpt.save_if_best(self.state, val_metric, extra={"epoch": epoch}):
                logging.info("new best model at epoch %d (%s=%.4f)",
                             epoch, self.metric_name, val_metric)
                best = val_metric
            self.ckpt.save(self.state, f"step_{self.state.step}", extra={"epoch": epoch})
            lr = self.lr_at(self.state.step)
            self.history.append({
                "epoch": epoch, "train_loss": train_loss, "train_map": train_metric,
                "val_loss": val_loss, "val_map": val_metric, "lr": lr,
            })
            self.writer.add_scalar("Learning Rate", lr, epoch)
            logging.info(
                "Epoch %d/%d | Train Loss: %.4f | Train %s: %.4f | Val Loss: %.4f | "
                "Val %s: %.4f | LR: %.2e", epoch + 1, tcfg.epochs, train_loss,
                self.metric_name, train_metric, val_loss, self.metric_name, val_metric, lr)
        self.ckpt.wait_until_finished()
        self.writer.close()
        logging.info("training complete in %.2f minutes", (time.time() - start) / 60)
        return best


class TFAMTester:
    """Evaluation and per-video top-k reports (reference ModelTester,
    train_and_eval.py:175-307)."""

    def __init__(self, trainer: TFAMTrainer, results_dir: str = "results"):
        self.t = trainer
        self.results_dir = results_dir
        self.class_names: dict[str, str] = {}
        path = trainer.config.data.class_names_dir
        if path and os.path.exists(path):
            from vimoclip_tpu_torch.extraction import load_class_names

            self.class_names = {str(k): v for k, v in load_class_names(path).items()}

    def load_best(self) -> None:
        self.t.ckpt.restore(self.t.state, "best")
        logging.info("best model loaded from %s", self.t.ckpt.directory)

    def load_torch_checkpoint(self, path: str) -> None:
        """Evaluate a reference-format ``best_model.pth`` (loaded strictly)."""
        from vimoclip_tpu_torch.models.convert import tfam_state_from_checkpoint, to_tensors

        state = to_tensors(tfam_state_from_checkpoint(path))
        if self.t.partition is not None:  # this rank's slices and stage
            state = self.t.partition.local_state(state)
        self.t.model.load_state_dict(state, strict=True)
        logging.info("reference torch checkpoint loaded from %s", path)

    def _name(self, c) -> str:
        return self.class_names.get(str(c), f"class_{c}")

    def evaluate(self, save_predictions: bool = False, top_k: int = 5) -> dict:
        self.t.metric.reset()
        results = {"videos": [], "metrics": {},
                   "config": {"model": "TFAM",
                              "timestamp": time.strftime("%Y-%m-%d %H:%M:%S")}}
        total_loss, n = 0.0, 0
        for batch in prefetch_to_device(self.t.val_loader, self.t.device):
            loss, logits = self.t.eval_step(batch)
            total_loss += float(loss)
            n += 1
            logits_np = logits.float().cpu().numpy()
            labels_np = batch["labels"].cpu().numpy()
            _metric_update(self.t.metric, logits, batch["labels"])
            probs = 1.0 / (1.0 + np.exp(-logits_np))
            for i, vid in enumerate(batch["video_id"]):
                order = np.argsort(probs[i])[::-1][:top_k]
                results["videos"].append({
                    "video_id": vid,
                    "true_labels": [{"class_id": str(c), "class_name": self._name(c)}
                                    for c in np.where(labels_np[i] == 1)[0]],
                    "predictions": {
                        str(c): {"class_name": self._name(c),
                                 "probability": round(float(probs[i, c]), 4)}
                        for c in order},
                })
        results["metrics"]["loss"] = total_loss / max(n, 1)
        results["metrics"][self.t.metric_name] = self.t.metric.compute()
        if not self.t.is_main:
            return results
        if save_predictions:
            os.makedirs(self.results_dir, exist_ok=True)
            out = os.path.join(self.results_dir,
                               f"results_{time.strftime('%Y%m%d-%H%M%S')}.json")
            with open(out, "w") as f:
                json.dump(results, f, indent=2)
            logging.info("results saved to %s", out)
        self._print_summary(results)
        return results

    def _print_summary(self, results: dict) -> None:
        name = self.t.metric_name
        print("\n" + "=" * 60)
        print(f"Evaluation summary ({results['config']['timestamp']})")
        print("=" * 60)
        print(f"Loss: {results['metrics']['loss']:.4f}")
        print(f"{name}:  {results['metrics'][name]:.4f}")
        print(f"Videos evaluated: {len(results['videos'])}")
        for video in results["videos"][:3]:
            print(f"\nVideo ID: {video['video_id']}")
            true_ids = {label["class_id"] for label in video["true_labels"]}
            rows = [(p["class_name"], f"{p['probability']:.4f}",
                     "Yes" if cid in true_ids else "No")
                    for cid, p in video["predictions"].items()]
            print(format_table(rows, ("Class", "Probability", "Correct")))


def format_table(rows, headers) -> str:
    """A plain-text table (what ``tabulate(tablefmt="pretty")`` prints,
    without the dependency)."""
    cells = [tuple(map(str, headers))] + [tuple(map(str, r)) for r in rows]
    widths = [max(len(r[i]) for r in cells) for i in range(len(headers))]
    rule = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    line = lambda r: "| " + " | ".join(c.center(w) for c, w in zip(r, widths)) + " |"
    return "\n".join([rule, line(cells[0]), rule, *map(line, cells[1:]), rule])
