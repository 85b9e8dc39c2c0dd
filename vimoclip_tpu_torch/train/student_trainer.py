"""Stage-1 MoCLIP distillation trainer (the port's copy of
``vimoclip_tpu/train/student_trainer.py``), on one CUDA card or, when the
caller passes ``device="cpu"``, on the CPU.

Reference parity (train.py / train_frame_diff.py / train_frame_diff_mn.py):
- loss = distillation(student distill branch, teacher RGB[:, :-1]) +
  classification: the teacher sequence loses its last frame to line up with
  the T - 1 motion frames (QUIRKS #6);
- AK: BCE with the reference's per-element pos-weight (9 by default); MN:
  CE on the argmax of the one-hot labels;
- Adam, with an optional global-norm clip by optax's rule;
- best checkpoint by the lowest validation total loss (kept as -loss, as
  the JAX package keeps it), a checkpoint per epoch.

Beyond the reference, as in JAX: ``grad_accum`` (equal microbatches, the
mean of their mean losses, one Adam step), checkpoints every N steps and a
resume that lands on the exact next batch of a mid-epoch checkpoint
(batches from the epoch seed; the student has no dropout), preemption
(SIGTERM/SIGINT cut a resume checkpoint) and asynchronous checkpoints.

With ``half_precision`` the model computes in bfloat16 over float32
parameters. Motion frames go to the card as uint8 and are normalised there:
at the encoder's size by kernel K5 (``clip_preprocess``), once per train or
eval step.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from vimoclip_tpu_torch import losses
from vimoclip_tpu_torch.data.pipeline import BatchLoader, prefetch_to_device, to_device
from vimoclip_tpu_torch.data.segment_dataset import collate_segments
from vimoclip_tpu_torch.models import init_parameters_
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig
from vimoclip_tpu_torch.models.convert import to_tensors
from vimoclip_tpu_torch.models.student import StudentModel
from vimoclip_tpu_torch.prng import KeyChain
from vimoclip_tpu_torch.train.state import CheckpointManager, TrainState, make_adam
from vimoclip_tpu_torch.utils.device import resolve_device
from vimoclip_tpu_torch.utils.logging import StepTimer, SummaryWriter, progress
from vimoclip_tpu_torch.utils.preemption import PreemptionGuard

_ARRAYS = ("rgb_emb", "motion_frames", "labels")


class StudentTrainer:
    """``train_dataset`` / ``val_dataset``: map-style datasets whose items
    carry ``rgb_emb`` (T, P), ``motion_frames`` (T - 1, H, W, 3) uint8,
    ``labels`` (C,) and ``video_id`` (``SegmentDataset``, or synthetic
    segments). ``pretrained_state``: CLIP visual weights in the
    ``ClipVisionEncoder`` layout for the tower (random init from ``seed``
    without them); the branches keep torch's default init."""

    def __init__(
        self,
        train_dataset,
        val_dataset,
        checkpoint_dir: str,
        log_dir: str | None = None,
        vision_config: ClipVisionConfig | None = None,
        pretrained_state: dict | None = None,
        num_classes: int = 140,
        alpha: float = 0.1,
        lr: float = 1e-5,
        batch_size: int = 8,
        num_workers: int = 4,
        epochs: int = 10,
        distill_mode: str = "cosine",
        class_loss: str = "bce",  # bce (AK) | ce (MN)
        class_pos_weight: float | None = 9.0,
        grad_clip: float | None = None,
        seed: int = 49,
        half_precision: bool = True,
        checkpoint_every_steps: int | None = None,
        resume: bool = False,
        grad_accum: int = 1,
        async_checkpoint: bool = False,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.grad_accum = max(1, int(grad_accum))
        if self.grad_accum > 1 and batch_size % self.grad_accum:
            raise ValueError(
                f"grad_accum={self.grad_accum} must divide batch_size={batch_size} "
                "(equal microbatches keep the accumulated gradient identical to "
                "the full batch)")
        if len(val_dataset) < batch_size:
            # the drop_last val loader would give 0 batches, found only after
            # a whole training epoch; evaluate() keeps the check as a backstop
            raise ValueError(
                f"validation set has {len(val_dataset)} segments < batch_size "
                f"{batch_size}: the drop_last val loader would produce 0 batches "
                "— lower batch_size or add validation data")
        self.vision_config = vision_config or ClipVisionConfig.vit_b_32()
        self.dtype = torch.bfloat16 if half_precision else torch.float32
        self.epochs = epochs
        self.checkpoint_every_steps = checkpoint_every_steps
        self.resume = resume
        self.distill_mode = distill_mode
        self.class_loss = class_loss
        self.class_pos_weight = class_pos_weight
        self.batch_size = batch_size
        self.keys = KeyChain(seed)
        self.ckpt = CheckpointManager(checkpoint_dir, async_save=async_checkpoint)
        self.writer = SummaryWriter(log_dir) if log_dir else None
        self.val_ds = val_dataset
        self.train_loader = BatchLoader(train_dataset, batch_size, collate_segments,
                                        shuffle=True, drop_last=True, seed=seed,
                                        num_workers=num_workers)
        self.val_loader = BatchLoader(val_dataset, batch_size, collate_segments,
                                      shuffle=False, drop_last=True,
                                      num_workers=num_workers)
        model = self._init_model(num_classes, alpha, pretrained_state).to(self.device)
        self.state = TrainState(model, make_adam(model.parameters(), lr, grad_clip=grad_clip))
        self._preempt = None  # the PreemptionGuard while train() runs
        self.preempted = False

    def _init_model(self, num_classes: int, alpha: float,
                    pretrained_state: dict | None) -> StudentModel:
        # torch's default initialisers for the branches, from the seed alone
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.keys.seed("init"))
            model = StudentModel(self.vision_config, num_classes=num_classes,
                                 alpha=alpha, dtype=self.dtype)
        if pretrained_state is not None:
            model.visual_encoder.load_state_dict(to_tensors(pretrained_state), strict=True)
        else:
            init_parameters_(model.visual_encoder,
                             torch.Generator().manual_seed(self.keys.seed("init_vit")))
        return model

    @property
    def model(self) -> StudentModel:
        return self.state.model

    # ------------------------------------------------------------------
    def _losses(self, batch: dict):
        _, distill, logits = self.model(batch["motion_frames"])
        teacher = batch["rgb_emb"][:, :-1, :]  # T RGB vs T - 1 motion frames
        d_loss = losses.distillation_loss(distill, teacher, self.distill_mode)
        if self.class_loss == "ce":
            c_loss = losses.cross_entropy_loss(logits, batch["labels"])
        else:
            c_loss = losses.classification_loss(logits, batch["labels"],
                                                self.class_pos_weight)
        return d_loss, c_loss, logits

    def train_step(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """One Adam step on a collated batch (numpy or on the device).
        Returns the detached (total, distill, class) losses as one (3,)
        tensor on the device, and the logits."""
        batch = to_device({k: batch[k] for k in _ARRAYS}, self.device)
        model, opt = self.model, self.state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        accum = self.grad_accum
        rows = batch["labels"].shape[0] // accum
        sums, parts = None, []
        for i in range(accum):
            mb = batch if accum == 1 else {k: v[i * rows:(i + 1) * rows]
                                           for k, v in batch.items()}
            d_loss, c_loss, logits = self._losses(mb)
            total = d_loss + c_loss
            total.backward()  # microbatch gradients add up in .grad
            vals = torch.stack([total, d_loss, c_loss]).detach()
            sums = vals if sums is None else sums + vals
            parts.append(logits.detach())
        if accum > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum)
            sums = sums / accum
        opt.step()
        self.state.step += 1
        return sums, torch.cat(parts)

    @torch.no_grad()
    def eval_step(self, batch: dict) -> torch.Tensor:
        """(total, distill, class) losses of a batch, as one (3,) tensor."""
        batch = to_device({k: batch[k] for k in _ARRAYS}, self.device)
        self.model.eval()
        d_loss, c_loss, _ = self._losses(batch)
        return torch.stack([d_loss + c_loss, d_loss, c_loss])

    # ------------------------------------------------------------------
    def _device_batches(self, loader):
        for batch in prefetch_to_device(loader, self.device):
            yield {k: batch[k] for k in _ARRAYS}

    def train_epoch(self, epoch: int, skip_batches: int = 0) -> dict:
        self.train_loader.set_epoch(epoch, start_batch=skip_batches)
        # loss sums stay on the device and are fetched once per epoch: a
        # per-step float() would make the host wait for the card every step
        sums, n = None, 0
        timer = StepTimer()
        last = None
        for batch in progress(self._device_batches(self.train_loader),
                              desc=f"epoch {epoch + 1}",
                              total=len(self.train_loader) - skip_batches):
            vals, logits = self.train_step(batch)
            sums = vals if sums is None else sums + vals
            n += 1
            last = (logits, batch["labels"])
            timer.tick(batch["labels"].shape[0])
            done = skip_batches + n
            if self._preempt is not None and self._preempt.requested:
                # cut a resume checkpoint (at an epoch's end, an epoch-end one)
                extra = {"epoch": epoch}
                if done < len(self.train_loader):
                    extra["batch_in_epoch"] = done
                self.ckpt.save(self.state, f"step_{self.state.step}", extra=extra)
                break
            if (self.checkpoint_every_steps and n % self.checkpoint_every_steps == 0
                    and done < len(self.train_loader)):
                self.ckpt.save(self.state, f"step_{self.state.step}",
                               extra={"epoch": epoch, "batch_in_epoch": done})
            if self.writer and n % 10 == 0:
                t3 = vals.cpu().numpy()
                for i, name in enumerate(("total", "distill", "class")):
                    self.writer.add_scalar(f"train/{name}_loss", float(t3[i]), self.state.step)
        if self.writer and last is not None:
            # last-batch logits and labels, text and histogram (train.py:146-153)
            logits_np, labels_np = last[0].float().cpu().numpy(), last[1].cpu().numpy()
            self.writer.add_text("Logits/LastBatch", str(logits_np), epoch)
            self.writer.add_text("Labels/LastBatch", str(labels_np), epoch)
            self.writer.add_histogram("Logits/LastBatch", logits_np, epoch)
            self.writer.add_histogram("Labels/LastBatch", labels_np, epoch)
        means = sums.cpu().numpy() / n if n else np.zeros(3)
        out = dict(zip(("total", "distill", "class"), map(float, means)))
        out["segments_per_sec"] = timer.examples_per_sec
        return out

    def evaluate(self) -> dict:
        sums, n = None, 0
        for batch in self._device_batches(self.val_loader):
            vals = self.eval_step(batch)
            sums = vals if sums is None else sums + vals
            n += 1
        if n == 0:
            # 0.0 would be kept as an unbeatable best by save_if_best
            raise ValueError(
                f"validation loader produced 0 batches: batch_size {self.batch_size} "
                f"exceeds the {len(self.val_ds)} val segments (drop_last drops the "
                "short tail) — lower batch_size or add validation data")
        return dict(zip(("total", "distill", "class"), map(float, sums.cpu().numpy() / n)))

    def train(self) -> float:
        """Train every epoch left; returns the best validation total loss."""
        start = time.time()
        start_epoch, skip = 0, 0
        if self.resume:
            latest = self.ckpt.latest_step_name()
            if latest:
                extra = self.ckpt.restore(self.state, latest)
                if "batch_in_epoch" in extra:  # mid-epoch checkpoint
                    start_epoch, skip = int(extra["epoch"]), int(extra["batch_in_epoch"])
                else:  # epoch-end checkpoint: the next epoch
                    start_epoch = int(extra.get("epoch", -1)) + 1
                logging.info("resumed from %s (epoch %d, batch %d)", latest, start_epoch, skip)
        # a resumed run continues from the persisted best, so a run whose
        # remaining epochs never improve still returns it
        best_val = (-self.ckpt.best_metric if self.ckpt.best_metric != -float("inf")
                    else float("inf"))
        self.preempted = False
        with PreemptionGuard() as guard:
            self._preempt = guard
            try:
                return self._train_epochs(start_epoch, skip, best_val, start)
            finally:
                self.preempted = guard.requested
                self._preempt = None

    def _train_epochs(self, start_epoch: int, skip: int, best_val: float,
                      start: float) -> float:
        for epoch in range(start_epoch, self.epochs):
            tr = self.train_epoch(epoch, skip_batches=skip)
            skip = 0
            if self._preempt is not None and self._preempt.requested:
                self.ckpt.wait_until_finished()
                logging.info("preempted during epoch %d: checkpoint saved; rerun with "
                             "resume=True to continue bit-identically", epoch)
                return best_val
            va = self.evaluate()
            # CheckpointManager keeps the highest metric: store -loss
            if self.ckpt.save_if_best(self.state, -va["total"], extra={"epoch": epoch}):
                best_val = va["total"]
                logging.info("new best student at epoch %d (val loss %.4f)",
                             epoch, va["total"])
            self.ckpt.save(self.state, f"step_{self.state.step}", extra={"epoch": epoch})
            if self.writer:
                for k, v in va.items():
                    self.writer.add_scalar(f"val/{k}_loss", v, epoch)
            logging.info(
                "Epoch %d/%d | train total %.4f (distill %.4f, class %.4f) | "
                "val total %.4f | %.1f segments/s", epoch + 1, self.epochs, tr["total"],
                tr["distill"], tr["class"], va["total"], tr["segments_per_sec"])
        self.ckpt.wait_until_finished()
        if self.writer:
            self.writer.close()
        logging.info("stage-1 training complete in %.1f min", (time.time() - start) / 60)
        return best_val
