"""Stage-2 training through ``train/tfam_trainer.py::TFAMTrainer.
train_epoch``: the trainer's own ``BatchLoader`` over an in-memory dataset
of paired RGB / motion embedding clips, ``collate_pad`` into length
buckets, ``prefetch_to_device``, ``train_step`` and the per-step loss
fetch and metric update, all inside the window.

An epoch holds the traffic's stratified clip lengths; a clip's rows are a
slice of an embedding pool made at set-up, at its own place. Set-up builds
the trainer once, gives it weights from the seed, puts it where a resume
would at the last batch of the epoch before ``check_epoch`` (its step count
and its schedule's position; the program's own rule gives the rate), and
drives it through ``check_steps`` batches by ``train_epoch`` itself: that
last batch and the first of ``check_epoch``, so the cosine schedule moves
between them. Then one step of every bucket the lengths reach warms the
shapes; the window goes on with ``check_epoch`` from there, and with
further epochs while its seconds last (the loader stops handing out
batches once they have passed).

The check follows those steps with the plain float32 step (same weights,
batches and dropout draws, each step at the published per-epoch cosine
rate): each step's loss, the first gradient's norm per leaf (from the
optimizer's first moment after the first step) and each leaf's change
after the last of them."""

from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time
import warnings

import numpy as np
import torch

from perfbench import flops
from perfbench import generator as mix
from perfbench import weights
from perfbench.drivers import _common as common
from perfbench.reference import precision
from perfbench.reference import seeding
from perfbench.reference import tfam as ref_tfam

SALT_WEIGHTS, SALT_POOL = 4, 5


class ClipDataset:
    """Map-style dataset of in-memory clips, the items ``collate_pad``
    takes; rows are views of the pools."""

    def __init__(self, rgb: np.ndarray, motion: np.ndarray, starts, lengths, labels):
        self.rgb, self.motion = rgb, motion
        self.starts, self.lengths, self.labels = starts, lengths, labels

    def __len__(self) -> int:
        return len(self.lengths)

    def __getitem__(self, i: int) -> dict:
        s, n = int(self.starts[i]), int(self.lengths[i])
        return {"video_id": f"clip{i}", "embeddings": self.rgb[s:s + n],
                "motion_embeddings": self.motion[s:s + n - 1], "labels": self.labels[i]}


class Until:
    """The trainer's loader, handing out batches while ``more(k)`` holds,
    k the batches it has handed out."""

    def __init__(self, loader, more):
        self.loader, self.more = loader, more

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        k = 0
        try:
            while self.more(k):
                batch = next(it, None)
                if batch is None:
                    return
                k += 1
                yield batch
        finally:
            it.close()


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, control: bool = False):
        self.config, self.traffic, self.seed, self.control = config, traffic, seed, control
        self.device = torch.device(device)
        self.train = config["training"]
        self.rng = np.random.default_rng(seed)

    # ------------------------------------------------------------------
    def _experiment(self, workdir: str):
        from vimoclip_tpu_torch.config import (
            DataConfig, ExperimentConfig, LoggingConfig, TrainingConfig)

        t, c = self.train, self.config
        fields = {f.name for f in dataclasses.fields(TrainingConfig)}
        training = TrainingConfig(**{k: v for k, v in t.items() if k in fields},
                                  seed=self.seed, device=self.device.type,
                                  half_precision=t["dtype"] == "bfloat16")
        data = DataConfig(num_classes=c["num_classes"], **c["data"])
        return ExperimentConfig(training, LoggingConfig(f"{workdir}/logs",
                                                        f"{workdir}/checkpoints"),
                                data, common.tfam_config(c["tfam"]))

    def _dataset(self, lengths) -> ClipDataset:
        n, classes = len(lengths), self.config["num_classes"]
        starts = self.rng.integers(0, len(self.rgb) - lengths + 1)
        labels = np.zeros((n, classes), np.float32)
        if self.train["loss"] == "ce":
            labels[np.arange(n), self.rng.integers(0, classes, n)] = 1.0
        else:
            lo, hi = self.traffic["labels_per_clip"]
            for i, k in enumerate(self.rng.integers(lo, hi + 1, n)):
                labels[i, self.rng.choice(classes, k, replace=False)] = 1.0
        return ClipDataset(self.rgb, self.motion, starts, lengths, labels)

    def setup(self) -> None:
        from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer

        c, tr, dev = self.config, self.traffic, self.device
        d = c["tfam"]["d_model"]
        self.workdir = tempfile.mkdtemp(prefix="perfbench-")
        gen = weights.generator(self.seed, SALT_POOL, dev)
        rows = tr["pool_rows"]
        self.rgb = torch.randn(rows, d, generator=gen, device=dev).cpu().numpy()
        self.motion = torch.randn(rows, d, generator=gen, device=dev).cpu().numpy()
        self.dataset = self._dataset(mix.lengths(tr["lengths"], self.rng))
        self.trainer = TFAMTrainer(self._experiment(self.workdir), f"{self.workdir}/logs",
                                   f"{self.workdir}/checkpoints",
                                   train_dataset=self.dataset, val_dataset=self.dataset)
        shapes = ref_tfam.param_shapes(c["tfam"], c["num_classes"])
        self.params0 = weights.make_params(shapes, weights.generator(self.seed, SALT_WEIGHTS, dev))
        self.trainer.model.load_state_dict(self.params0, strict=True)
        self._first_steps(tr["check_steps"], tr["check_epoch"])
        self._warm()

    def _resume_at(self, step: int) -> None:
        """The trainer as a resume from a checkpoint at ``step`` leaves it:
        the step count (which names the dropout stream) and the schedule at
        that step, its rate from the program's own rule."""
        state = self.trainer.state
        state.step = step
        with warnings.catch_warnings():  # stepped before any optimizer step
            warnings.simplefilter("ignore", UserWarning)
            state.scheduler.last_epoch = step - 1
            state.scheduler.step()

    def _first_steps(self, n: int, epoch: int) -> None:
        """``n`` batches through ``train_epoch`` from the last of the epoch
        before ``epoch``; keeps the losses, the first step's gradient norms
        and the change after the last."""
        if epoch < 1:
            raise ValueError("check_epoch must be 1 or more: the check crosses into it")
        trainer, step_fn = self.trainer, self.trainer.train_step
        per_epoch = len(trainer.train_loader)
        self.first_step = epoch * per_epoch - 1
        self._resume_at(self.first_step)
        self.losses, self.grad_norms = [], {}

        def step(batch):
            loss, logits = step_fn(batch)
            self.losses.append(float(loss))
            if len(self.losses) == 1:
                self.grad_norms = self._moment_norms()
            return loss, logits

        trainer.train_step = step
        loader = trainer.train_loader
        e, skip = divmod(self.first_step, per_epoch)
        try:
            while len(self.losses) < n:
                left = n - len(self.losses)
                trainer.train_loader = Until(loader, lambda k, left=left: k < left)
                trainer.train_epoch(e, skip_batches=skip)
                e, skip = e + 1, 0
        finally:
            trainer.train_loader = loader
            del trainer.train_step
        self.first = n
        self.resume = divmod(self.first_step + n, per_epoch)  # (epoch, batch) the window starts at
        named = dict(trainer.model.named_parameters())
        with torch.no_grad():
            self.change_norms = {k: float((named[k] - self.params0[k]).norm())
                                 for k in self.params0}

    def _moment_norms(self) -> dict:
        beta1 = self.trainer.state.optimizer.defaults["betas"][0]
        state = self.trainer.state.optimizer.state
        with torch.no_grad():
            return {k: float(state[p]["exp_avg"].norm()) / (1.0 - beta1)
                    for k, p in self.trainer.model.named_parameters() if p in state}

    def _warm(self) -> None:
        """One step at each (rgb, motion) bucket the lengths can pad to."""
        d = self.config["data"]
        b = self.train["batch_size"]
        for n in mix.warm_lengths(self.traffic["lengths"], d["length_bucket"],
                                  d["max_seq_len"]):
            items = self._dataset(np.full(b, n))
            self.trainer.train_step(self.trainer.collate([items[i] for i in range(b)]))
        common.sync(self.device)

    # ------------------------------------------------------------------
    def window(self, seconds: float, traced: bool) -> dict:
        trainer = self.trainer
        work = {"flops": 0.0, "attn_flops": 0.0, "attn_bytes": 0.0}
        spans: list[float] = []
        if traced:
            self._count(work, spans)
        before, steps0 = common.launches(), trainer.state.step
        clock = common.Clock(self.device)
        loader = trainer.train_loader
        trainer.train_loader = Until(loader, lambda k: clock.elapsed() < seconds)
        epoch, skip = self.resume
        try:
            while clock.elapsed() < seconds:
                with torch.profiler.record_function("perfbench.train_epoch"):
                    trainer.train_epoch(epoch, skip_batches=skip)
                epoch, skip = epoch + 1, 0
        finally:
            trainer.train_loader = loader
            trainer.__dict__.pop("train_step", None)
        elapsed = clock.stop()
        steps = trainer.state.step - steps0
        return {"seconds": elapsed, "units": steps, "steps": steps, "attempted": steps,
                "failed": 0, "host_step_s": spans, **work,
                "launches": common.launches_per_unit(before, steps) if traced else None}

    def _count(self, work: dict, spans: list) -> None:
        """Traced runs: a span around each ``train_step`` and the work of
        each batch it trains, from the valid lengths the loader collated."""
        trainer, c = self.trainer, self.config
        queued = []
        collate = trainer.train_loader.collate

        def counted(items):
            queued.append(([len(i["embeddings"]) for i in items],
                           [len(i["motion_embeddings"]) for i in items]))
            return collate(items)

        trainer.train_loader.collate = counted
        step_fn = trainer.train_step
        itemsize = 2 if self.train["dtype"] == "bfloat16" else 4

        def step(batch):
            lens_r, lens_m = queued.pop(0)
            cap = c["data"]["max_seq_len"]
            lens_r = [min(n, cap) for n in lens_r]
            lens_m = [min(n, cap) for n in lens_m]
            work["flops"] += 3 * sum(flops.tfam_forward_flops(r, m, c["tfam"], c["num_classes"])
                                     for r, m in zip(lens_r, lens_m))
            f, nb = flops.tfam_train_attention(lens_r, lens_m, c["tfam"], itemsize)
            work["attn_flops"] += f
            work["attn_bytes"] += nb
            with torch.profiler.record_function("perfbench.train_step"):
                t0 = time.perf_counter()
                out = step_fn(batch)
                spans.append(time.perf_counter() - t0)
            return out

        trainer.train_step = step

    def release(self) -> None:
        self.trainer.train_loader.collate = self.trainer.collate
        self.trainer.writer.close()
        del self.trainer
        shutil.rmtree(self.workdir, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def check(self) -> dict:
        """Gaps against the plain step: the first step's loss (relative; the
        later steps' loss gaps are reported, not compared: after one step
        Adam's sign-like update turns round-off into whole steps of some
        elements, PERF.md §2), and per leaf the worst gap of the first
        gradient's norm and of the change's norm, each against the larger of
        the reference leaf's and the median leaf's. Leaves whose reference
        gradient is under a thousandth of the median leaf's move by
        round-off alone and are left out of the change; a leaf the
        reference leaves unmoved counts its whole change."""
        ref = self.reference("tf32" if self.control else "fp32")
        if self.control:  # the lower precision stands in the program's place
            got_losses, got_grads, got_change = ref["losses"], ref["grads"], ref["change"]
            ref = self.reference("fp32")
        else:
            got_losses, got_grads, got_change = self.losses, self.grad_norms, self.change_norms
        gaps = [abs(a - b) / abs(b) for a, b in zip(got_losses, ref["losses"])]
        if len(got_losses) != len(ref["losses"]):
            gaps = [common.NO_ANSWER] * 2
        med_g = float(np.median(list(ref["grads"].values())))
        med_c = float(np.median(list(ref["change"].values())))
        gap = lambda got, want, med: abs(got - want) / max(want, med)
        grad_gap = max(gap(got_grads.get(k, 0.0), v, med_g) for k, v in ref["grads"].items())
        moved = [k for k, v in ref["grads"].items() if v >= 1e-3 * med_g]
        change_gap = max(gap(got_change.get(k, 0.0), ref["change"][k], med_c) for k in moved)
        still = [k for k in self.params0 if k not in ref["grads"]]
        change_gap = max([change_gap] + [got_change[k] / med_c for k in still])
        return {"loss_gap": gaps[0], "grad_gap": grad_gap, "change_gap": change_gap,
                "later_loss_gap": max(gaps[1:], default=0.0),
                "leaves_left_out": len(ref["grads"]) - len(moved)}

    def reference(self, mode: str) -> dict:
        """The plain step over the same first batches, from the same
        weights, with the same draws."""
        precision.no_tf32()
        c, t, dev = self.config, self.train, self.device
        b = t["batch_size"]
        per_epoch = len(self.dataset) // b  # the loader drops a partial batch
        params = {k: v.detach().clone() for k, v in self.params0.items()}
        state, losses, grads0 = {}, [], {}
        for s in range(self.first):
            step = self.first_step + s
            epoch, i = divmod(step, per_epoch)
            order = seeding.epoch_order(len(self.dataset), self.seed, epoch)
            batch = self._collate([self.dataset[j] for j in order[i * b:(i + 1) * b]])
            gen = ref_tfam.dropout_stream(self.seed, step, dev)
            lr = ref_tfam.cosine_lr(t["lr"], t["eta_min"], t["epochs"], epoch)
            loss, grads = ref_tfam.train_step(params, state, batch, c["tfam"], t["loss"],
                                              lr, t["weight_decay"], gen, mode)
            losses.append(loss)
            if s == 0:
                grads0 = {k: float(g.norm()) for k, g in grads.items()}
        change = {k: float((params[k] - self.params0[k]).norm()) for k in params}
        return {"losses": losses, "grads": grads0, "change": change}

    def _collate(self, items):
        """Pad to the loader's bucket (the draws take the padded shapes)."""
        d = self.config["data"]
        cap = d["max_seq_len"]
        pad = lambda n: ref_tfam.bucket_length(n, d["length_bucket"], cap)
        lr = [min(len(i["embeddings"]), cap) for i in items]
        lm = [min(len(i["motion_embeddings"]), cap) for i in items]
        tr, tm = pad(max(lr)), pad(max(lm))
        rgb = torch.zeros(len(items), tr, self.rgb.shape[1])
        mot = torch.zeros(len(items), tm, self.rgb.shape[1])
        for i, it in enumerate(items):
            rgb[i, :lr[i]] = torch.from_numpy(it["embeddings"][:lr[i]])
            mot[i, :lm[i]] = torch.from_numpy(it["motion_embeddings"][:lm[i]])
        mr = torch.arange(tr)[None, :] < torch.tensor(lr)[:, None]
        mm = torch.arange(tm)[None, :] < torch.tensor(lm)[:, None]
        labels = torch.from_numpy(np.stack([i["labels"] for i in items]))
        return rgb, mot, mr, mm, labels
