"""Train state, optimizer, schedule and checkpoints (the port's copy of
``vimoclip_tpu/train/state.py``).

- ``make_adamw``: ``torch.optim.AdamW`` with the reference's betas (0.9,
  0.999), eps 1e-8 and decoupled weight decay.
- ``make_adam``: stage 1's Adam (betas (0.9, 0.999), eps 1e-8), with an
  optional clip of the gradients' global norm by optax's rule
  (``clip_by_global_norm_``), applied inside ``step``.
- ``cosine_annealing_schedule``: torch ``CosineAnnealingLR`` stepped once per
  epoch (reference TFAM/train_and_eval.py:53-56,162), written as a
  ``LambdaLR`` stepped once per optimizer step: constant within an epoch.
- ``CheckpointManager``: ``<dir>/best`` (the best-by-metric state, plus a
  reference-format ``best_model.pth`` state dict) and ``<dir>/step_N``
  (resume points), each holding ``state.pt`` (model, optimizer, scheduler,
  step) and an ``extra.json`` sidecar (epoch, batch in epoch, best metric).
  A checkpoint directory appears only when complete (written under a
  temporary name, then renamed). ``async_save`` snapshots the state to host
  memory and writes it on a background thread.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import shutil
import threading

import torch


def make_adamw(params, lr: float, weight_decay: float = 0.1) -> torch.optim.AdamW:
    """AdamW with torch's defaults as the reference uses them."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place: where the global L2 norm n reaches ``max_norm`` every gradient
    becomes g / n * max_norm; below it they are left alone. (torch's
    ``clip_grad_norm_`` scales by max_norm / (n + 1e-6) instead, so a
    clipped step would not match the JAX step.) Returns n; no host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


class ClippedAdam(torch.optim.Adam):
    """``torch.optim.Adam`` whose ``step`` first clips the gradients' global
    norm to ``grad_clip`` (``optax.chain(clip_by_global_norm, adam)``)."""

    def __init__(self, params, lr: float, grad_clip: float | None = None):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.grad_clip = grad_clip

    def step(self, closure=None):
        if self.grad_clip is not None:
            clip_by_global_norm_([p for g in self.param_groups for p in g["params"]],
                                 self.grad_clip)
        return super().step(closure)


def make_adam(params, lr: float, grad_clip: float | None = None) -> ClippedAdam:
    """Plain Adam for stage 1 (reference train.py:66), optionally behind a
    global-norm clip (train.py:105-106)."""
    return ClippedAdam(params, lr, grad_clip=grad_clip)


def cosine_annealing_lr(base_lr: float, epochs: int, steps_per_epoch: int,
                        eta_min: float = 1e-6):
    """step -> lr: eta_min + (base - eta_min) * (1 + cos(pi * e / epochs)) / 2
    with e = step // steps_per_epoch."""

    def lr(step: int) -> float:
        epoch = step // steps_per_epoch
        return eta_min + (base_lr - eta_min) * (1.0 + math.cos(math.pi * epoch / epochs)) / 2.0

    return lr


def cosine_annealing_schedule(optimizer: torch.optim.Optimizer, base_lr: float,
                              epochs: int, steps_per_epoch: int,
                              eta_min: float = 1e-6) -> torch.optim.lr_scheduler.LambdaLR:
    """The per-epoch cosine schedule as a ``LambdaLR`` indexed by optimizer
    step (call ``step()`` after every ``optimizer.step()``). The optimizer's
    lr must be ``base_lr``."""
    lr = cosine_annealing_lr(base_lr, epochs, steps_per_epoch, eta_min)
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: lr(step) / base_lr)


@dataclasses.dataclass
class TrainState:
    """What a checkpoint holds: the model, its optimizer and schedule (None
    for stage 1's constant rate), and the number of optimizer steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler | None = None
    step: int = 0

    def state_dict(self) -> dict:
        out = {"model": self.model.state_dict(),
               "optimizer": self.optimizer.state_dict(),
               "step": self.step}
        if self.scheduler is not None:
            out["scheduler"] = self.scheduler.state_dict()
        return out

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])


def _to_cpu(obj):
    """A host copy of a state dict (tensors cloned to CPU)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return copy.deepcopy(obj)


class CheckpointManager:
    """Best-model tracking and resume checkpoints under one directory.

    ``keep_steps``: keep only the newest N ``step_*`` checkpoints (None keeps
    all). ``async_save``: ``save`` returns once the state is copied to host
    memory; a background thread writes it, one save at a time, and
    ``wait_until_finished`` (called before any restore and at the end of
    training) joins it and raises what it raised."""

    def __init__(self, directory: str, keep_steps: int | None = None,
                 async_save: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.best_metric: float = -float("inf")
        self.keep_steps = keep_steps
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, state: TrainState, name: str, extra: dict | None = None) -> None:
        # the running best metric rides in every checkpoint, so a resumed
        # run keeps tracking the best model
        extra = dict(extra or {})
        if "best_metric" not in extra and self.best_metric != -float("inf"):
            extra["best_metric"] = float(self.best_metric)
        payload = _to_cpu(state.state_dict())
        self.wait_until_finished()
        if self.async_save:
            self._thread = threading.Thread(target=self._write_guarded,
                                            args=(payload, name, extra), daemon=True)
            self._thread.start()
        else:
            self._write(payload, name, extra)

    def _write_guarded(self, payload, name, extra) -> None:
        try:
            self._write(payload, name, extra)
        except Exception as err:  # raised again by wait_until_finished
            self._error = err

    def _write(self, payload: dict, name: str, extra: dict) -> None:
        path = os.path.join(self.directory, name)
        tmp = f"{path}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, "state.pt"))
        if name == "best":  # the reference's best_model.pth: a bare state dict
            torch.save(payload["model"], os.path.join(tmp, "best_model.pth"))
        with open(os.path.join(tmp, "extra.json"), "w") as f:
            json.dump(extra, f)
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        if self.keep_steps is not None and name.startswith("step_"):
            self._prune_steps()

    def _step_dirs(self) -> list[str]:
        return [d for d in os.listdir(self.directory)
                if d.startswith("step_") and d[len("step_"):].isdigit()
                and os.path.isdir(os.path.join(self.directory, d))]

    def _prune_steps(self) -> None:
        steps = sorted(self._step_dirs(), key=lambda s: int(s.split("_")[1]))
        for stale in steps[: max(0, len(steps) - self.keep_steps)]:
            shutil.rmtree(os.path.join(self.directory, stale), ignore_errors=True)

    def save_if_best(self, state: TrainState, metric: float,
                     extra: dict | None = None) -> bool:
        """Keep ``best`` = the highest metric so far."""
        if metric > self.best_metric:
            self.best_metric = metric
            self.save(state, "best", dict(extra or {}, best_metric=float(metric)))
            return True
        return False

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint write failed") from err

    def restore(self, state: TrainState, name: str = "best") -> dict:
        """Load checkpoint ``name`` into ``state`` (in place); returns its
        extra dict."""
        self.wait_until_finished()
        path = os.path.join(self.directory, name)
        device = next(state.model.parameters()).device
        state.load_state_dict(torch.load(os.path.join(path, "state.pt"),
                                         map_location=device, weights_only=True))
        extra = {}
        if os.path.exists(os.path.join(path, "extra.json")):
            with open(os.path.join(path, "extra.json")) as f:
                extra = json.load(f)
        if "best_metric" in extra and extra["best_metric"] is not None:
            self.best_metric = float(extra["best_metric"])
        return extra

    def latest_step_name(self) -> str | None:
        steps = self._step_dirs()
        return max(steps, key=lambda s: int(s.split("_")[1])) if steps else None
