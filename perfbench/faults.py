"""Faults planted under the timed path, to show that ``correct`` catches
them: a step that leaves the state unchanged, half of the batch left out
(the mean over the rest), an answer altered where it is produced, and for
training a schedule that is never stepped. One card:
there is no exchange between cards to leave out. The tests plant them on
the CPU; ``calibrate --fault`` reads them on the card. The benchmark's own
runs never plant one."""

from __future__ import annotations

import contextlib

import torch

FAULTS = {"tfam_train": ("unchanged_state", "half_batch", "altered_answer",
                         "schedule_not_stepped"),
          "serve": ("half_batch", "altered_answer")}


def _patch(stack, owner, name, value):
    """Set ``owner.name`` until the stack closes (an inherited attribute is
    shadowed, then uncovered again)."""
    if name in owner.__dict__:
        stack.callback(setattr, owner, name, owner.__dict__[name])
    else:
        stack.callback(delattr, owner, name)
    setattr(owner, name, value)


@contextlib.contextmanager
def planted(driver: str, fault: str):
    if fault not in FAULTS.get(driver, ()):
        raise ValueError(f"no fault {fault!r} for driver {driver!r}; known: {FAULTS}")
    with contextlib.ExitStack() as stack:
        _plant(stack, driver, fault)
        yield


def _plant(stack, driver, fault):
    if driver == "tfam_train":
        from vimoclip_tpu_torch.models.tfam import TFAM
        from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer

        if fault == "unchanged_state":
            _patch(stack, torch.optim.AdamW, "step", lambda self, closure=None: None)
        elif fault == "schedule_not_stepped":  # the rate stays the base rate
            _patch(stack, torch.optim.lr_scheduler.LambdaLR, "step", lambda self, epoch=None: None)
        elif fault == "half_batch":
            init = TFAMTrainer.__init__

            def halved(self, *a, **kw):
                init(self, *a, **kw)
                loss = self.loss_fn
                self.loss_fn = lambda logits, labels: loss(logits[: len(logits) // 2],
                                                           labels[: len(labels) // 2])

            _patch(stack, TFAMTrainer, "__init__", halved)
        else:
            head = TFAM.head

            def altered(self, pooled, generator=None):
                logits = head(self, pooled, generator)
                bump = torch.zeros_like(logits)
                bump[:, 0] = 0.05
                return logits + bump

            _patch(stack, TFAM, "head", altered)
    else:
        from vimoclip_tpu_torch.serving import ViMoCLIPPredictor

        if fault == "half_batch":
            window = ViMoCLIPPredictor._embed_window_device

            def halved(self, embed_fn, frames):
                emb, n = window(self, embed_fn, frames)
                emb = emb.clone()
                emb[len(emb) // 2:] = 0.0
                return emb, n

            _patch(stack, ViMoCLIPPredictor, "_embed_window_device", halved)
        else:
            fuse = ViMoCLIPPredictor._fuse
            _patch(stack, ViMoCLIPPredictor, "_fuse",
                   lambda self, *a: fuse(self, *a)[:, ::-1].copy())
