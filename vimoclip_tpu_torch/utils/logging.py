"""Observability (the port's copy of ``vimoclip_tpu/utils/logging.py``):
python logging for the CLIs, TensorBoard scalars, a progress bar and a step
timer."""

from __future__ import annotations

import logging
import os
import sys
import time


def setup_logging(log_file: str | None = "training.log") -> None:
    """INFO-level logging to stderr and, when ``log_file`` is given, to that
    file (reference parity: ``training.log`` + stdout). Under ``torchrun``
    the ranks other than 0 log warnings and errors only, to stderr."""
    main_rank = int(os.environ.get("RANK", 0)) == 0
    handlers: list[logging.Handler] = [logging.StreamHandler()]
    if log_file and main_rank:
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(
        level=logging.INFO if main_rank else logging.WARNING,
        format="%(asctime)s - %(levelname)s - %(message)s",
        handlers=handlers,
        force=True,
    )


class SummaryWriter:
    """TensorBoard writer over ``torch.utils.tensorboard``; when tensorboard
    is not installed it logs one warning and writes nothing, and with no
    ``log_dir`` (a rank other than 0) it writes nothing."""

    def __init__(self, log_dir: str | None):
        self._writer = None
        if log_dir is None:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter
        except ImportError:
            logging.warning("tensorboard unavailable; scalars will not be logged")
            return
        self._writer = TBWriter(log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), int(step))

    def add_histogram(self, tag: str, values, step: int) -> None:
        if self._writer is not None:
            import numpy as np

            self._writer.add_histogram(tag, np.asarray(values), int(step))

    def add_text(self, tag: str, text: str, step: int) -> None:
        if self._writer is not None:
            self._writer.add_text(tag, text, int(step))

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


def progress(iterable, desc: str = "", total: int | None = None):
    """A tqdm bar when tqdm is installed and stderr is a terminal; the bare
    iterable otherwise."""
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, desc=desc, total=total, disable=not sys.stderr.isatty())


class StepTimer:
    """Steps and examples per second since the last ``reset``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._start = time.perf_counter()
        self._steps = 0
        self._examples = 0

    def tick(self, examples: int = 0) -> None:
        self._steps += 1
        self._examples += examples

    @property
    def steps_per_sec(self) -> float:
        dt = time.perf_counter() - self._start
        return self._steps / dt if dt > 0 else 0.0

    @property
    def examples_per_sec(self) -> float:
        dt = time.perf_counter() - self._start
        return self._examples / dt if dt > 0 else 0.0
