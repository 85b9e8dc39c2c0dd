"""Python logging setup shared by the port's CLIs (the counterpart of
``vimoclip_tpu/utils/logging.py::setup_logging``)."""

from __future__ import annotations

import logging


def setup_logging(log_file: str | None = "training.log") -> None:
    """INFO-level logging to stderr and, when ``log_file`` is given, to that
    file (reference parity: ``training.log`` + stdout)."""
    handlers: list[logging.Handler] = [logging.StreamHandler()]
    if log_file:
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(levelname)s - %(message)s",
        handlers=handlers,
        force=True,
    )
