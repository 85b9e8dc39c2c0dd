"""Preemption-safe training (the port's copy of
``vimoclip_tpu/utils/preemption.py``): SIGTERM/SIGINT are latched into a
flag the train loop polls, so a preempted run cuts a mid-epoch checkpoint
and returns; rerunning with ``training.resume`` continues bit for bit."""

from __future__ import annotations

import logging
import signal
import threading


class PreemptionGuard:
    """Context manager that traps SIGTERM/SIGINT while a train loop runs.

    - First signal: latches ``requested``; the loop checkpoints and exits at
      the next step boundary.
    - Second signal: restores the original handlers and re-raises it.
    - Installs only from the main thread; elsewhere it is an inert flag.
    """

    def __init__(self, signums=(signal.SIGTERM, signal.SIGINT)):
        self._signums = tuple(signums)
        self._event = threading.Event()
        self._previous: dict[int, object] = {}
        self._installed = False

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def _handle(self, signum, frame):
        if self._event.is_set():
            logging.warning("second signal %d during preemption drain: restoring "
                            "default handling", signum)
            self._restore()
            signal.raise_signal(signum)
            return
        logging.warning("signal %d: finishing the current step, checkpointing, and "
                        "exiting cleanly (resume continues bit-identically)", signum)
        self._event.set()

    def _restore(self) -> None:
        for signum, old in self._previous.items():
            signal.signal(signum, old)
        self._previous.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for signum in self._signums:
                self._previous[signum] = signal.signal(signum, self._handle)
            self._installed = True
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            self._restore()
