"""Profiling (the port's copy of ``vimoclip_tpu/utils/profiling.py``):
device traces, named ranges, host-RSS sampling and device memory.

- ``trace``: ``torch.profiler`` over the host and, when a card is present,
  the card (CUPTI), written as a Chrome trace into ``log_dir``;
- ``annotate``: a named ``record_function`` range for a step's phases;
- ``MemoryMonitor``: a daemon thread sampling host RSS (the reference's
  ``utils/video_benchmark_raft.py`` sampler);
- ``device_memory_stats``: live and peak memory of each card.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; writes ``<log_dir>/trace.json`` (Chrome trace
    format, viewable in Perfetto or ``chrome://tracing``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


class MemoryMonitor:
    """Samples host RSS on a daemon thread."""

    def __init__(self, interval_s: float = 0.1):
        self.interval_s = interval_s
        self.samples_mb: list[float] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _rss_mb(self) -> float:
        try:
            import psutil

            return psutil.Process().memory_info().rss / 1e6
        except Exception:
            try:
                with open("/proc/self/status") as f:
                    for line in f:
                        if line.startswith("VmRSS"):
                            return int(line.split()[1]) / 1e3
            except Exception:
                pass
        return 0.0

    def __enter__(self):
        self._stop.clear()
        self.samples_mb = []

        def loop():
            while not self._stop.is_set():
                self.samples_mb.append(self._rss_mb())
                time.sleep(self.interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    @property
    def peak_mb(self) -> float:
        return max(self.samples_mb, default=0.0)

    @property
    def mean_mb(self) -> float:
        return sum(self.samples_mb) / len(self.samples_mb) if self.samples_mb else 0.0


def device_memory_stats() -> dict:
    """Memory of each CUDA card, by ``cuda:N``: bytes allocated now and at
    peak (PyTorch's allocator) and the card's free and total bytes. ``{}``
    without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "name": torch.cuda.get_device_name(i),
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_free": free,
            "bytes_limit": total,
        }
    return out
