"""The traced run's reading of the device: ``torch.profiler`` (CUPTI) over
the window, reduced to busy time, kernel time by name, the device
operations that took longest and the longest idle gaps.

Busy time is the union of the device's activity intervals (kernels, memory
copies and sets), so copies that overlap compute count once. The window is
the benchmark's own ``perfbench.window`` range. An idle gap is named by the
innermost host operation running at its middle."""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses

import torch

WINDOW = "perfbench.window"
# what the device does: kernels, copies, sets (not the ranges it mirrors)
DEVICE_ACTIVITY = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
LONG_NS = 1_000_000  # host ops longer than a millisecond: the calls' ranges


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: dict  # device op name -> seconds inside the window
    idle_gaps: list  # [[host op, seconds], ...] by total, longest first

    def kernel_time(self, names) -> float:
        """Seconds of the device ops whose name contains one of ``names``."""
        return sum(s for k, s in self.kernel_s.items() if any(n in k for n in names))

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, s] for k, s in ops], "idle_gaps": self.idle_gaps[:TOP]}


@contextlib.contextmanager
def capture():
    """Profile host and device; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def window_range():
    return torch.profiler.record_function(WINDOW)


def _is_device_work(e, host_names) -> bool:
    """A kernel, copy or set; not the device's mirror of a host range,
    which carries the range's name."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_ACTIVITY
    return e.name() not in host_names


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(prof) -> TraceSummary:
    events = prof.profiler.kineto_results.events()
    on_device = lambda e: e.device_type() == torch.autograd.DeviceType.CUDA
    host_names = {e.name() for e in events if not on_device(e)}
    device, host, window = [], [], None
    for e in events:
        if on_device(e):
            if _is_device_work(e, host_names):
                device.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.name() == WINDOW:
            window = (e.start_ns(), e.end_ns())
        elif e.end_ns() > e.start_ns():
            host.append((e.start_ns(), e.end_ns(), e.name()))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0, w1 = window
    clipped = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    kernel_s = collections.Counter()
    for s, e, n in clipped:
        kernel_s[n] += (e - s) / 1e9
    busy = _union([(s, e) for s, e, _ in clipped])
    busy_s = sum(e - s for s, e in busy) / 1e9
    host.sort()
    starts = [s for s, _, _ in host]
    long_ops = [h for h in host if h[1] - h[0] > LONG_NS]
    gaps = collections.Counter()
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps[_host_op(host, starts, long_ops, (a + b) // 2)] += (b - a) / 1e9
    return TraceSummary((w1 - w0) / 1e9, busy_s, dict(kernel_s),
                        [[k, s] for k, s in gaps.most_common()])


def _host_op(host, starts, long_ops, t, look_back=4000) -> str:
    """The innermost host op (latest start) that spans ``t``: among the
    ``look_back`` ops that started last before it, else among the long
    ones (ranges around whole calls)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - look_back, -1), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    spanning = [h for h in long_ops if h[0] <= t <= h[1]]
    return max(spanning)[2] if spanning else "no host op recorded"
