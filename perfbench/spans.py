"""The program's own spans in a traced run: every ``vimo.*`` range the port
opens (``vimoclip_tpu_torch/utils/profiling.py::annotate``), by name, with
the host time each took and the device time of the work launched inside it.

A span's host time is its duration clipped to the window. Its device time is
found by correlation: a kernel, copy or set carries the correlation id of the
CUDA call that launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
``cuLaunchKernelEx``); that call's thread and start time give every ``vimo.*`` span
open on that thread then, and the device interval, clipped to the window,
counts once for each of those names (inclusively: a kernel counts for a span
and for every span around it).

The table is read from the traced run's profiler, which the harness holds
while the metrics are read: ``of_run`` finds it among the callers' locals,
so ``trace.TraceSummary`` and ``summarize`` stay as they were. A run that
was not traced, or a program that opens no ``vimo.*`` span, gives an empty
table, and every reader leaves its metric out."""

from __future__ import annotations

import bisect
import collections
import sys

import torch
from torch.autograd import DeviceType

from perfbench import trace as tracing

PREFIX = "vimo."
# the host side's record of a CUDA API call (cudaLaunchKernel,
# cudaMemcpyAsync, cuLaunchKernelEx, ...); PyTorch's own ops carry ids of
# another count, and names with a namespace
LAUNCH_PREFIX = "cu"


class _Thread:
    """One thread's spans, nested as they were opened."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s for s, _, _ in self.spans]
        self.parent = []
        open_ = []
        for i, (s, _, _) in enumerate(self.spans):
            while open_ and self.spans[open_[-1]][1] <= s:
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(i)

    def names_at(self, t: int) -> set:
        """Names of every span open at ``t``."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] < t:
            i = self.parent[i]
        names = set()
        while i >= 0:
            names.add(self.spans[i][2])
            i = self.parent[i]
        return names


def table(events, window, device_work) -> dict:
    """``{span name: {"count", "host_s", "device_s"}}`` over the window
    ``(start_ns, end_ns)``. ``events``: the profiler's events (each with
    ``name``, ``start_ns``, ``end_ns``, ``device_type``, ``activity_type``,
    ``correlation_id`` and ``device_resource_id``, the thread of a host
    event); ``device_work(e)``: whether ``e`` is a kernel, copy or set on
    the device. ``count`` holds the spans that overlap the window."""
    w0, w1 = window
    by_thread = collections.defaultdict(list)
    launches, device = {}, []
    for e in events:
        if device_work(e):
            device.append(e)
        elif e.device_type() != DeviceType.CPU:
            continue  # the device's mirror of a host range
        elif e.name().startswith(PREFIX):
            by_thread[e.device_resource_id()].append((e.start_ns(), e.end_ns(), e.name()))
        elif e.name().startswith(LAUNCH_PREFIX):
            launches[e.correlation_id()] = (e.device_resource_id(), e.start_ns())
    out = {}
    for spans in by_thread.values():
        for s, e, name in spans:
            if e > w0 and s < w1:
                row = out.setdefault(name, {"count": 0, "host_s": 0.0, "device_s": 0.0})
                row["count"] += 1
                row["host_s"] += (min(e, w1) - max(s, w0)) / 1e9
    threads = {tid: _Thread(spans) for tid, spans in by_thread.items()}
    for e in device:
        s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
        launch = launches.get(e.correlation_id())
        if t <= s or launch is None or launch[0] not in threads:
            continue
        for name in threads[launch[0]].names_at(launch[1]):
            row = out.setdefault(name, {"count": 0, "host_s": 0.0, "device_s": 0.0})
            row["device_s"] += (t - s) / 1e9
    return out


def of_profiler(prof) -> dict:
    """``table`` over a finished profiler's events, in its
    ``perfbench.window`` range, with the device work ``summarize`` counts."""
    events = prof.profiler.kineto_results.events()
    on_device = lambda e: e.device_type() == DeviceType.CUDA
    host_names = {e.name() for e in events if not on_device(e)}
    window = next(((e.start_ns(), e.end_ns()) for e in events
                   if not on_device(e) and e.name() == tracing.WINDOW), None)
    if window is None:
        return {}
    work = lambda e: on_device(e) and tracing._is_device_work(e, host_names)
    return table(events, window, work)


def _profiler_of_caller(depth: int = 16):
    """The ``torch.profiler.profile`` held in a local of the nearest caller
    that holds one (the harness's traced window), or None."""
    frame = sys._getframe(1)
    for _ in range(depth):
        if frame is None:
            return None
        for value in frame.f_locals.values():
            if isinstance(value, torch.profiler.profile):
                return value
        frame = frame.f_back
    return None


_last = (None, {})  # (the summary of the run read last, its table)


def of_run(ctx) -> dict:
    """The spans' table of the traced run ``ctx`` reads (cached per run);
    empty when the run was not traced or no profiler is found."""
    global _last
    if ctx.trace is None:
        return {}
    if _last[0] is not ctx.trace:
        prof = _profiler_of_caller()
        _last = (ctx.trace, of_profiler(prof) if prof is not None else {})
    return _last[1]


def total(ctx, names, field: str) -> float | None:
    """``field`` (``host_s`` or ``device_s``) summed over the spans ``names``
    of a traced run; None when the run was not traced, a span is missing (a
    program without it) or the sum is 0 (device time on the CPU)."""
    rows = of_run(ctx)
    if any(n not in rows for n in names):
        return None
    value = sum(rows[n][field] for n in names)
    return value if value > 0 else None


def ms_per(ctx, names, field: str, unit: str) -> float | None:
    """Milliseconds of ``total`` per unit of work, ``ctx.stats[unit]``: an
    optimizer step (``steps``) or an answered request (``units``)."""
    value, n = total(ctx, names, field), ctx.stats.get(unit)
    return None if value is None or not n else 1e3 * value / n
