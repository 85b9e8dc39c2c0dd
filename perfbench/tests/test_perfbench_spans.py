"""``perfbench/spans.py`` on a synthetic profiler event list: host time
clipped to the window, device time found through the launch's correlation id
on the launching thread (two threads, nested spans), the window's edges, and
``summarize``'s fields unchanged by the program's spans; then on a real CPU
profiler, found by a metric's reader in its caller's locals."""

import types

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from perfbench import harness, registry, spans, trace


class Ev:
    """A profiler event as ``torch`` builds without ``activity_type``."""

    def __init__(self, name, start, end, device=False, corr=0, tid=1):
        self._v = (name, start, end, device, corr, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def correlation_id(self):
        return self._v[4]

    def device_resource_id(self):
        return self._v[5]


class KindEv(Ev):
    """The same with ``activity_type``, as newer ``torch`` builds carry."""

    def __init__(self, kind, *args, **kw):
        super().__init__(*args, **kw)
        self.kind = kind

    def activity_type(self):
        return self.kind


def _launch(kinds, name, t, corr, tid=1):
    return KindEv("cuda_runtime", name, t, t + 5, corr=corr, tid=tid) if kinds else \
        Ev(name, t, t + 5, corr=corr, tid=tid)


def _kernel(kinds, name, start, end, corr):
    return KindEv("kernel", name, start, end, device=True, corr=corr, tid=7) if kinds else \
        Ev(name, start, end, device=True, corr=corr, tid=7)


def _host(kinds, name, start, end, corr=0, tid=1):
    kind = "user_annotation" if name.startswith(("vimo.", "perfbench.")) else "cpu_op"
    return KindEv(kind, name, start, end, corr=corr, tid=tid) if kinds else \
        Ev(name, start, end, corr=corr, tid=tid)


def _events(kinds, program_spans=True):
    """Window [100, 1000] on thread 1; thread 2 is the autograd engine's."""
    h = lambda *a, **k: _host(kinds, *a, **k)
    ev = [h(trace.WINDOW, 100, 1000), h("perfbench.train_epoch", 110, 990)]
    if program_spans:
        ev += [
            h("vimo.train.data_wait", 50, 140),  # opened before the window
            h("vimo.train.step", 150, 600),
            h("vimo.train.forward", 160, 300),
            h("vimo.attn.fwd", 170, 260),
            h("vimo.train.optimizer", 400, 500),
            h("vimo.attn.bwd", 310, 390, tid=2),
            h("vimo.train.loss_fetch", 950, 1100),  # closed after it
            h("vimo.train.metric", 1200, 1300),  # outside the window
            # the device's mirror of a host range: neither a span nor work
            KindEv("gpu_user_annotation", "vimo.train.step", 250, 520, device=True, tid=7)
            if kinds else Ev("vimo.train.step", 250, 520, device=True, tid=7),
        ]
    ev += [
        _launch(kinds, "cudaLaunchKernel", 60, 10),
        _kernel(kinds, "k_load", 90, 120, 10),  # clipped at the window's start
        _launch(kinds, "cudaLaunchKernel", 200, 7),
        _kernel(kinds, "k_attn_fwd", 250, 350, 7),
        _launch(kinds, "cuLaunchKernelEx", 320, 9, tid=2),
        _kernel(kinds, "k_attn_bwd", 530, 700, 9),
        _launch(kinds, "cudaLaunchKernel", 450, 8),
        _kernel(kinds, "k_adamw", 460, 520, 8),
        _launch(kinds, "cudaMemcpyAsync", 960, 11),
        _kernel(kinds, "Memcpy DtoH", 980, 1050, 11),  # clipped at its end
        # a PyTorch op whose own id equals a launch's: not a launch
        h("aten::mm", 880, 890, corr=9, tid=2),
    ]
    return ev


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


@pytest.mark.parametrize("kinds", [False, True], ids=["no_activity_type", "activity_type"])
def test_spans_take_host_time_in_the_window_and_device_time_by_correlation(kinds):
    table = spans.of_profiler(_prof(_events(kinds)))
    ns = 1e-9
    want = {  # name: (count, host ns, device ns)
        "vimo.train.data_wait": (1, 40, 20),
        "vimo.train.step": (1, 450, 100 + 60),
        "vimo.train.forward": (1, 140, 100),
        "vimo.attn.fwd": (1, 90, 100),
        "vimo.train.optimizer": (1, 100, 60),
        "vimo.attn.bwd": (1, 80, 170),  # launched on thread 2, run after the step's span
        "vimo.train.loss_fetch": (1, 50, 20),
    }
    assert set(table) == set(want)
    for name, (count, host, device) in want.items():
        row = table[name]
        assert row["count"] == count, name
        assert row["host_s"] == pytest.approx(host * ns), name
        assert row["device_s"] == pytest.approx(device * ns), name


@pytest.mark.parametrize("kinds", [False, True], ids=["no_activity_type", "activity_type"])
def test_summary_fields_do_not_depend_on_the_program_spans(kinds):
    with_spans = trace.summarize(_prof(_events(kinds)))
    without = trace.summarize(_prof(_events(kinds, program_spans=False)))
    assert spans.of_profiler(_prof(_events(kinds, program_spans=False))) == {}
    assert with_spans.window_s == without.window_s
    assert with_spans.busy_s == without.busy_s
    assert with_spans.kernel_s == without.kernel_s
    total = lambda s: sum(sec for _, sec in s.idle_gaps)
    assert total(with_spans) == pytest.approx(total(without))
    # only the names move: a gap once put down to the benchmark's range now
    # names the program's span open there
    names = {n for n, _ in with_spans.idle_gaps} - {n for n, _ in without.idle_gaps}
    assert names and all(n.startswith(spans.PREFIX) for n in names)


def test_nested_spans_each_count_a_kernel_and_siblings_do_not():
    h = lambda *a, **k: _host(False, *a, **k)
    ev = [h("vimo.serve.request", 0, 100), h("vimo.serve.embed", 10, 40),
          h("vimo.serve.fetch", 50, 90), _launch(False, "cudaLaunchKernel", 20, 1),
          _kernel(False, "k", 60, 80, 1), _launch(False, "cudaLaunchKernel", 45, 2),
          _kernel(False, "k2", 85, 95, 2)]
    table = spans.table(ev, (0, 100), lambda e: e.device_type() == DeviceType.CUDA)
    assert table["vimo.serve.request"]["device_s"] == pytest.approx(30e-9)
    assert table["vimo.serve.embed"]["device_s"] == pytest.approx(20e-9)
    assert table["vimo.serve.fetch"]["device_s"] == 0.0  # ran in it, launched before it


def _traced(program_spans: bool):
    """A CPU profiler over a ``perfbench.window`` range holding two steps,
    each in a ``vimo.train.step`` span when ``program_spans``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.window_range():
            for _ in range(2):
                if program_spans:
                    with torch.profiler.record_function("vimo.train.step"):
                        torch.ones(64).sum()
                else:
                    torch.ones(64).sum()
    return prof


def _read_metric(name, prof, traced=True):
    """A metric's reader called as the harness calls it, with the run's
    profiler a local of the caller."""
    summary = trace.summarize(prof) if traced else None
    ctx = harness.Context("mn.tfam_train.f32_long", {}, {}, {"steps": 2}, 0.0, summary)
    return registry.metric_reader(name)(ctx)


@pytest.mark.parametrize("case", ["program_spans", "no_program_spans", "untraced"])
def test_readers_find_the_runs_profiler_and_leave_out_what_is_absent(case):
    prof = _traced(program_spans=case == "program_spans")
    host_ms = _read_metric("step_span_ms.train", prof, traced=case != "untraced")
    device_ms = _read_metric("optimizer_device_ms.train", prof, traced=case != "untraced")
    assert device_ms is None  # no device on the CPU, no span either
    if case == "program_spans":
        table = spans.of_profiler(prof)
        assert table["vimo.train.step"]["count"] == 2
        assert host_ms == pytest.approx(1e3 * table["vimo.train.step"]["host_s"] / 2)
        assert host_ms > 0
    else:
        assert host_ms is None
