"""The window's arithmetic: a time per step over all the work and all the
time of the window, a 95th percentile over every request, and one stalled
unit moves each."""

import pytest

from perfbench import registry
from perfbench.harness import Context


def read(name, **stats):
    stats.setdefault("failed", 0)
    return registry.metric_reader(name)(Context("cell", {}, {}, stats, 0.0))


def test_step_time_is_the_window_over_its_steps():
    assert read("train_step_ms", steps=200, seconds=10.0) == pytest.approx(50.0)
    assert read("train_step_ms", steps=200, seconds=11.0) == pytest.approx(55.0)
    assert read("train_step_ms", steps=0, seconds=10.0) is None


def test_p95_is_over_every_request_and_counts_failures():
    lat = [0.1] * 19 + [0.2]
    assert read("request_p95_ms", latencies_s=lat, seconds=30.0) == pytest.approx(100.0)
    stalled = [0.1] * 18 + [2.0, 0.2]
    assert read("request_p95_ms", latencies_s=stalled, seconds=30.0) == pytest.approx(200.0)
    # a failed request counts as taking the whole window
    assert read("request_p95_ms", latencies_s=[0.1] * 18, seconds=30.0,
                failed=2) == pytest.approx(30000.0)
