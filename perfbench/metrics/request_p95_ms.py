"""request_p95_ms: the 95th percentile of every request's latency in the
window, by nearest rank; a failed request counts as taking the whole
window."""

from perfbench.readers import latencies_with_failures, p95


def read(ctx):
    v = p95(latencies_with_failures(ctx))
    return None if v is None else 1e3 * v
