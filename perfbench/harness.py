"""Runs one cell once: set-up, the measured window (traced or not), the
program's release, the check against the reference, the metrics, the line.

Set-up is everything from the process's start to the window's first unit
of work: imports, the CUDA context, the kernel build on a checkout's first
run (into the port's ``build/kernels``), weights from the seed, the inputs,
the first steps the check follows and one warm unit of every shape the
traffic uses. The reference runs after the window, once the memory peak has
been read and the program's state is freed."""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

from perfbench import registry

# the modules no process of the benchmark may hold (whole top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vimoclip_tpu")
# a traced run traces this much of its window at most: the trace's size and
# its reduction stay inside a run's time limit
TRACE_SECONDS = 8.0


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    cell: str
    config: dict
    traffic: dict
    stats: dict  # the driver's window: seconds, units, work counts, spans
    setup_s: float
    trace: object = None  # trace.TraceSummary in a traced run


@contextlib.contextmanager
def intra_op_threads(n: int | None):
    """torch's intra-op threads at ``n`` (a traffic mix's
    ``intra_op_threads``) while a run lasts; unset leaves torch's default."""
    import torch

    before = torch.get_num_threads()
    if n:
        torch.set_num_threads(int(n))
    try:
        yield
    finally:
        torch.set_num_threads(before)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", start: float | None = None, config: dict | None = None,
             traffic: dict | None = None, limits: dict | None = None,
             control: bool = False) -> dict:
    """The result line of one run (the contract's keys, ``checks`` last).
    ``config``, ``traffic`` and ``limits`` stand in for the files (tests
    pass small ones); ``control`` runs the cell's lower-precision control in
    the program's place."""
    start = time.time() if start is None else start
    traffic = traffic or registry.traffic(cell["traffic"])
    with intra_op_threads(traffic.get("intra_op_threads")):
        return _run_cell(bench, cell, seed, seconds, trace, device, start, config, traffic,
                         limits, control)


def _run_cell(bench, cell, seed, seconds, trace, device, start, config, traffic, limits,
              control) -> dict:
    import torch

    from perfbench import trace as tracing

    config = config or registry.config(bench, cell["config"])
    limits = registry.limits(cell["name"]) if limits is None else limits
    drv = registry.driver(traffic["driver"]).Driver(config, traffic, seed, device,
                                                     control=control)
    on_card = torch.device(device).type == "cuda"
    drv.setup()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - start
    summary = None
    if trace:
        with tracing.capture() as prof:
            with tracing.window_range():
                stats = drv.window(min(seconds, TRACE_SECONDS), traced=True)
        summary = tracing.summarize(prof)
    else:
        stats = drv.window(seconds, traced=False)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    drv.release()
    numbers = drv.check()
    missing = stats["failed"]
    checks = {"missing": {"value": missing, "limit": 0}}
    checks.update({k: {"value": numbers[k], "limit": v} for k, v in limits.items()})
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    ctx = Context(cell["name"], config, traffic, stats, setup_s, summary)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in registry.metrics_of(bench, cell["name"], kind):
        value = registry.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
    line = {"correct": correct, "attempted": stats["attempted"], "failed": stats["failed"],
            "metrics": metrics, "device": dev}
    if summary is not None:
        line["breakdown"] = summary.breakdown()
    if stats.get("launches") is not None:
        line["launches_per_unit"] = stats["launches"]
    line["numbers"] = numbers
    line["checks"] = checks
    return line


def _card() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"


def main(argv=None, start: float | None = None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        bench = registry.load_benchmark()
        cell = registry.workload(bench, args.workload)
    except LookupError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("perfbench: torch.cuda.is_available() is False; the benchmark runs on an "
              "NVIDIA card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} card(s), "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    try:
        import vimoclip_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"perfbench: the program vimoclip_tpu_torch is not importable here: {e}",
              file=sys.stderr)
        return 3
    line = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda", start)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process holds {', '.join(found)} after the window; "
              "no result", file=sys.stderr)
        return 4
    checks = line.pop("checks")
    line["card"] = _card()
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
