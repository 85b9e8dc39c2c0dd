"""Small stand-ins for the cells' files, so the tests can drive whole runs
on the CPU: the published widths and depths, with small frames (one to
four patches a frame), short clips and small pools."""

from __future__ import annotations

from perfbench import harness, registry


def bench() -> dict:
    return registry.load_benchmark(registry.HERE.parent)


def config(bench_: dict, name: str) -> dict:
    c = registry.config(bench_, name)
    c["teacher"]["image_size"] = c["student"]["image_size"] = 32
    c["serving"].update(frame_batch=16, length_bucket=16)
    c["data"].update(length_bucket=16, max_seq_len=64)
    c["training"]["num_workers"] = 2
    return c


def traffic(name: str) -> dict:
    t = registry.traffic(name)
    if "frame_hw" in t:
        t.update(frame_hw=[48, 72], pool_frames=64)
        t["lengths"].update(low=6, high=40, count=8)
        for key, value in (("batch", 32), ("check_frames", 16), ("check_requests", 4)):
            if key in t:
                t[key] = value
    else:
        t["lengths"].update(low=5, high=70, count=64)
        if "mean" in t["lengths"]:  # the same share past the cap as at full size
            t["lengths"]["mean"] = 110
        t["pool_rows"] = 256
    return t


def run(cell_name: str, seed: int = 2**31 + 11, seconds: float = 1.0, trace: bool = False,
        control: bool = False, limits: dict | None = None) -> dict:
    b = bench()
    cell = registry.workload(b, cell_name)
    return harness.run_cell(b, cell, seed, seconds, trace, device="cpu",
                            config=config(b, cell["config"]), traffic=traffic(cell["traffic"]),
                            limits=limits, control=control)
