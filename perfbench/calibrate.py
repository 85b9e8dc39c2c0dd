"""Readings for the limits: runs one cell on several seeds in one process
(the kernel build and the CUDA context paid once) and prints, per seed, one
JSON line with every number the check computes and the end-to-end metrics.
``--control`` puts the cell's lower-precision control in the program's
place. The benchmark's own runs never run this.

    python3 -m perfbench.calibrate --workload <cell> --seeds 11,12,13 [--control]
        [--fault <name>] [--seconds 5]
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

from perfbench import faults, harness, registry


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.calibrate", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None, help="plant a fault (perfbench/faults.py)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("perfbench.calibrate: no card", file=sys.stderr)
        return 2
    bench = registry.load_benchmark()
    cell = registry.workload(bench, args.workload)
    driver = registry.traffic(cell["traffic"])["driver"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        with faults.planted(driver, args.fault) if args.fault else contextlib.nullcontext():
            line = harness.run_cell(bench, cell, seed, args.seconds, False, args.device,
                                    limits={}, control=args.control)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "fault": args.fault,
                          "numbers": line["numbers"], "metrics": line["metrics"],
                          "attempted": line["attempted"], "failed": line["failed"],
                          "memory_peak_bytes": line["device"]["memory_peak_bytes"],
                          "run_s": time.time() - t0}), flush=True)
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
