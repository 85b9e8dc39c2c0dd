#!/usr/bin/env python3
"""Time variants of the attention backward's bf16 K3/K4 kernels side by side
on one CUDA card (the PyTorch/CUDA port, ``vimoclip_tpu_torch``).

Each variant is a copy of ``vimoclip_tpu_torch/csrc`` with an edit, placed
in ``build/variants/<name>/`` (git-ignored). All variants build together
(one nvcc each), then take turns, twice, at one shape: the backward at
p = 0 and p = 0.1 through the port's wrapper with the variant's library
swapped in, K3's and K4's device time per call from ``torch.profiler`` by
kernel name (warm, and with the 50 MB L2 flushed before each call), and the
gradients against the plain version (largest difference over the largest
value of each batch row). SDPA's forward + backward call time closes the run.

    python3 tools/time_bwd_variants.py NAME[,NAME...] [B,H,TQ,TK,D]

Prints one JSON line per (variant, dropout rate, turn).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ROOT / "build" / "variants"
KERNELS = ("dq_wgmma", "dkv_wgmma")


def _rel(a, b) -> float:
    diff = (a.float() - b.float()).abs().flatten(1).amax(1)
    return (diff / b.float().abs().flatten(1).amax(1).clamp_min(1.0)).max().item()


def _device_ms(torch, fn, iters: int = 20) -> dict[str, float]:
    """Device time per call of each of ``KERNELS`` over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        for k in KERNELS:
            if k in e.key and t > 0:
                out[k] = out.get(k, 0.0) + t / iters / 1e3
    return out


def build(names: list[str]) -> dict[str, Path]:
    from vimoclip_tpu_torch.ops.kernels import _build

    procs = {}
    for n in names:
        out = VARIANTS / n / "lib.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
               str(VARIANTS / n / "flash_attention_bwd.cu")]
        procs[n] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    libs = {}
    for n, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {n}: nvcc exited {proc.returncode}\n{log}")
        spills = [line for line in log.splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        print(f"[build] {n}: " + json.dumps(spills))
        libs[n] = out
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", help="comma-separated variant directories under build/variants")
    ap.add_argument("shape", nargs="?", default="8,8,768,768,64", help="B,H,TQ,TK,D")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_bwd_variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from vimoclip_tpu_torch.ops.kernels import _build
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    names = args.names.split(",")
    libs = build(names)
    b, h, tq, tk, d = map(int, args.shape.split(","))
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(b, h, tq, d, device="cuda", generator=g).bfloat16()
    k = torch.randn(b, h, tk, d, device="cuda", generator=g).bfloat16()
    v = torch.randn(b, h, tk, d, device="cuda", generator=g).bfloat16()
    mask = torch.rand(b, tk, device="cuda", generator=g) < 0.25
    mask[0] = True
    grad = torch.randn(b, tq, h, d, device="cuda", generator=g).bfloat16().transpose(1, 2)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    for turn in range(2):
        for n in names:
            _build._loaded["flash_attention_bwd"] = ctypes.CDLL(str(libs[n].resolve()))
            for rate in (0.0, 0.1):
                seeds = fa.expand_seed(7, b, h, "cuda") if rate else None
                out, lse = fa.forward_lse(q, k, v, mask, seeds, rate)
                bwd = lambda: fa.backward_kernels(q, k, v, mask, seeds, rate, out, lse, grad)
                got = bwd()
                ref = fa.flash_attention_backward_reference(q, k, v, mask, out, lse, grad, rate,
                                                            seed=seeds)
                print(json.dumps({
                    "variant": n, "turn": turn, "rate": rate, "shape": [b, h, tq, tk, d],
                    "warm_ms": _device_ms(torch, bwd),
                    "flushed_ms": _device_ms(torch, lambda: (flush.zero_(), bwd())),
                    "grad_rel_err": {m: _rel(a, r) for m, a, r in zip(("dq", "dk", "dv"), got, ref)},
                }) + f" [{smi}]", flush=True)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    bias = torch.where(mask, -1e9, 0.0)[:, None, None, :].bfloat16()

    def sdpa():
        F.scaled_dot_product_attention(qr, kr, vr, attn_mask=bias, dropout_p=0.1).backward(grad)

    for _ in range(3):
        sdpa()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        sdpa()
    end.record()
    torch.cuda.synchronize()
    print(json.dumps({"sdpa_fwd_bwd_call_ms": start.elapsed_time(end) / 10}) + f" [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
