#!/usr/bin/env python3
"""Time variants of the bf16 attention kernels side by side on one CUDA card
(the PyTorch/CUDA port, ``vimoclip_tpu_torch``).

Each variant is a copy of ``vimoclip_tpu_torch/csrc`` with an edit, placed
in ``build/variants/<name>/`` (git-ignored). All variants build together
(one nvcc per source and variant), then take turns, twice, at one shape,
at p = 0 and p = 0.1, through the port's wrappers with the variant's
libraries swapped in. Device time per call comes from ``torch.profiler``
by kernel name (warm, and with the 50 MB L2 flushed before each call), and
the results are held against the plain versions.

    python3 tools/time_bwd_variants.py NAME[,NAME...] [B,H,TQ,TK,D] [--kernels KIND]

KIND picks the kernels timed (and the default shape):
- ``k3k4``: the backward past 512 keys, K3 (``dq_wgmma``) and K4
  (``dkv_wgmma``), at (8, 8, 768, 768, 64);
- ``k2``: the single-pass backward, K2 (``dqkv_wgmma``, and
  ``dq_reduce`` where a variant adds its dq shares through scratch;
  ``dkv_kernel`` for the FMA K2 of earlier trees), at (8, 8, 512, 512, 64);
- ``fwd``: the forward, K1 (no lse, no dropout) and K1' (lse and dropout),
  ``fwd_wgmma`` (``mma_kernel`` in earlier trees), at (3, 8, 384, 384, 64).
A variant may be a copy of an earlier tree's ``csrc`` (the same C entry
points), so that it is timed in the same call as the current one.
Gradients are compared as the largest difference over the largest value of
each batch row, outputs as the largest difference. SDPA's call time (forward
+ backward for the backward kinds, forward for ``fwd``) closes the run.

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
KINDS = {
    "k3k4": (("dq_wgmma", "dkv_wgmma"), "8,8,768,768,64"),
    "k2": (("dqkv_wgmma", "dq_reduce", "dkv_kernel"), "8,8,512,512,64"),
    "fwd": (("fwd_wgmma", "mma_kernel"), "3,8,384,384,64"),
}
SOURCES = ("flash_attention_fwd", "flash_attention_bwd")


def _rel(a, b) -> float:
    diff = (a.float() - b.float()).abs().flatten(1).amax(1)
    return (diff / b.float().abs().flatten(1).amax(1).clamp_min(1.0)).max().item()


def _device_ms(torch, fn, kernels, iters: int = 20) -> dict[str, float]:
    """Device time per call of each of ``kernels`` (name substrings) over
    ``iters`` calls."""
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
        for k in kernels:
            if k in e.key and t > 0:
                out[k] = out.get(k, 0.0) + t / iters / 1e3
    return out


def build(names: list[str]) -> dict[str, dict[str, Path]]:
    from vimoclip_tpu_torch.ops.kernels import _build

    procs = {}
    for n in names:
        for src in SOURCES:
            out = VARIANTS / n / f"lib{src}.so"
            if out.exists():  # built by an earlier run of this command
                continue
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
                   str(VARIANTS / n / f"{src}.cu")]
            procs[n, src] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True))
    libs = {n: {src: VARIANTS / n / f"lib{src}.so" for src in SOURCES} for n in names}
    for (n, src), (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {n} {src}: nvcc exited {proc.returncode}\n{log}")
        print(f"[build] {n} {src}: " + json.dumps(ptxas_report(log)))
    return libs


def ptxas_report(log: str) -> dict[str, list[int]]:
    """``-Xptxas -v``'s registers and spill-store bytes of each wgmma kernel
    instantiation in an nvcc log, by demangled name."""
    import re
    import shutil

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if "wgmma" in m.group(1) else None
        elif name and "spill stores" in line:
            out[name] = [0, int(re.search(r"(\d+) bytes spill stores", line).group(1))]
        elif name and "Used" in line and name in out:
            out[name][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    if shutil.which("c++filt") and out:
        names = subprocess.run(["c++filt"], input="\n".join(out), capture_output=True,
                               text=True).stdout.splitlines()
        out = {re.sub(r"\(.*", "", d.replace("(anonymous namespace)::", "")).removeprefix("void ")
               : v for d, v in zip(names, out.values())}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", help="comma-separated variant directories under build/variants")
    ap.add_argument("shape", nargs="?", default=None, help="B,H,TQ,TK,D")
    ap.add_argument("--kernels", choices=sorted(KINDS), default="k3k4")
    args = ap.parse_intermixed_args()

    import torch

    if not torch.cuda.is_available():
        print("time_bwd_variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from vimoclip_tpu_torch.ops.kernels import _build
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa
    from vimoclip_tpu_torch.utils.device import describe_card

    smi = describe_card("cuda")
    print(smi)
    kernels, default_shape = KINDS[args.kernels]
    names = args.names.split(",")
    libs = build(names)
    b, h, tq, tk, d = map(int, (args.shape or default_shape).split(","))
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
            for src in SOURCES:
                _build._loaded[src] = ctypes.CDLL(str(libs[n][src].resolve()))
            for rate in (0.0, 0.1):
                seeds = fa.expand_seed(7, b, h, "cuda") if rate else None
                row = {"variant": n, "turn": turn, "rate": rate, "shape": [b, h, tq, tk, d]}
                if args.kernels == "fwd":
                    # K1 at p = 0 (serving), K1' with lse at the rate
                    if rate:
                        call = lambda: fa.forward_lse(q, k, v, mask, seeds, rate)
                        got = call()[0]
                    else:
                        call = lambda: fa.flash_attention(q, k, v, key_padding_mask=mask)
                        got = call()
                    ref = fa.flash_attention_reference(q, k, v, mask, rate, seed=seeds)
                    row["out_max_abs_err"] = (got.float() - ref.float()).abs().max().item()
                else:
                    out, lse = fa.forward_lse(q, k, v, mask, seeds, rate)
                    call = lambda: fa.backward_kernels(q, k, v, mask, seeds, rate, out, lse, grad)
                    got = call()
                    ref = fa.flash_attention_backward_reference(q, k, v, mask, out, lse, grad,
                                                                rate, seed=seeds)
                    row["grad_rel_err"] = {m: _rel(a, r)
                                           for m, a, r in zip(("dq", "dk", "dv"), got, ref)}
                row["warm_ms"] = _device_ms(torch, call, kernels)
                row["flushed_ms"] = _device_ms(torch, lambda: (flush.zero_(), call()), kernels)
                print(json.dumps(row) + f" [{smi}]", flush=True)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    bias = torch.where(mask, -1e9, 0.0)[:, None, None, :].bfloat16()

    def sdpa():
        o = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=bias,
                                           dropout_p=0.0 if args.kernels == "fwd" else 0.1)
        if args.kernels != "fwd":
            o.backward(grad)

    for _ in range(3):
        sdpa()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        sdpa()
    end.record()
    torch.cuda.synchronize()
    what = "fwd" if args.kernels == "fwd" else "fwd_bwd"
    print(json.dumps({f"sdpa_{what}_call_ms": start.elapsed_time(end) / 10}) + f" [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
