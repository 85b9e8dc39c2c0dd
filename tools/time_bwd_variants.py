#!/usr/bin/env python3
"""Time variants of the attention kernels side by side on one CUDA card (the
PyTorch/CUDA port, ``vimoclip_tpu_torch``).

Each variant is a copy of ``vimoclip_tpu_torch/csrc`` with an edit, placed
in ``build/variants/<name>/`` (git-ignored). All variants build together
(one nvcc per source and variant), then take turns, twice, at each shape,
at p = 0 and p = 0.1, through the port's wrappers with the variant's
libraries swapped in. Device time per call comes from ``torch.profiler``
by kernel name (warm, and with the 50 MB L2 flushed before each call), and
the results are held against the plain versions.

    python3 tools/time_bwd_variants.py NAME[,NAME...] [B,H,TQ,TK,D[;...]] \
        [--kernels KIND] [--dtype bfloat16|float32]
    python3 tools/time_bwd_variants.py NAME[,NAME...] --steps [--dtype bfloat16]
    python3 tools/time_bwd_variants.py --prepare NAME=REV[,NAME=REV...]

KIND picks the kernels timed (and the default shape):
- ``k3k4``: the backward past 512 keys, K3 and K4, at (8, 8, 768, 768, 64);
- ``k2``: the single-pass backward, K2 (with ``dq_reduce`` where a variant
  adds its dq shares through scratch), at (8, 8, 512, 512, 64);
- ``fwd``: the forward, K1 (no lse, no dropout) and K1' (lse, at p = 0
  and 0.1), at (3, 8, 384, 384, 64);
- ``auto``: at each shape the forward, then K2 where the keys fit one
  512-key tile and K3 + K4 past it (as the wrappers launch them).
The kernels are told apart by name: in bf16 the wgmma kernels, above head
dim 128 both the paired ones (``fwd_pair_wgmma_kernel``,
``dkv_pair_wgmma_kernel``, ``dq_pair_wgmma_kernel``) and the per-slice
ones of earlier trees (``fwd_wide_wgmma_kernel``,
``dkv_wide_wgmma_kernel``, ``dq_wide_wgmma_kernel``), and the FMA or
``mma_kernel`` names of earlier trees; in float32 the three-pass
TF32 ``fwd_tf32``, ``dkv_tf32`` and ``dq_tf32`` (``dq_tf32_kernel`` and
``dq_tf32_wide_kernel``; and the FMA ``dq_kernel``,
``dq_wide_kernel``, ``fma_kernel``, ``fma_wide_kernel``, ``dkv_kernel`` and
``dkv_wide_kernel`` of trees before them).

A variant may be a copy of an earlier tree's ``csrc`` (the same C entry
points), so that it is timed in the same call as the current one:
``--prepare parent=HEAD`` writes ``git show HEAD:vimoclip_tpu_torch/csrc/...``
into ``build/variants/parent/`` (run it where the git history is; the card's
machine gets the copy), and ``--prepare change=`` copies the working tree's
``csrc``. Gradients are compared as the largest difference over the largest
value of each batch row, outputs as the largest difference. SDPA's call
time (forward + backward for the backward kinds, forward for ``fwd``, in
the run's dtype) closes each shape.

Prints one JSON line per (shape, variant, dropout rate, turn).

``--steps`` times whole train steps instead, with each variant's libraries
in turns (the variants in order, then in reverse; CUDA events around
``TFAMTrainer.train_step``, the host's launches included). In float32:
``chip_smoke.py`` phase 6's recipe under ``auto`` on its long batch (K1',
K3 and K4 at head dim 64), and the recipe at 2 and 1 heads (head dims 256
and 512) on ``flash`` at the 1024-frame bucket, where phase 17 measures
``auto``'s float32 turn. With ``--dtype bfloat16``: the recipe with
``half_precision`` at 2 and 1 heads on ``flash`` at the 512-frame (K1',
K2) and 1024-frame (K1', K3, K4) buckets. One JSON line per step.
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
# kernel names by kind and dtype (this tree's and earlier trees'), and the
# default shape
NAMES = {
    "bfloat16": {"k3k4": ("dq_wgmma", "dkv_wgmma", "dq_wide_wgmma", "dq_pair_wgmma",
                          "dkv_wide_wgmma", "dkv_pair_wgmma"),
                 "k2": ("dqkv_wgmma", "dkv_wide_wgmma", "dkv_pair_wgmma", "dq_reduce",
                        "keep_bits_kernel", "dkv_kernel"),
                 "fwd": ("fwd_wgmma", "fwd_wide_wgmma", "fwd_pair_wgmma", "mma_kernel")},
    "float32": {"k3k4": ("dq_tf32", "dq_kernel", "dq_wide_kernel", "dkv_tf32", "dkv_kernel",
                         "dkv_wide_kernel"),
                "k2": ("dkv_tf32", "dq_reduce", "dkv_kernel", "dkv_wide_kernel"),
                "fwd": ("fwd_tf32", "fma_kernel", "fma_wide_kernel")},
}
SHAPES = {"k3k4": "8,8,768,768,64", "k2": "8,8,512,512,64", "fwd": "3,8,384,384,64",
          "auto": "3,8,384,384,64"}
SOURCES = ("flash_attention_fwd", "flash_attention_bwd")
CSRC = "vimoclip_tpu_torch/csrc"


def prepare(specs: str) -> None:
    """``NAME=REV``: the csrc of git revision REV into build/variants/NAME
    (``NAME=`` alone: the working tree's csrc)."""
    import shutil

    for spec in specs.split(","):
        name, _, rev = spec.partition("=")
        out = VARIANTS / name
        if out.exists():
            shutil.rmtree(out)
        out.mkdir(parents=True)
        if not rev:
            for f in (ROOT / CSRC).iterdir():
                if f.suffix in (".cu", ".cuh"):
                    shutil.copy(f, out / f.name)
            continue
        files = subprocess.run(["git", "ls-tree", "--name-only", f"{rev}:{CSRC}"], cwd=ROOT,
                               capture_output=True, text=True, check=True).stdout.split()
        for f in files:
            if f.endswith((".cu", ".cuh")):
                (out / f).write_bytes(subprocess.run(["git", "show", f"{rev}:{CSRC}/{f}"],
                                                     cwd=ROOT, capture_output=True,
                                                     check=True).stdout)
        print(f"[prepare] {name}: {rev} ({len(files)} files)")


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


def ptxas_report(log: str, kinds: tuple[str, ...] = ("wgmma", "tf32")) -> dict[str, list[int]]:
    """``-Xptxas -v``'s registers and spill-store bytes of each kernel
    instantiation in an nvcc log whose mangled name holds one of ``kinds``
    (the wgmma and TF32 kernels by default), by demangled name."""
    import re
    import shutil

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if any(k in m.group(1) for k in kinds) else None
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


def _sdpa_ms(torch, F, q, k, v, mask, grad, backward: bool) -> float:
    """SDPA's call time (CUDA events, warm) on the same inputs: forward, or
    forward + backward with dropout 0.1."""
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    bias = torch.where(mask, -1e9, 0.0)[:, None, None, :].to(q.dtype)

    def sdpa():
        o = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=bias,
                                           dropout_p=0.1 if backward else 0.0)
        if backward:
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
    return start.elapsed_time(end) / 10


def time_steps(torch, libs: dict, names: list[str], smi: str, half: bool) -> None:
    """``--steps``: the train steps of the module docstring (bf16 ones with
    ``half``), each variant's libraries swapped in by turns."""
    import tempfile

    import numpy as np

    import chip_smoke as cs
    from vimoclip_tpu_torch.data.pipeline import to_device
    from vimoclip_tpu_torch.ops.kernels import _build
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cudnn.allow_tf32 = False
    setup = cs.training_setup(torch, 0)
    data = {"cfg": setup["cfg"], "train_items": setup["trainer"].train_loader.dataset,
            "val_items": setup["trainer"].val_loader.dataset}
    run = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    jobs = []
    if not half:
        trainer = cs._wide_trainer(torch, data, 8, run / "h8", impl="auto")
        jobs.append(("float32 auto, 8 heads, long batch", trainer,
                     to_device(setup["batches"][-1], trainer.device)))
    dtype = "bfloat16" if half else "float32"
    for heads in (2, 1):
        trainer = cs._wide_trainer(torch, data, heads, run / f"h{heads}", impl="flash",
                                   half=half)
        for bucket in (512, 1024) if half else (1024,):
            rng = np.random.default_rng(1)
            items = cs._clips(rng, rng.integers(bucket - 27, bucket + 1, 8), 512, 140,
                              f"w{bucket}-")
            jobs.append((f"{dtype} flash, {heads} heads", trainer,
                         to_device(trainer.collate(items), trainer.device)))
    for job, trainer, batch in jobs:
        row = {"job": job, "bucket": int(batch["embeddings"].shape[1]), "step_ms": {}}
        for n in names + names[::-1]:
            for src in SOURCES:
                _build._loaded[src] = ctypes.CDLL(str(libs[n][src].resolve()))
            fa.reset_launch_counts()
            ms = cs.cuda_ms(torch, lambda: trainer.train_step(batch), iters=4, warmup=1)
            row["step_ms"].setdefault(n, []).append(ms)
            row["launches_per_step"] = {k: c // 5 for k, c in fa.flash_attention.launches.items()
                                        if c}
        print(json.dumps(row) + f" [{smi}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="?", help="comma-separated variant directories under build/variants")
    ap.add_argument("shape", nargs="?", default=None, help="B,H,TQ,TK,D[;B,H,TQ,TK,D...]")
    ap.add_argument("--kernels", choices=sorted(SHAPES), default="k3k4")
    ap.add_argument("--dtype", choices=sorted(NAMES), default=None,
                    help="bfloat16 (the default for kernels) or float32 (the default for --steps)")
    ap.add_argument("--prepare", help="NAME=REV[,NAME=REV...]: write variants from git and stop")
    ap.add_argument("--steps", action="store_true",
                    help="time train steps per variant instead of kernels (float32, or bf16 "
                         "with --dtype bfloat16)")
    args = ap.parse_intermixed_args()
    if args.dtype is None:
        args.dtype = "float32" if args.steps else "bfloat16"
    if args.prepare:
        prepare(args.prepare)
        return 0
    if not args.names:
        ap.error("names are needed unless --prepare is given")

    import torch

    if not torch.cuda.is_available():
        print("time_bwd_variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from vimoclip_tpu_torch.ops.kernels import _build
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa
    from vimoclip_tpu_torch.utils.device import describe_card

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full float32
    smi = describe_card("cuda")
    print(smi)
    dtype = getattr(torch, args.dtype)
    names = args.names.split(",")
    libs = build(names)
    if args.steps:
        time_steps(torch, libs, names, smi, args.dtype == "bfloat16")
        return 0
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    for spec in (args.shape or SHAPES[args.kernels]).split(";"):
        b, h, tq, tk, d = map(int, spec.split(","))
        kinds = [args.kernels]
        if args.kernels == "auto":
            kinds = ["fwd", "k2" if tk <= fa.SINGLE_PASS_MAX_TK else "k3k4"]
        g = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn(b, h, tq, d, device="cuda", generator=g).to(dtype)
        k = torch.randn(b, h, tk, d, device="cuda", generator=g).to(dtype)
        v = torch.randn(b, h, tk, d, device="cuda", generator=g).to(dtype)
        mask = torch.rand(b, tk, device="cuda", generator=g) < 0.25
        mask[0] = True
        grad = torch.randn(b, tq, h, d, device="cuda", generator=g).to(dtype).transpose(1, 2)
        for kind in kinds:
            kernels = NAMES[args.dtype][kind]
            for turn in range(2):
                for n in names:
                    for src in SOURCES:
                        _build._loaded[src] = ctypes.CDLL(str(libs[n][src].resolve()))
                    # the forward: K1 at p = 0 (serving), K1' with lse at p = 0 and 0.1
                    runs = ([("k1", 0.0), ("k1_lse", 0.0), ("k1_lse", 0.1)] if kind == "fwd"
                            else [(kind, 0.0), (kind, 0.1)])
                    for what, rate in runs:
                        seeds = fa.expand_seed(7, b, h, "cuda") if rate else None
                        row = {"variant": n, "turn": turn, "rate": rate, "kernels": kind,
                               "call": what, "dtype": args.dtype, "shape": [b, h, tq, tk, d]}
                        if kind == "fwd":
                            if what == "k1_lse":
                                call = lambda: fa.forward_lse(q, k, v, mask, seeds, rate)
                                got = call()[0]
                            else:
                                call = lambda: fa.flash_attention(q, k, v, key_padding_mask=mask)
                                got = call()
                            ref = fa.flash_attention_reference(q, k, v, mask, rate, seed=seeds)
                            row["out_max_abs_err"] = (got.float() - ref.float()).abs().max().item()
                        else:
                            out, lse = fa.forward_lse(q, k, v, mask, seeds, rate)
                            call = lambda: fa.backward_kernels(q, k, v, mask, seeds, rate, out,
                                                               lse, grad)
                            got = call()
                            ref = fa.flash_attention_backward_reference(q, k, v, mask, out, lse,
                                                                        grad, rate, seed=seeds)
                            row["grad_rel_err"] = {m: _rel(a, r) for m, a, r in
                                                   zip(("dq", "dk", "dv"), got, ref)}
                        row["warm_ms"] = _device_ms(torch, call, kernels)
                        row["flushed_ms"] = _device_ms(torch, lambda: (flush.zero_(), call()),
                                                       kernels)
                        print(json.dumps(row) + f" [{smi}]", flush=True)
            what = "fwd" if kind == "fwd" else "fwd_bwd"
            print(json.dumps({"shape": [b, h, tq, tk, d], "dtype": args.dtype,
                              f"sdpa_{what}_call_ms": _sdpa_ms(torch, F, q, k, v, mask, grad,
                                                               kind != "fwd")})
                  + f" [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
