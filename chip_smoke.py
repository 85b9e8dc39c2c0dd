#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vimoclip_tpu_torch``) on one
NVIDIA card:

    python3 chip_smoke.py [--seed N]

1. Device: the card's name and count, and nvidia-smi's name and power limit.
2. Build: every CUDA kernel from ``vimoclip_tpu_torch/csrc`` with nvcc for
   sm_90a (seconds and the ``-Xptxas -v`` report); the SASS of every bf16
   attention kernel (K1/K1', K2, K3, K4, and their wide kernels above head
   dim 128) must hold wgmma products (HGMMA) and TMA loads (UTMALDG); their
   registers and spill bytes, none in the paired kernels and in bf16 K1 at
   head dims 65-128; the bf16 K1, K2 and K3 CTAs that fit one SM at head
   dims 64, 128, 256 and 512 (K1 at 128: ``fwd_pp_wgmma_kernel`` without
   dropout, ``fwd_wgmma_kernel`` with it); and no spills in any
   instantiation of ``add_layer_norm_kernel``.
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   card at the serving shapes, with its time, the plain version's, one
   PyTorch library call's (a yardstick the port never calls) and the bound;
   then the times of bf16 K1 at head dims 65-128 (``fwd_pp_wgmma_kernel``)
   at the SigLIP towers' shapes, beside the kernel it replaced.
4. Serving path: the full-width serving cascade (ViT-B/16 teacher, ViT-B/32
   student, TFAM d512/8 heads/4 layers cross-attention, 140 classes) on
   weights drawn from ``--seed``, answering one request of three clips, with
   the kernel launch counts of that request (``add_layer_norm``: 24 a tower
   call, two tower calls a window), and checked against the same
   predictor on the eager attention path; then the full-width SigLIP
   So400m/14 tower (27 blocks, 16 heads of 72, the attention-pooling head)
   at 384 px and at 224 px against its eager path, on the same weights, with
   the launches of each tower call (every block's and the head's attention
   on ``fwd_pp_wgmma_kernel``, every LayerNorm but the head's one
   ``add_layer_norm`` launch); then the fused residual add + LayerNorm +
   cast alone against its plain version at the towers' shapes (hidden 768
   and 1152, with no delta and with a bf16 one), and timed at the SigLIP
   teacher's window beside its bytes bound and the three PyTorch passes it
   replaced.
5. Training kernels vs plain: the attention forward's lse/dropout variant
   (K1') and the backward kernels (K2; K3 + K4 past 512 keys) against their
   plain versions under the same Philox keep mask, with and without
   dropout, at the TFAM training shapes and at every shape that phase 6's
   batches give them, with their times (also with the 50 MB L2 flushed
   before each call), the plain versions', SDPA's (forward, and forward +
   backward; device time, and call time with CUDA events) and the bounds;
   at K2's main shape also the K3 + K4 pair on the same inputs, as a second
   yardstick; two backward calls must agree bit for bit, and the kept
   fraction at p = 0.1 must sit within 5 sigma of 0.9.
6. Training path: ``TFAMTrainer`` at the AK recipe's full width (TFAM d512,
   8 heads, 4 layers, ff 2048, cross-attention, dropout 0.1, 140 classes;
   batch 8, AdamW 1e-4, bf16 compute) on synthetic paired embeddings made
   from ``--seed``: its own train step over one epoch of 40 clips of 60-500
   frames and one batch with a 700-1000-frame clip, with the kernel launches
   of each step; one ``validate`` pass; 15 steps on one batch must lower the
   loss; one dropout-0 step on the flash path against the eager path; step
   time, clips/s, peak memory and one profiled step; the long batch's warm
   step time and one profiled long step (device busy and idle share); and
   train steps with
   dropout at the 128-, 256- and 512-frame buckets on the eager path and on
   the kernels, and eval-mode steps (``eval_step``, no dropout) at the 128-
   to 2048-frame buckets, which set where ``attention_impl: auto`` turns to
   them.
7. K5 vs plain: the fused uint8 normalisation against its plain version,
   bit for bit, in float32 and bfloat16, at the stage-1 training step's
   frames (232, 224, 224, 3), an export chunk (128, 224, 224, 3) and an odd
   misaligned view (3, 17, 31, 3), with its time (L2 flushed before each
   call, and warm; each the median of three traces), the plain version's, the bound and the achieved GB/s
   (no single PyTorch call computes it).
8. Stage-1 training: ``StudentTrainer`` with ViT-B/32 at full width (12
   layers x 768, 12 heads, patch 32), batch 8, 29 motion frames per
   segment, bf16 compute, Adam 1e-5, on synthetic segments from
   ``--seed``: the MN recipe (224x224 frames, 12 classes, CE) through
   ``train()`` over one 6-batch epoch and its evaluate, K5 once per train
   step and per eval batch; the AK recipe (360x640 frames, the resize
   branch, 140 classes, BCE weight 9) for three steps with no K5; 15 steps
   on one batch must lower its loss; a grad_accum=2 step against a
   grad_accum=1 step from the same state; step time, segments/s, frames/s,
   peak memory and one profiled step.
9. Motion export: ``MotionEmbeddingExporter._embed_chunk`` on two
   128-frame chunks and a 77-frame tail at 224x224 with the trained
   student, K5 once per chunk, equal to the trainer's own tower.
10. Teacher extraction: ``ClipExtractor.extract`` on synthetic videos made
    from ``--seed`` and fed through its decode seam (OpenCV and h5py are not
    assumed on the card's machine). The AK teacher, ViT-B/16 at full width on random
    weights, bf16, batch 256, four decode threads, six 360x640 videos of
    120-700 frames (1,803 frames, 8 dispatches, packing across videos and a
    padded tail): each video equal to its frames run alone in padded
    256-frame batches (rel. L2 <= 1e-3, bitwise expected); warm frames/s
    (the second pass) and peak memory; ``stream_rows=128`` chunks equal to
    the whole videos while one reader fails after two chunks; one profiled
    dispatch and one profiled pass (device ms, idle share). The MN teacher,
    ViT-B/32 on 224x224 frames: K5 once per dispatch, equal to the
    sequential run. K1 at the
    towers' shapes (256, 12, 197, 197, 64) and (256, 12, 50, 50, 64) on
    q/k/v split from one packed projection: TMA legality, against its plain
    version, its device ms beside SDPA's and the eager path's; both towers
    on ``attention_impl="flash"`` against the default eager path (frames/s,
    12 K1 launches per dispatch, per-frame cosine). One 129-frame 360x640
    chunk through ``frame_diff`` on the card, bitwise equal to the CPU.
11. The serving daemon: ``DynamicBatcher`` (8 videos, 10 ms) and the HTTP
    frontend (``make_http_server``, ``serve_http`` on a thread) on 127.0.0.1
    over phase 4's predictor (``batch_invariant``), fed six clips from
    ``--seed`` (three 360x640, 120-300 frames; three 224x224, 64-250
    frames) through a stand-in for the ``read_video`` name of ``serving``
    (OpenCV is not assumed on the card's machine). Eight client threads POST two rounds
    of 16 requests of 1-2 clips (top_k 3 or 5), cold then warm: every answer
    200, coalescing seen in ``/stats``, every record equal to a solo
    ``predict_batch`` of its clip and the raw probabilities within 1e-3, K1
    launches 8 per predictor call, K5 launches over the 224x224 clips and
    none for a request of 360x640 clips only; warm requests/s, p50/p95
    latency and peak memory; one profiled coalesced call; ``predict_batch``
    over the six clips against a loop of ``predict`` (the pooled/serial
    ratio); a drain with a request in flight (answered 200, then new
    connections refused).
12. ``vimo-benchmark-torch``'s device section (``_bench_gpu``) at its CLI
    defaults: ViT-B/16 extraction frames/s on 128 360x640 frames, TFAM
    clips/s on 8 clips of 450 frames, ``device_memory_stats()``.
13. The opt-in accelerators (int8 matmuls, ToMe, the fidelity probe):
    ``_int_mm`` bit for bit against the exact product at 8, 16, 17 and 512
    rows and at the ViT-B/16 blocks' shapes (timed beside bf16); K1 against
    its plain version at every token count the ToMe schedules leave
    (ViT-B/16 r = 16: 197 to 21; ViT-B/32 r = 4: 50 to 8) on q/k/v of the
    merged stream, with limits shown to refuse a key dropped or added at
    the tail; both towers at batch 256, bf16, exact / int8 / ToMe / int8 +
    ToMe on eager attention and on K1 (frames/s, dispatch device ms,
    per-frame cosine against exact; K1 against eager held per variant, and
    with the eager run's merges replayed on both); the fidelity probe on
    frames from the decode seam; ``vimo-predict-torch``
    (``cli.predict.main``) with ``--quantize int8 --token-merge 16
    --verify-fidelity 8`` on reference-format files of phase 4's weights,
    two 360x640 clips, K1 8 times per predictor call, then
    ``FidelityError`` at ``--fidelity-threshold 0.99999``.
14. Data and tensor parallelism (``vimoclip_tpu_torch/parallel``) at full
    width: (a) the AK TFAM recipe of phase 6 in a one-rank NCCL group
    (``data_parallel: -1``: the mesh, the collectives and the global dropout
    draws), its losses over phase 6's six batches equal to phase 6's within
    1e-6, K1' and K2 8 times a step, its warm step time beside phase 6's;
    (b) the MN student recipe of phase 8 the same way, its best validation
    loss and checkpoint equal to phase 8's within 1e-6, K5 once per step
    and eval batch; (c) ViT-B/16 extraction with two replicas on
    ``["cuda:0", "cuda:0"]`` over 560 224x224 frames, within 1e-3 rel. L2
    of one replica, K5 once per replica dispatch, frames/s of both; (d) the
    serving predictor of phase 4 with two replicas of each tower, within
    1e-3 of phase 4's probabilities, K1 8 times a call; (e) two ranks on
    ``cuda:0`` over gloo with CUDA tensors (spawned), one dropout-0.1 step
    of the AK recipe at data 2 held to (a)'s first step (loss 1e-4,
    gradients 5e-3 rel. L2), K1' and K2 8 times on each rank.
15. Sequence and pipeline parallelism (``parallel/sequence.py``,
    ``parallel/pipelining.py``) at the AK recipe's full width: (a) the ring
    over 2 and 4 in-process shards (``LocalRing``) at (8, 8, 2048, 2048,
    64) in bf16 with dropout 0.1 and padded keys (padding-only blocks)
    against one K1' + K3/K4 call on the whole sequence with the same seeds:
    output 1e-2, lse 1e-4, gradients 5e-3 rel. L2; each offset kernel's
    keep bits (K1', K2 at 512-key blocks, K3 at 1024) equal to the cut of
    the whole call's, bit for bit; K1' n times per shard, K3 + K4 (n = 2)
    or K2 (n = 4) n times per shard in the backward; times against the one
    call; (b) seq 2: two gloo ranks on ``cuda:0`` take one AK step with
    dropout 0.1 at the 2048-frame bucket, held to the one-card step on the
    same batch and seeds (loss 1e-4, gradients 5e-3 rel. L2), K1'/K3/K4 16
    times on each rank, and a warm step's time; (c) pipe 2 with two
    microbatches on the same two ranks: dropout 0 against one card (logits
    and loss 1e-4, gradients 5e-3 rel. L2), and with dropout 0.1 two passes
    over phase 6's six batches whose mean loss falls, K1'/K2 per rank; (d)
    pipe 2 x seq 2 on four gloo ranks on ``cuda:0`` at the 512 bucket with
    dropout 0 against one card. Gloo sends and receives through pinned
    host memory; the kernels run on the card.
16. The Table-2 and memory tools (``tools/run_table2_sweep_torch.py``,
    ``tools/run_table2_fullgeom_torch.py``, ``tools/bench_memory_torch.py``):
    (a) phase 6's recipe at 2 heads (head dim 256) takes one train step
    with dropout on ``flash`` (the wide K1' and K2 8 times each, the loss
    within 1e-4 of the ``xla`` step from the same state and generator) and
    under ``attention_impl: auto``, which runs the route phase 17 measured
    and equals that route's step within 1e-6; (b) the order-only corpus (384 videos) by
    the memory route on the card, the tiny teacher in float32, four videos
    held to the same route on the CPU (rel. L2 1e-4), frames/s; (c) the
    float32 K1' and K2 at (8, 8, 16, 16, 64), the shape of every train step
    of the full-width contrast, against their plain versions under one
    Philox keep mask, with and without dropout, timed beside them and
    SDPA; (d) the four fusion modes through ``run_mode`` at full width (d512,
    8 heads, 4 layers, ff 2048, float32) for 3 epochs: steps, best val mAP,
    K1' and K2 launches held to the attention sites (8 + 8 a step in
    cross mode), a warm step's ms and clips/s and one profiled step's idle
    share on a fresh trainer; cross's epoch-3 mean train loss below epoch
    1's; then the memory tool's 32:1 and 32:4 arms (subprocesses), the
    accumulated peak below the dense one.
17. Head dims above 128 (TFAM d 512 at 2 and 1 heads): (a) K1 at (3, 2,
    384, 384, 256), K1' and K2 at (8, 2, 512, 512, 256) and (8, 1, 512,
    512, 512), K3 and K4 at (8, 2, 768, 768, 256) and (8, 1, 768, 768, 512)
    on the wide kernels against their plain versions, float32 and bf16,
    dropout 0.1 and 0, timed as in phase 5 beside SDPA and the backend it
    ran; their keep bits at head dims 256, 384 and 512 equal to the plain
    mask; (b) ``TFAMTrainer`` on
    phase 6's recipe in float32 (the trainer's default) at 2 and 1 heads on
    ``flash``: one epoch of phase 6's batches with the long one (K3 + K4),
    the wide launches of every step, ``validate`` (K1), 15 steps on one
    batch that lower the loss, a dropout-0 step against ``xla`` (loss 1e-4,
    gradients 5e-3 rel. L2), warm step time and idle share beside eager
    attention's and phase 6's 8-head step; the recipe in bf16
    (``half_precision``, the paired kernels) at 2 and 1 heads on ``flash``,
    launches counted from 0 over a train step at the 512-frame bucket (K1',
    K2), one at 1024 frames (K1', K3 + K4), an eval step (K1) and 15 steps
    that lower the loss, then its warm step time and idle share at both
    buckets; then ``auto``'s measurement:
    train steps with dropout 0.1 and eval steps without, eager against the
    kernels, at the 128- to 2048-frame buckets, 2 and 1 heads, float32 and
    bf16; (c) the ring on 2 in-process shards at (8, 2, 2048, 2048, 256)
    against one call as phase 15(a) holds it, and a seq-2 step at 2 heads
    as two gloo ranks on ``cuda:0`` held to the one-card step.
18. The card machine's decoders, probed (nothing is installed): whether
    ``cv2`` and ``av`` import, ``pkg-config --modversion`` of the four libav
    libraries ``native/Makefile`` needs, whether ``make -C native`` builds
    ``native/libvimo_dataplane.so`` and ``data/native.py::available()`` is
    then true; where OpenCV can write the corpus, ``tools/bench_decode_torch.py``
    at its defaults, whose line must hold a positive rate for each backend
    that runs. What the machine lacks is printed, not failed.
19. ``bench_torch.py`` as a user runs it (a subprocess, its four paths at
    ``bench.py``'s recipes and the card tests): its line must hold finite,
    positive rates in every section, a TFAM step that launched K1' and K2
    eight times each and nothing else, K1 eight times a serving request, a
    pooled/serial probability difference within 1e-5, and the card tests
    passed (at least 400); printed as ``[bench]`` with the card's name and
    power limit. Its launches join the kernels line.
20. A JSON line of the kernels, then ``{"ok": true, "device": {...}}`` last.

Any failed check raises: the script exits non-zero and prints no result. It
needs a CUDA card (exits 2 without one) and the package beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

HERE = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet; dense), for the bounds.
HBM_BYTES_PER_S = 3.35e12
# float32: the TF32 tensor cores' 495 TFLOP/s over the three passes each
# float32 product takes there (csrc/tf32.cuh), for every float32 kernel; every
# float32 row also gives the bound on the FMA units (67 TFLOP/s), where the
# float32 kernels of earlier trees ran (the parent in tools/time_bwd_variants.py)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
FMA_FLOPS = 67e12

# Kernel vs plain: float32 sums in another order (~1e-6); bfloat16 rounds p
# at another running max and stores a bf16 output (rel. 2^-8 at |o| ~ 1).
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# flash vs eager attention through the whole bf16 cascade, on probabilities:
# the two paths round bf16 scores and weights at different points.
PATH_TOL = 1e-2

# (B, H, Tq, Tk, D): self- and cross-attention at the request's bucketed
# lengths, an unbucketed ragged key length, and T=2048 (32 key tiles).
KERNEL_SHAPES = [(3, 8, 384, 384, 64), (3, 8, 384, 256, 64),
                 (3, 8, 384, 299, 64), (3, 8, 2048, 2048, 64)]
MAIN_SHAPE = KERNEL_SHAPES[0]

# Training kernels: the AK recipe's batch of 8 at a 384-frame bucket (self-
# and cross-attention, K2), a 1024-frame bucket (K3 + K4), and a ragged case;
# the shapes of phase 6's batches are added at run time.
TRAIN_SHAPES = [(8, 8, 384, 384, 64), (8, 8, 384, 256, 64),
                (8, 8, 1024, 1024, 64), (2, 2, 300, 299, 64),
                # past 512 keys: ragged Tq != Tk at head dim 32, head dim 128
                # (two 64-column chunks), and Tq below one tile
                (2, 2, 700, 613, 32), (2, 2, 530, 1000, 128), (2, 2, 40, 777, 64)]
# lse (elementwise) and gradients (relative to the largest |value| of their
# batch row): float32 sums in other orders; bf16 rounds P and dS to bf16 at
# each product (2^-8) after float32 scores that differ in their last bits,
# and stores bf16
LSE_TOL = 1e-4
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the device-side kernels of each wrapper by dtype (profiler entry names),
# and how many of them one call launches
# (float32 K1, K1', K2 and K4: one three-pass TF32 template each at every
# head dim; K3 one up to head dim 128 and one above)
_FWD_NAMES = {"float32": ("fwd_tf32_kernel",), "bfloat16": ("fwd_wgmma_kernel",)}
_FWD_WIDE_NAMES = {"float32": ("fwd_tf32_kernel",), "bfloat16": ("fwd_pair_wgmma_kernel",)}
_DQKV_F32 = ("dkv_tf32_kernel", "dq_reduce_kernel<float")
KERNEL_NAMES = {
    "fwd": _FWD_NAMES, "fwd_lse": _FWD_NAMES,
    # bf16 K1 without dropout at head dims 65-128 (no float32 kernel)
    "fwd_pp": {"float32": (), "bfloat16": ("fwd_pp_wgmma_kernel",)},
    "bwd_dqkv": {"float32": _DQKV_F32,
                 "bfloat16": ("dqkv_wgmma_kernel", "dq_reduce_kernel<__nv_bfloat16")},
    "bwd_dq": {"float32": ("dq_tf32_kernel",), "bfloat16": ("dq_wgmma_kernel",)},
    "bwd_dkv": {"float32": ("dkv_tf32_kernel",), "bfloat16": ("dkv_wgmma_kernel",)},
    # above head dim 128 (one template serves wide K2 and K4; in bf16 the
    # paired kernels take two 128-column slices per CTA)
    "fwd_wide": _FWD_WIDE_NAMES, "fwd_lse_wide": _FWD_WIDE_NAMES,
    "bwd_dqkv_wide": {"float32": _DQKV_F32,
                      "bfloat16": ("dkv_pair_wgmma_kernel", "dq_reduce_kernel<__nv_bfloat16",
                                   "keep_bits_kernel")},
    "bwd_dq_wide": {"float32": ("dq_tf32_wide_kernel",), "bfloat16": ("dq_pair_wgmma_kernel",)},
    "bwd_dkv_wide": {"float32": ("dkv_tf32_kernel",), "bfloat16": ("dkv_pair_wgmma_kernel",)},
}
# launched only with dropout (the wide bf16 K2's keep bits)
DROPOUT_ONLY_KERNELS = ("keep_bits_kernel",)
# each named kernel launches once per call
KERNEL_PER_CALL = {kind: {dt: len(names) for dt, names in by_dtype.items()}
                   for kind, by_dtype in KERNEL_NAMES.items()}
# the kernels whose SASS must hold HGMMA and UTMALDG, by library: every
# bf16 one and the float32 TF32 ones
WGMMA_KERNELS = {"flash_attention_fwd": ("fwd_wgmma_kernel", "fwd_pair_wgmma_kernel",
                                         "fwd_pp_wgmma_kernel", "fwd_tf32_kernel"),
                 "flash_attention_bwd": ("dqkv_wgmma_kernel", "dq_wgmma_kernel",
                                         "dkv_wgmma_kernel", "dq_pair_wgmma_kernel",
                                         "dkv_pair_wgmma_kernel", "dkv_tf32_kernel",
                                         "dq_tf32_kernel", "dq_tf32_wide_kernel")}
# the kernels that must build without spills (the bf16 paired kernels above
# head dim 128, and the bf16 K1 at 65-128)
NO_SPILL_KERNELS = ("fwd_pair_wgmma_kernel", "dkv_pair_wgmma_kernel", "dq_pair_wgmma_kernel",
                    "fwd_pp_wgmma_kernel")
# the other kernels that must build without spills, by library:
# add_layer_norm holds a row in registers (4 * VEC floats a lane, 64 at
# VEC=16)
NO_SPILL_LIBS = {"layer_norm": ("add_layer_norm_kernel",)}
# ops per B*H*Tq*Tk*D: QK^T and PV forward; the backward recomputes QK^T and
# adds dO V^T, dS K, dS^T Q and P^T dO (K3 leaves out the last two, K4 dS K)
OPS_PER_ELEMENT = {"fwd_lse": 4, "bwd_dqkv": 10, "bwd_dq": 6, "bwd_dkv": 8}
# flash vs eager through the bf16 model, one dropout-0 step: the eager path
# rounds scores and weights to bf16, the kernels keep them in float32.
# Measured on an H100 80GB HBM3: loss 5e-7 apart, gradients 3.1e-4 relative
# L2; the limits leave 200x and 16x room.
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 5e-3
# buckets of the eager-against-kernels train steps with dropout on, and of
# the eval-mode steps without it
CROSSOVER_BUCKETS = (128, 256, 512)
NODROP_BUCKETS = (128, 256, 512, 1024, 2048)

# K5 (fused normalise): (shape, storage offset in bytes) — the MN training
# step's frames (8 segments x 29), an export chunk, a teacher-extraction
# dispatch of EXTRACT_BATCH 224x224 frames (phase 10), and an odd view whose
# element count is no multiple of 48 and whose start is misaligned
NORMALIZE_SHAPES = [((232, 224, 224, 3), 0), ((128, 224, 224, 3), 0),
                    ((256, 224, 224, 3), 0), ((3, 17, 31, 3), 5)]
STUDENT_SEQ = 30  # teacher frames per segment; 29 motion frames
EXPORT_CHUNK = 128
# grad_accum=2 against one full-batch step from the same state, bf16 compute:
# the microbatches' products differ from the full batch's in bf16 rounding.
# Measured on an H100 80GB HBM3 at 700 W: losses 6.7e-8 relative apart, gradients
# 1.8e-3 relative L2; the limits leave 150x and 11x room.
ACCUM_LOSS_TOL = 1e-5
ACCUM_GRAD_TOL = 2e-2
# Teacher extraction (phase 10): the AK teacher (ViT-B/16) at the CLI's batch
# of 256 over six 360x640 videos, 1,803 frames in 8 dispatches (packing across
# videos, a padded tail); the MN teacher (ViT-B/32) over 224x224 frames.
EXTRACT_BATCH = 256
EXTRACT_LENGTHS = (120, 200, 300, 450, 700, 33)
EXTRACT_HW = (360, 640)
MN_EXTRACT_LENGTHS = (300, 170, 90)  # 560 frames: 3 dispatches
EXTRACT_STREAM_ROWS = 128
# The extractor against each video run alone in padded batches of the same
# shape: the same kernels compute every row, so bitwise is expected; the limit
# is 1e-3 relative L2 per video.
EXTRACT_TOL = 1e-3
# flash (K1) against eager towers, per-frame cosine of the bf16 embeddings.
# Measured on an H100 80GB HBM3 at 700 W: at least 0.999982 (ViT-B/32) and
# 0.999985 (ViT-B/16), a gap of 1.8e-5; the limit's gap of 5e-4 leaves 27x room.
TOWER_COS_MIN = 0.9995

# The serving daemon (phase 11): six clips from --seed (three 360x640, the
# resize branch; three 224x224, K5), two rounds of 16 requests of 1-2 clips
# from eight client threads through the HTTP frontend and the batcher. Pooled
# against solo probabilities: the fusion runs over another batch and padded
# length, so bf16 products may round differently; the limit is 1e-3.
SERVE_CLIPS = (((360, 640), (120, 200, 300)), ((224, 224), (64, 150, 250)))
SERVE_REQUESTS = 16
SERVE_CLIENTS = 8
SERVE_MAX_BATCH = 8
SERVE_WAIT_MS = 10.0
SERVE_TOL = 1e-3
# phase 13: the opt-in accelerators. Each tower's ToMe r: ViT-B/16 at 197
# tokens, r = 16 (down to 21); ViT-B/32 at 50, r = 4 (down to 8)
ACCEL_TOWERS = {"vit_b_16": (197, 16), "vit_b_32": (50, 4)}
ACCEL_BATCH = EXTRACT_BATCH
# (rows, K, N): below and at _int_mm's 16-row floor, and the ViT-B/16 blocks'
# packed q/k/v and MLP-out products at the extraction batch
INT_MM_SHAPES = [(8, 768, 2304), (16, 768, 2304), (17, 768, 2304), (512, 768, 2304),
                 (ACCEL_BATCH * 197, 768, 2304), (ACCEL_BATCH * 197, 3072, 768)]
# K1 at the ToMe token counts, on q/k/v ~ N(0, 1) (the packed projection of
# the layer-normed merged stream, as a block makes them), whose attention is
# peaked enough that one key moves the output. Two readings against the plain
# version: max|d| / max|ref|, and the gain sum(got * ref) / sum(ref * ref) - 1,
# which a zero-filled key left unmasked shifts (it shrinks every row by its
# weight) where max|d| cannot see it. At every count the run also takes both
# readings of three planted faults (the last key dropped; one key past the end
# read as real, the next frame's first token; a zero key past the end) and
# checks that the limits refuse each one. Readings on an H100 80GB HBM3 at
# 700 W over the 24 counts: K1 at most 5.5e-3 and |gain| 1.7e-6; the dropped
# and the next-token key at least 0.51 in max|d|/max|ref|; the zero key's gain
# -3.0e-3 at 197 tokens (its max|d|/max|ref| only 5.7e-3) to -7.6e-2 at 8.
K1_TOME_REL = 2e-2
K1_TOME_GAIN = 1e-4
# bf16 towers on K1 against eager attention, per-frame cosine (phase 13).
# Int8 codes and ToMe merges follow each path's rounding, so the variants are
# held apart. Readings on an H100 80GB HBM3 at 700 W: exact 0.99998, int8
# 0.99978, ToMe 0.9909, int8 + ToMe 0.9895 (the least over both towers).
ACCEL_EAGER_COS_MIN = {"exact": TOWER_COS_MIN, "int8": 0.999, "tome": 0.97,
                       "int8+tome": 0.97}
# the ToMe tower on K1 and on eager attention, both given the merges the eager
# run chose (``bipartite_merge``'s ``plan``): only the kernel's rounding is
# left. Read 0.99998 on both towers (H100 80GB HBM3, 700 W), as exact reads.
ACCEL_REPLAY_COS_MIN = 0.9999
ACCEL_CLIPS = (96, 160)  # frames of the two 360x640 clips the CLI predicts
ACCEL_PROBE = 8  # --verify-fidelity N
ACCEL_STRICT = 0.99999  # a threshold the approximations cannot reach

# Phase 14 (data and tensor parallelism). In a one-rank NCCL group every
# collective is the identity and every draw is the one-process draw, so the
# trainers' losses equal phases 6 and 8's (bit for bit expected).
PAR_LOSS_TOL = 1e-6
# Two ranks over gloo on one card: each rank runs the bf16 products on 4 of
# the 8 rows, where cuBLAS may pick other kernels than for 8 rows; held like
# flash against eager (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL).
PAR_GLOO_RANKS = 2
# Phase 15 (sequence and pipeline parallelism). The ring against one call in
# bf16: each ring block's K1' rounds its output to bf16 before the float32
# merge, and the backward kernels round each block's dq, dk and dv to bf16
# before the float32 sums; held like the kernels against their plain
# versions (KERNEL_TOL, LSE_TOL) and the steps like flash against eager
# (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL).
SEQ_SHAPE = (8, 8, 2048, 2048, 64)
SEQ_RINGS = (2, 4)
SEQ_STEP_BUCKET = 2048
# Phase 16 (the Table-2 tools). (a) A TFAM of 2 heads at d 512 (head dim 256)
# takes one step on each route: ``auto`` runs the same code as the route it
# picks, so the same loss is expected bit for bit; the limit is 1e-6.
HEAD_DIM_HEADS = 2
AUTO_LOSS_TOL = 1e-6
# Phase 17 (head dims above 128): TFAM d 512 at 2 and 1 heads (head dims 256
# and 512). Kernel vs plain at the shapes phase 6's recipe gives the wide
# kernels: K1' and K2 at the 512 bucket, K3 and K4 at 768 keys, K1 at
# serving's (3, 384) batch; the ring at seq 2 over 2048 frames.
WIDE_HEADS = (2, 1)
WIDE_K1_SHAPE = (3, 2, 384, 384, 256)
WIDE_TRAIN_SHAPES = [(8, 2, 512, 512, 256), (8, 1, 512, 512, 512), (8, 2, 768, 768, 256),
                     (8, 1, 768, 768, 512)]
WIDE_MAIN_SHAPES = {"fwd_lse": (8, 2, 512, 512, 256), "bwd_dqkv": (8, 2, 512, 512, 256),
                    "bwd_dq": (8, 2, 768, 768, 256), "bwd_dkv": (8, 2, 768, 768, 256)}
WIDE_SEQ_SHAPE = (8, 2, 2048, 2048, 256)
WIDE_CROSSOVER_BUCKETS = (128, 256, 512, 1024, 2048)
# the bf16 wide training path: K1' and K2 at 512 frames, K1', K3 and K4 at 1024
WIDE_HALF_BUCKETS = (512, 1024)
# (b) The memory-route corpus on the card against the CPU, four videos, the
# tiny teacher in float32 on both: float32 sums in other orders; rel. L2 1e-4.
CORPUS_CHECK_VIDEOS = 4
CORPUS_TOL = 1e-4
# (c) The float32 K1' and K2 at the shape every train step of the full-width
# contrast gives them: batch 8, 8 heads, the 16-frame bucket, head dim 64.
FULLGEOM_KERNEL_SHAPE = (8, 8, 16, 16, 64)
# (d) Each fusion mode for three epochs; attention sites per layer
FULLGEOM_EPOCHS = 3
FULLGEOM_SITES = {"cross": 2, "concat_t": 1, "rgb": 1, "flow": 1}
# Phase 18 (the decoders): the libraries ``native/Makefile`` takes from
# pkg-config, and each subprocess's time limit (the tool at its defaults
# decodes 1,200 360x640 frames three times per backend)
DECODE_LIBS = ("libavformat", "libavcodec", "libavutil", "libswscale")
DECODE_TIMEOUT_S = 300
# Phase 19 (``bench_torch.py``): its time limit, the launches of a TFAM
# train step at the AK recipe (t = 512 keys fit K2's single pass: K1' and
# K2 at each of the 8 attention sites), of one serving request (K1 at the
# 8 sites), and the fewest card tests its record may show passed
BENCH_TIMEOUT_S = 600
BENCH_TFAM_STEP_LAUNCHES = {"fwd_lse": 8, "bwd_dqkv": 8}
BENCH_REQUEST_LAUNCHES = {"fwd": 8}
BENCH_MIN_CARD_TESTS = 400


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls, CUDA
    events around the run (after ``warmup`` calls). When the host launches
    slower than the card runs, this is the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20, names: tuple[str, ...] = (),
              per_call: int | None = None, required: bool = True) -> float | None:
    """Mean device busy time per call of ``fn``: the durations of every
    kernel and copy it ran on the card (only those whose name contains one
    of ``names``, when given), from a ``torch.profiler`` trace (CUPTI) over
    ``iters`` calls after one warm-up call. With ``required`` False, five
    traces without a device event give None instead of failing.

    Within a long run a trace now and then comes back one event short, or
    empty (seen after SDPA with dropout). So the calls sit between two
    short spin kernels that the count leaves out, and a trace is taken when
    it holds ``per_call`` x ``iters`` matching events or, without
    ``per_call``, as many as the trace before it. After five traces the
    fullest one is taken, with a warning."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    want = None if per_call is None else per_call * iters
    last, fullest = None, (0, 0.0)
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if _device_us(e) > 0 and "spin_kernel" not in e.key
                and (not names or any(n in e.key for n in names))]
        got = (sum(e.count for e in hits), sum(_device_us(e) for e in hits))
        if got[0] and got[0] == (last if want is None else want):
            return got[1] / iters / 1e3
        last, fullest = got[0], max(fullest, got)
    if not required and fullest[0] == 0:
        return None
    check(fullest[0] > 0, f"the profiler recorded no device time {names or ''}")
    print(f"[profiler] warning: five traces of {names or 'a call'} disagree on their "
          f"device events (expected {want}); the fullest ({fullest[0]}) is taken",
          file=sys.stderr)
    return fullest[1] / iters / 1e3


def _device_us(event) -> float:
    """Device time of a profiler entry that ran on the card (kernels,
    copies); 0 for host-side entries, whose device time would count twice."""
    from torch.autograd import DeviceType

    if event.device_type != DeviceType.CUDA:
        return 0.0
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def profile_request(torch, run, smi: str, label: str = "profile") -> dict:
    """One request (or step) under ``torch.profiler`` (host and card): wall time,
    device busy time and idle share, and the largest device and host
    entries. The profiler's own host overhead is inside this wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    top_dev = sorted(events, key=_device_us, reverse=True)[:8]
    top_host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    out = {
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "top_device_ms": [[e.key[:70], _device_us(e) / 1e3, e.count] for e in top_dev],
        "top_host_self_ms": [[e.key[:70], e.self_cpu_time_total / 1e3, e.count]
                             for e in top_host],
    }
    print(f"[{label}] " + json.dumps(out) + f" [{smi}]")
    return out


def phase_device(torch) -> tuple[str, int, str]:
    from vimoclip_tpu_torch.utils.device import describe_card

    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = describe_card("cuda:0")
    print(f"[device] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)
    return name, count, smi


def phase_build() -> None:
    import ctypes

    from vimoclip_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {len(built)} kernel source(s) in {time.perf_counter() - t0:.2f} s")
    for b in built.values():
        print(f"[build] {b.name}: {b.seconds:.2f} s -> {b.path.relative_to(HERE)}")
        print(b.log.strip())
    sys.path.insert(0, str(HERE / "tools"))
    from time_bwd_variants import ptxas_report

    for lib, kernels in WGMMA_KERNELS.items():
        sass_check(built[lib].path, kernels)
        regs = ptxas_report(built[lib].log)
        print("[ptxas] " + json.dumps(regs))
        for k in NO_SPILL_KERNELS:
            if k in kernels:
                found = {name: v for name, v in regs.items() if k in name}
                check(bool(found) and all(spill == 0 for _, spill in found.values()),
                      f"{k}: no ptxas report, or spill stores in some instantiation: {found}")
    for lib, kernels in NO_SPILL_LIBS.items():
        regs = ptxas_report(built[lib].log, kinds=kernels)
        check(len(regs) > 0 and all(spill == 0 for _, spill in regs.values()),
              f"{lib}: no ptxas report of {kernels}, or spill stores in some instantiation: "
              f"{regs}")
        print("[ptxas] " + json.dumps({lib: {"instantiations": len(regs),
                                             "max_registers": max(r for r, _ in regs.values()),
                                             "spill_stores": 0}}))
    # CTAs per SM of the bf16 K1/K1', K2 and K3 at D = 64 and 128 (K1 at 128
    # without dropout: fwd_pp_wgmma_kernel), and of their wide kernels at 256
    # and 512
    occupancy = {}
    for lib, entry, kind in (("flash_attention_fwd", "vimo_flash_attention_fwd_occupancy", "fwd"),
                             ("flash_attention_bwd", "vimo_flash_attention_bwd_dqkv_occupancy",
                              "bwd_dqkv"),
                             ("flash_attention_bwd", "vimo_flash_attention_bwd_dq_occupancy",
                              "bwd_dq")):
        fn = getattr(ctypes.CDLL(str(built[lib].path)), entry)
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        for d in (64, 128, 256, 512):
            for drop in (0, 1):
                n = fn(d, drop)
                check(n > 0, f"{entry}({d}, {drop}) = {n}")
                occupancy[f"{kind} D={d} p{'>0' if drop else '=0'}"] = n
    print("[occupancy] " + json.dumps(occupancy))


def sass_check(lib: Path, kernels: tuple[str, ...]) -> dict:
    """Count, in the SASS of ``lib`` (``cuobjdump -sass``), each named
    kernel's tensor-core products (HGMMA, from wgmma) and TMA loads (UTMALDG);
    fails unless every instantiation of each kernel has both."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts: dict[str, list[int]] = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = next((k for k in kernels if k in m.group(1)), None)
            if name:
                counts.setdefault(name, []).append([0, 0])
            continue
        if name:
            counts[name][-1][0] += "HGMMA" in line
            counts[name][-1][1] += "UTMALDG" in line
    for k in kernels:
        check(bool(counts.get(k)) and all(h and t for h, t in counts[k]),
              f"{k}: no HGMMA or no UTMALDG in some instantiation's SASS: {counts.get(k)}")
    print("[sass] " + json.dumps({k: {"instantiations": len(v), "hgmma": [h for h, _ in v],
                                      "utmaldg": [t for _, t in v]} for k, v in counts.items()}))
    return counts


def sdpa_backend(torch, fn) -> str:
    """The backend SDPA ran in ``fn``, from the kernel names of one traced
    call: flash, efficient (CUTLASS memory-efficient), cudnn, or math (its
    separate softmax kernel). A long run's trace now and then holds no or
    too few device events (``device_ms``), so a trace that shows neither a
    fused kernel nor the softmax is taken again, up to five times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        keys = " ".join(e.key for e in prof.key_averages() if _device_us(e) > 0).lower()
        for backend, marks in (("flash", ("flash_fwd", "flash_bwd", "pytorch_flash")),
                               ("efficient", ("fmha", "efficient_attention", "cutlassf")),
                               ("cudnn", ("cudnn",)), ("math", ("softmax",))):
            if any(m in keys for m in marks):
                return backend
    return "unknown"


def phase_kernels(torch, seed: int, smi: str, shapes=KERNEL_SHAPES,
                  main_shape=MAIN_SHAPE) -> dict:
    import torch.nn.functional as F

    from vimoclip_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_reference,
        launch_kind,
    )

    rows = {}  # the main shape's row of each dtype
    g = torch.Generator(device="cuda").manual_seed(seed)
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for shape in shapes:
            b, h, tq, tk, d = shape
            q = torch.randn(b, h, tq, d, device="cuda", generator=g).to(dtype)
            k = torch.randn(b, h, tk, d, device="cuda", generator=g).to(dtype)
            v = torch.randn(b, h, tk, d, device="cuda", generator=g).to(dtype)
            mask = torch.rand(b, tk, device="cuda", generator=g) < 0.25
            mask[0] = True  # one fully masked row: uniform over the real keys
            out = flash_attention(q, k, v, key_padding_mask=mask)
            ref = flash_attention_reference(q, k, v, mask)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            check(err <= KERNEL_TOL[dtype_name],
                  f"flash_attention {dtype_name} {shape}: max|d| {err} > "
                  f"{KERNEL_TOL[dtype_name]}")
            bias = torch.where(mask, -1e9, 0.0)[:, None, None, :].to(dtype)
            kernel = lambda: flash_attention(q, k, v, key_padding_mask=mask)
            plain = lambda: flash_attention_reference(q, k, v, mask)
            library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
            kind = launch_kind("fwd", d, dtype)
            ms = device_ms(torch, kernel, names=KERNEL_NAMES[kind][dtype_name],
                           per_call=KERNEL_PER_CALL[kind][dtype_name])
            plain_ms, library_ms = (device_ms(torch, f) for f in (plain, library))
            item = dtype.itemsize
            moved = (2 * b * h * tq * d + 2 * b * h * tk * d) * item + b * tk
            flops = 4 * b * h * tq * tk * d  # QK^T and PV
            t_bytes = moved / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
            row = {
                "dtype": dtype_name, "shape": list(shape), "max_abs_err": err,
                "tol": KERNEL_TOL[dtype_name], "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "library_backend": sdpa_backend(torch, library),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "call_ms": cuda_ms(torch, kernel),  # host launch time included
            }
            if dtype_name == "float32":  # the FMA kernel's bound, beside
                row["fma_bound_ms"] = max(t_bytes, flops / FMA_FLOPS * 1e3)
            print(f"[kernel] flash_attention_{kind} " + json.dumps(row) + f" [{smi}]")
            if shape == main_shape:
                rows[dtype_name] = row
    check(set(rows) == {"float32", "bfloat16"}, "no measurement at the main path's shape")
    return {**rows["bfloat16"], "float32": rows["float32"]}


# The SigLIP So400m/14 towers' K1 calls at a serving window of 128 frames
# (16 heads of 72): the 384 px teacher's 729 tokens, the 224 px student's
# 256, and the attention-pooling head's one query over 729.
TOWER_K1_SHAPES = [(128, 16, 729, 729, 72), (128, 16, 256, 256, 72), (128, 16, 1, 729, 72)]
# add_layer_norm (csrc/layer_norm.cu) at the teacher's window: 128 frames x
# 729 tokens of hidden 1152, a bf16 residual branch and bf16 out (12 B an
# element: x and the branch read, x_out and h written)
ADD_LN_SHAPE = (128 * 729, 1152)
# and checked at the CLIP cascade's windows: the ViT-B/16 teacher's 128 x
# 197 tokens and the ViT-B/32 student's 128 x 50, hidden 768, and the
# SigLIP student's 128 x 256 at 1152
ADD_LN_CHECKED = ((128 * 197, 768), (128 * 50, 768), (128 * 256, 1152))


def phase_tower_k1(torch, seed: int, smi: str, shapes=TOWER_K1_SHAPES) -> dict:
    """bf16 K1 at head dims 65-128 (``fwd_pp_wgmma_kernel``) at the towers'
    shapes: checked against the plain version, then its device time beside
    its bound, the kernel it replaced (``fwd_wgmma_kernel`` with two
    64-column chunks, still K1''s: timed through K1' at p = 0, which also
    stores lse), the plain version and SDPA (a yardstick the port never
    calls). Returns the rows."""
    import torch.nn.functional as F

    from vimoclip_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_reference,
        forward_lse,
    )

    rows = []
    g = torch.Generator(device="cuda").manual_seed(seed)
    for shape in shapes:
        b, h, tq, tk, d = shape
        q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=g).bfloat16()
                   for t in (tq, tk, tk))
        before = flash_attention.launches["fwd_pp"]
        out = flash_attention(q, k, v)
        ref = flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
        check(flash_attention.launches["fwd_pp"] == before + 1, f"{shape}: K1 not on fwd_pp")
        err = (out.float() - ref.float()).abs().max().item()
        check(err <= KERNEL_TOL["bfloat16"], f"fwd_pp {shape}: max|d| {err}")
        moved = (2 * b * h * tq * d + 2 * b * h * tk * d) * 2
        flops = 4 * b * h * tq * tk * d
        t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bfloat16"] * 1e3
        row = {
            "shape": list(shape), "max_abs_err": err,
            "ms": device_ms(torch, lambda: flash_attention(q, k, v),
                            names=KERNEL_NAMES["fwd_pp"]["bfloat16"], per_call=1),
            "parent_ms": device_ms(torch, lambda: forward_lse(q, k, v, None, None, 0.0),
                                   names=("fwd_wgmma_kernel",), per_call=1),
            "plain_ms": device_ms(torch, lambda: flash_attention_reference(q, k, v), iters=5),
            "library_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        row["roofline"] = row["bound_ms"] / row["ms"]
        print("[tower_k1] " + json.dumps(row) + f" [{smi}]")
        rows.append(row)
    return rows


def _rel(a, b) -> float:
    """Largest |a - b| over the largest |b| (at least 1) of the same batch
    row: a fully masked row's gradients (P = 1 on each of its keys) dwarf
    the other rows'."""
    diff = (a.float() - b.float()).abs().flatten(1).amax(1)
    return (diff / b.float().abs().flatten(1).amax(1).clamp_min(1.0)).max().item()


def _lse_err(a, b) -> float:
    """Elementwise |a - b| / max(|b|, 1): a fully masked row's lse is -1e9."""
    return ((a - b).abs() / b.abs().clamp_min(1.0)).max().item()


def _bound(kind: str, dtype_name: str, shape, item: int, rate: float,
           peak: float | None = None) -> tuple[float, str]:
    """Least time for the work: every input read once, every output written
    once, at 3.35 TB/s; or the products at ``peak``, else the type's peak
    on the tensor cores (float32: three TF32 passes a product)."""
    b, h, tq, tk, d = shape
    qo, kv = b * h * tq * d * item, b * h * tk * d * item
    rows = 4 * b * h * tq  # one float32 per query row (lse, delta)
    small = b * tk + (4 * b * h if rate else 0)  # mask, seeds
    moved = {"fwd_lse": 2 * qo + 2 * kv + rows,           # q, k, v -> o, lse
             "bwd_dqkv": 3 * qo + 4 * kv + 2 * rows,       # q, k, v, dO, lse, D -> dq, dk, dv
             "bwd_dq": 3 * qo + 2 * kv + 2 * rows,         # ... -> dq
             "bwd_dkv": 2 * qo + 4 * kv + 2 * rows}[kind] + small
    ops = OPS_PER_ELEMENT[kind] * b * h * tq * tk * d
    if peak is None:
        peak = PEAK_FLOPS[dtype_name]
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_training_kernels(torch, seed: int, smi: str, main_shapes: dict,
                           shapes=TRAIN_SHAPES, dtypes=("float32", "bfloat16")) -> dict:
    """K1' and K2 / K3 + K4 against their plain versions, timed, at
    ``shapes`` and the main path's shapes in each of ``dtypes``; returns the
    p = 0.1 rows at ``main_shapes[kind]``, each kernel's most launched shape:
    the last dtype's under ``kind``, the others' under ``kind@dtype``."""
    import torch.nn.functional as F

    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa

    shapes = list(dict.fromkeys([*shapes, *main_shapes.values()]))
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    # every kernel is also timed with the 50 MB L2 flushed before each call
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    main = {}
    for dtype_name in dtypes:
        dtype = getattr(torch, dtype_name)
        for shape in shapes:
            b, h, tq, tk, d = shape
            q = torch.randn(b, h, tq, d, device="cuda", generator=g).to(dtype)
            k = torch.randn(b, h, tk, d, device="cuda", generator=g).to(dtype)
            v = torch.randn(b, h, tk, d, device="cuda", generator=g).to(dtype)
            mask = torch.rand(b, tk, device="cuda", generator=g) < 0.25
            mask[0] = True  # one fully masked row
            # dO as the merge of heads hands it back: (B, Tq, H, D) storage
            grad = torch.randn(b, tq, h, d, device="cuda", generator=g).to(dtype).transpose(1, 2)
            bias = torch.where(mask, -1e9, 0.0)[:, None, None, :].to(dtype)
            kinds = ["bwd_dqkv"] if tk <= fa.SINGLE_PASS_MAX_TK else ["bwd_dq", "bwd_dkv"]
            for rate in (0.0, 0.1):
                seeds = fa.expand_seed(seed + tq + tk, b, h, "cuda") if rate else None
                out, lse = fa.forward_lse(q, k, v, mask, seeds, rate)
                ref, ref_lse = fa.flash_attention_reference(q, k, v, mask, rate, seed=seeds,
                                                            return_lse=True)
                grads = fa.backward_kernels(q, k, v, mask, seeds, rate, out, lse, grad)
                again = fa.backward_kernels(q, k, v, mask, seeds, rate, out, lse, grad)
                ref_grads = fa.flash_attention_backward_reference(
                    q, k, v, mask, out, lse, grad, rate, seed=seeds)
                torch.cuda.synchronize()
                case = f"{dtype_name} {shape} p={rate}"
                out_err = (out.float() - ref.float()).abs().max().item()
                check(out_err <= KERNEL_TOL[dtype_name],
                      f"K1' output {case}: max|d| {out_err} > {KERNEL_TOL[dtype_name]}")
                lse_err = _lse_err(lse, ref_lse)
                check(lse_err <= LSE_TOL, f"K1' lse {case}: {lse_err} > {LSE_TOL}")
                grad_err = {}
                for name, a, r in zip(("dq", "dk", "dv"), grads, ref_grads):
                    grad_err[name] = _rel(a, r)
                    check(grad_err[name] <= GRAD_TOL[dtype_name],
                          f"backward {name} {case}: {grad_err[name]} > {GRAD_TOL[dtype_name]}")
                check(all(torch.equal(x, y) for x, y in zip(grads, again)),
                      f"backward {case}: two calls differ")
                kept = None
                if rate:
                    keep = fa.dropout_keep_mask(seeds, tq, tk, rate)
                    kept = keep.float().mean().item()
                    sigma = (rate * (1 - rate) / keep.numel()) ** 0.5
                    check(abs(kept - (1 - rate)) <= 5 * sigma,
                          f"kept fraction {kept} at p={rate} {case}")

                item = dtype.itemsize
                fwd = lambda: fa.forward_lse(q, k, v, mask, seeds, rate)
                plain_fwd = lambda: fa.flash_attention_reference(
                    q, k, v, mask, rate, seed=seeds, return_lse=True)
                sdpa_fwd = lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=bias, dropout_p=rate)
                plain_bwd = lambda: fa.flash_attention_backward_reference(
                    q, k, v, mask, out, lse, grad, rate, seed=seeds)
                qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))

                def sdpa_train():
                    o = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=bias,
                                                       dropout_p=rate)
                    o.backward(grad)

                bwd = lambda: fa.backward_kernels(q, k, v, mask, seeds, rate, out, lse, grad)
                # every profiled time first: after SDPA with dropout the
                # profiler's trace may hold no device events, so SDPA (the
                # yardstick) is timed last: with CUDA events (its call time,
                # which the host's launches bound at small shapes) and then
                # its device time, which is the library_ms compared with the
                # kernels' device time (the call time where no trace holds a
                # device event). K3 and K4 run in one backward; the
                # profiler's kernel names split their times.
                calls = [("fwd_lse", fwd)] + [(kind, bwd) for kind in kinds]
                names = {kind: tuple(n for n in KERNEL_NAMES[fa.launch_kind(kind, d)][dtype_name]
                                     if rate or n not in DROPOUT_ONLY_KERNELS)
                         for kind, _ in calls}
                kernel_ms = {kind: device_ms(torch, call, iters=10, names=names[kind],
                                             per_call=len(names[kind]))
                             for kind, call in calls}
                # a call of several kernels (K2: its pass and the dq sum), each apart
                parts_ms = {kind: {n: device_ms(torch, call, iters=10, names=(n,), per_call=1)
                                   for n in names[kind]}
                            for kind, call in calls if len(names[kind]) > 1}
                flushed_ms = {kind: device_ms(torch, lambda call=call: (flush.zero_(), call()),
                                              iters=10, names=names[kind],
                                              per_call=len(names[kind]))
                              for kind, call in calls}
                pair = None
                if dtype_name == "bfloat16" and shape == main_shapes.get("bwd_dqkv"):
                    pair = _k3k4_pair(torch, fa, (q, k, v, mask, seeds, rate, out, lse, grad),
                                      ref_grads)
                plain_ms = {"fwd": device_ms(torch, plain_fwd, iters=10),
                            "bwd": device_ms(torch, plain_bwd, iters=10)}
                sdpa_call_ms = {"fwd": cuda_ms(torch, sdpa_fwd),
                                "bwd": cuda_ms(torch, sdpa_train, iters=10)}
                sdpa_dev_ms = {"fwd": device_ms(torch, sdpa_fwd, iters=10, required=False),
                               "bwd": device_ms(torch, sdpa_train, iters=10, required=False)}
                sdpa_ms = {k: sdpa_call_ms[k] if sdpa_dev_ms[k] is None else sdpa_dev_ms[k]
                           for k in sdpa_call_ms}
                sdpa_backends = {"fwd": sdpa_backend(torch, sdpa_fwd),
                                 "bwd": sdpa_backend(torch, sdpa_train)}
                for kind, _ in calls:
                    bound_ms, bound_by = _bound(kind, dtype_name, shape, item, rate)
                    fma_bound = (_bound(kind, dtype_name, shape, item, rate, FMA_FLOPS)[0]
                                 if dtype_name == "float32" else None)
                    stage = "fwd" if kind == "fwd_lse" else "bwd"
                    row = {
                        "kernel": kind, "dtype": dtype_name, "shape": list(shape),
                        "dropout": rate, "ms": kernel_ms[kind],
                        "flushed_ms": flushed_ms.get(kind), "parts_ms": parts_ms.get(kind),
                        "plain_ms": plain_ms[stage], "library_ms": sdpa_ms[stage],
                        "library_timing": "events" if sdpa_dev_ms[stage] is None else "device",
                        "library_backend": sdpa_backends[stage],
                        "library_call_ms": sdpa_call_ms[stage],
                        "achieved_TF_per_s": OPS_PER_ELEMENT[kind] * b * h * tq * tk * d
                        / (kernel_ms[kind] * 1e-3) / 1e12,
                        "bound_ms": bound_ms, "bound_by": bound_by, "fma_bound_ms": fma_bound,
                        "max_abs_err": out_err if kind == "fwd_lse" else max(
                            (a.float() - r.float()).abs().max().item()
                            for a, r in zip(grads, ref_grads)),
                        "max_abs_ref": max(r.float().abs().max().item() for r in ref_grads),
                        "lse_rel_err": lse_err, "grad_rel_err": grad_err,
                        "kept_fraction": kept,
                    }
                    if kind == "bwd_dqkv" and pair is not None:
                        row["k3k4_pair"] = pair
                    print("[train-kernel] " + json.dumps(row) + f" [{smi}]")
                    if rate and shape == main_shapes.get(kind):
                        main[kind if dtype_name == dtypes[-1] else f"{kind}@{dtype_name}"] = row
    check({k for k in main if "@" not in k} == set(main_shapes),
          f"main-shape rows missing: {sorted(main)}")
    return main


def _k3k4_pair(torch, fa, args, ref_grads) -> dict:
    """The bf16 K3 + K4 pair on K2's inputs (keys within one 512-key tile),
    launched through ``_launch_bwd`` as ``backward_kernels`` launches them past
    512 keys: their gradients against the plain version, and their device
    time per call (warm) beside K2's."""
    q, k, v, mask, seeds, rate, out, lse, grad = args
    b, h, tq, d = q.shape
    tk = k.shape[2]
    q, k, v, grad = (fa.tma_operand(t) for t in (q, k, v, grad))
    delta = (grad.float() * out.float()).sum(dim=-1).contiguous()
    dq, dk, dv = (torch.empty(b, h, n, d, dtype=q.dtype, device="cuda") for n in (tq, tk, tk))
    keep_bits = (torch.empty((b, h, -(-tk // 64), -(-tq // 64) * 64, 2), dtype=torch.int32,
                             device="cuda") if rate else None)
    launch = (q, k, v, mask, seeds, rate, lse, delta, grad)

    def pair():
        fa._launch_bwd("bwd_dq", *launch, dq, None, None, keep_bits)
        fa._launch_bwd("bwd_dkv", *launch, None, dk, dv, keep_bits)

    pair()
    torch.cuda.synchronize()
    err = {n: _rel(a, r) for n, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref_grads)}
    check(max(err.values()) <= GRAD_TOL["bfloat16"], f"K3 + K4 at K2's shape: {err}")
    names = (KERNEL_NAMES[fa.launch_kind("bwd_dq", d)]["bfloat16"]
             + KERNEL_NAMES[fa.launch_kind("bwd_dkv", d)]["bfloat16"])
    return {"ms": device_ms(torch, pair, iters=10, names=names, per_call=len(names)),
            "grad_rel_err": err}


def _predictor_states(torch, seed: int):
    from vimoclip_tpu_torch.config import TFAMModelConfig
    from vimoclip_tpu_torch.models import init_parameters_
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
    from vimoclip_tpu_torch.models.tfam import TFAM

    g = torch.Generator(device="cuda").manual_seed(seed)
    teacher_cfg, student_cfg = ClipVisionConfig.vit_b_16(), ClipVisionConfig.vit_b_32()
    tfam_cfg = TFAMModelConfig(d_model=512, nhead=8, num_layers=4,
                               dim_feedforward=2048, use_cross_attention=True,
                               attention_impl="flash")
    states = {
        "teacher": init_parameters_(ClipVisionEncoder(teacher_cfg), g).state_dict(),
        "student": init_parameters_(ClipVisionEncoder(student_cfg), g).state_dict(),
        "tfam": init_parameters_(TFAM(tfam_cfg, num_classes=140), g).state_dict(),
    }
    return teacher_cfg, student_cfg, tfam_cfg, states


def phase_main_path(torch, seed: int, smi: str) -> dict:
    import dataclasses

    import numpy as np

    from vimoclip_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        reset_launch_counts,
    )
    from vimoclip_tpu_torch.ops.kernels.layer_norm import add_layer_norm
    from vimoclip_tpu_torch.ops.preprocess import frame_diff
    from vimoclip_tpu_torch.serving import ViMoCLIPPredictor

    teacher_cfg, student_cfg, tfam_cfg, states = _predictor_states(torch, seed)

    def predictor(cfg):
        return ViMoCLIPPredictor(
            teacher_state=states["teacher"], teacher_config=teacher_cfg,
            student_state=states["student"], student_config=student_cfg,
            tfam_state=states["tfam"], tfam_config=cfg, num_classes=140,
            frame_batch=128, length_bucket=128, max_seq_len=2048,
            half_precision=True, device="cuda")

    rng = np.random.default_rng(seed)
    videos = [rng.integers(0, 256, (t, 360, 640, 3), dtype=np.uint8)
              for t in (120, 200, 300)]
    pred = predictor(tfam_cfg)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred.predict_videos(videos)  # first request: cuBLAS/cuDNN set-up included
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    add_layer_norm.launches = 0
    windows = pred.stats()["windows"]
    t0 = time.perf_counter()
    out = pred.predict_videos(videos)
    torch.cuda.synchronize()
    request_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(flash_attention.launches)
    launches = counts["fwd"]
    norms, windows = add_layer_norm.launches, pred.stats()["windows"] - windows
    peak_bytes = torch.cuda.max_memory_allocated()

    check(launches == 8, f"flash_attention launched {launches} times, expected 8 "
                         "(4 layers x self + cross)")
    check(sum(counts.values()) == launches, f"serving launched other kernels: {counts}")
    # each window runs the teacher (ViT-B/16) and the student (ViT-B/32):
    # 12 blocks x 2 LayerNorms a tower call
    per_window = 2 * (teacher_cfg.num_layers + student_cfg.num_layers)
    check(windows > 0 and norms == per_window * windows == 48 * windows,
          f"add_layer_norm launched {norms} times over {windows} windows, expected "
          f"{per_window} a window (24 a tower call)")
    probs = np.stack([p.probabilities for p in out])
    check(probs.shape == (3, 140), f"probabilities shape {probs.shape}")
    check(bool(np.isfinite(probs).all()), "non-finite probabilities")
    check(bool(((probs >= 0) & (probs <= 1)).all()), "probabilities outside [0, 1]")

    eager = predictor(dataclasses.replace(tfam_cfg, attention_impl="xla"))
    before = dict(flash_attention.launches)
    probs_xla = np.stack([p.probabilities for p in eager.predict_videos(videos)])
    check(flash_attention.launches == before, "the eager predictor launched the kernel")
    path_err = float(np.abs(probs - probs_xla).max())
    check(path_err <= PATH_TOL, f"flash vs eager probabilities: max|d| {path_err} "
                                f"> {PATH_TOL}")

    profile_request(torch, lambda: pred.predict_videos(videos), smi)

    # one 128-frame window through each tower, preprocessing included
    frames = torch.from_numpy(videos[2][:129]).cuda()
    with torch.inference_mode():
        diffs = frame_diff(frames)
        teacher_ms = cuda_ms(torch, lambda: pred._teacher_embed(frames[:128]),
                             iters=5, warmup=1)
        student_ms = cuda_ms(torch, lambda: pred._student_embed(diffs),
                             iters=5, warmup=1)
    stats = {
        "request_ms": request_ms, "cold_request_ms": cold_ms,
        "frames": sum(len(v) for v in videos), "flash_launches": launches,
        "windows": windows, "add_layer_norm_launches": norms,
        "teacher_frames_per_s": 128 / teacher_ms * 1e3,
        "student_frames_per_s": 128 / student_ms * 1e3,
        "peak_mem_bytes": peak_bytes, "flash_vs_eager_max_abs": path_err,
        "top1": [p.top_classes[0][0] for p in out],
    }
    print("[main] " + json.dumps(stats) + f" [{smi}]")
    stats["probs"] = probs  # phase 14 holds the replicated towers to them
    return stats


def phase_siglip_tower(torch, seed: int, smi: str) -> dict:
    """The SigLIP So400m/14 tower at its published widths in bf16, at 384 px
    (729 tokens) and 224 px (256 tokens), through the tower factory on the
    kernels against its eager path on the same weights: each tower call
    launches ``fwd_pp_wgmma_kernel`` once per block and once for the head's
    one query, and nothing else, and ``add_layer_norm`` at the 27 blocks'
    two LayerNorms and the post-LN (55) on both paths. The two round the
    attention's probabilities differently (bf16 p in K1), so the embeddings
    agree to bf16 rounding through 27 blocks. Returns the launches."""
    import dataclasses

    from vimoclip_tpu_torch.models import init_parameters_
    from vimoclip_tpu_torch.models.siglip_vit import SiglipVisionConfig
    from vimoclip_tpu_torch.models.towers import preprocess, vision_tower
    from vimoclip_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        reset_launch_counts,
    )
    from vimoclip_tpu_torch.ops.kernels.layer_norm import add_layer_norm

    g = torch.Generator(device="cuda").manual_seed(seed)
    frames = torch.randint(0, 256, (16, 360, 640, 3), dtype=torch.uint8, device="cuda",
                           generator=g)
    rows, total, norms_total = [], 0, 0
    for size in (384, 224):
        cfg = SiglipVisionConfig(image_size=size)
        out, state = {}, None
        for impl in ("xla", "flash"):
            tower = vision_tower(dataclasses.replace(cfg, attention_impl=impl),
                                 torch.bfloat16).cuda().eval()
            if state is None:
                state = init_parameters_(tower, g).state_dict()
            tower.load_state_dict(state)
            reset_launch_counts()
            add_layer_norm.launches = 0
            with torch.no_grad():
                out[impl] = tower(preprocess(frames, cfg, torch.bfloat16)).double()
            torch.cuda.synchronize()
            launched = {k: n for k, n in flash_attention.launches.items() if n}
            want = {"fwd_pp": cfg.num_layers + 1} if impl == "flash" else {}
            check(launched == want, f"SigLIP {size} px tower on {impl}: launched {launched}, "
                                    f"expected {want}")
            norms = add_layer_norm.launches
            check(norms == 2 * cfg.num_layers + 1 == 55,
                  f"SigLIP {size} px tower on {impl}: {norms} add_layer_norm launches, not 55")
            norms_total += norms
            n = launched.get("fwd_pp", 0)
            del tower
        cos = torch.nn.functional.cosine_similarity(out["xla"], out["flash"], dim=-1)
        cos_min = cos.min().item()
        check(cos_min > 0.999, f"SigLIP {size} px tower, kernels vs eager: cos {cos_min}")
        total += n
        rows.append({"image_size": size, "tokens": cfg.num_patches, "frames": len(frames),
                     "fwd_pp_launches": n, "add_layer_norm_launches": norms,
                     "min_cos_vs_eager": cos_min})
    print("[siglip_tower] " + json.dumps(rows) + f" [{smi}]")
    return {"launches": total, "add_layer_norm_launches": norms_total}


def _ln_within(got, want) -> bool:
    """An ``add_layer_norm`` output ``got`` against the plain version's
    ``want``: within one bf16 ulp (of the larger of the two) plus 1e-6 of
    the largest |want|, the float32 gap of the LayerNorm's two sums in
    another order, which shows where the bias cancels w * x_hat. In float32
    the ulp term is below the gap; the card test holds float32 out to the
    gap alone."""
    import torch

    got, want = got.float(), want.float()
    big = torch.maximum(got.abs(), want.abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    return bool(((got - want).abs() <= ulp + 1e-6 * want.abs().max()).all())


def phase_add_layer_norm(torch, seed: int, smi: str, shape=ADD_LN_SHAPE,
                         checked=ADD_LN_CHECKED) -> dict:
    """``add_layer_norm`` against its plain version at the shapes the towers
    pass (``checked``: CLIP B's 768 and SigLIP's 1152, each with no delta,
    as at every tower's first LayerNorm, and with a bf16 residual branch,
    bf16 out): x_out bit for bit and h within ``_ln_within``. Then at
    ``shape`` (bf16 branch and out) its device time beside its 12
    B-an-element bound and the three PyTorch passes it replaced (the plain
    version: the add, the LayerNorm, the cast). Returns the timed row, with
    the largest error over every checked shape."""
    from vimoclip_tpu_torch.ops.kernels.layer_norm import (
        add_layer_norm,
        add_layer_norm_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(seed + 3)

    def inputs(rows, hidden, delta):
        ln = torch.nn.LayerNorm(hidden, eps=1e-6).cuda()
        ln.weight.normal_(1.0, 0.2, generator=g)
        ln.bias.normal_(0.0, 0.2, generator=g)
        x = torch.randn((rows, hidden), device="cuda", generator=g)
        d = torch.randn((rows, hidden), device="cuda", generator=g).bfloat16() if delta else None
        return x, d, ln

    errs = []
    with torch.no_grad():
        for rows, hidden in (*checked, shape):
            for delta in (False, True):
                x, d, ln = inputs(rows, hidden, delta)
                before = add_layer_norm.launches
                got_x, got_h = add_layer_norm(x, d, ln, torch.bfloat16)
                want_x, want_h = add_layer_norm_reference(x, d, ln, torch.bfloat16)
                torch.cuda.synchronize()
                what = f"add_layer_norm ({rows}, {hidden}) {'bf16' if delta else 'no'} delta"
                check(add_layer_norm.launches == before + 1, f"{what}: not launched")
                check(torch.equal(got_x, want_x) and (delta or got_x is x),
                      f"{what}: x_out not bitwise the plain add")
                err = (got_h.float() - want_h.float()).abs().max().item()
                check(_ln_within(got_h, want_h), f"{what}: h off by more than one bf16 ulp "
                                                 f"plus the float32 gap ({err})")
                errs.append(err)
                del got_x, got_h, want_x, want_h
        rows, hidden = shape
        run = lambda: add_layer_norm(x, d, ln, torch.bfloat16)
        plain = lambda: add_layer_norm_reference(x, d, ln, torch.bfloat16)
        moved = rows * hidden * (4 + 2 + 4 + 2)
        row = {"shape": list(shape), "out": "bfloat16", "delta": "bfloat16",
               "checked": [list(c) for c in (*checked, shape)], "max_abs_err": max(errs),
               "ms": device_ms(torch, run, names=("add_layer_norm_kernel",), per_call=1),
               "plain_ms": device_ms(torch, plain),
               "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    row["roofline"] = row["bound_ms"] / row["ms"]
    row["achieved_GB_per_s"] = moved / (row["ms"] * 1e-3) / 1e9
    print("[add_layer_norm] " + json.dumps(row) + f" [{smi}]")
    return row


def _clips(rng, lengths, d: int, classes: int, tag: str) -> list[dict]:
    """Synthetic paired embeddings: T RGB and T - 1 motion frames around a
    per-clip centre, 1-3 positive labels."""
    import numpy as np

    items = []
    for i, t in enumerate(lengths):
        labels = np.zeros(classes, np.float32)
        labels[rng.choice(classes, int(rng.integers(1, 4)), replace=False)] = 1.0
        centre = rng.standard_normal(d).astype(np.float32)
        items.append({
            "video_id": f"{tag}{i:03d}",
            "embeddings": (0.05 * (centre + rng.standard_normal((t, d)))).astype(np.float32),
            "motion_embeddings": (0.05 * rng.standard_normal((t - 1, d))).astype(np.float32),
            "labels": labels,
        })
    return items


def _step_launches(batch, layers: int, heads: int, single_max: int):
    """Kernel launches of one train step by (kernel, (B, H, Tq, Tk, D)): per
    layer one K1' per attention site, and K2 where the site's keys fit one
    512-key tile, else K3 + K4. Self-attention keys are the RGB frames,
    cross-attention keys the motion frames."""
    b, t, d = batch["embeddings"].shape
    out = Counter()
    for tk in (t, batch["motion_embeddings"].shape[1]):
        bwd = ["bwd_dqkv"] if tk <= single_max else ["bwd_dq", "bwd_dkv"]
        for kind in ["fwd_lse", *bwd]:
            out[kind, (b, heads, t, tk, d // heads)] += layers
    return out


def _per_kind(launches) -> dict:
    """``_step_launches`` summed over shapes, every launch counter named."""
    from vimoclip_tpu_torch.ops.kernels.flash_attention import LAUNCH_KINDS

    out = dict.fromkeys(LAUNCH_KINDS, 0)
    for (kind, _), n in launches.items():
        out[kind] += n
    return out


def training_setup(torch, seed: int) -> dict:
    """The training phase's trainer and batches (made before phase 5, which
    checks the kernels at the shapes these batches give them)."""
    import numpy as np

    from vimoclip_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        LoggingConfig,
        TFAMModelConfig,
        TrainingConfig,
    )
    from vimoclip_tpu_torch.ops.kernels.flash_attention import SINGLE_PASS_MAX_TK
    from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer

    d, classes, layers, heads = 512, 140, 4, 8
    # configs/example_ak_frame_diff.yaml as dataclasses, on the flash path
    cfg = ExperimentConfig(
        training=TrainingConfig(seed=seed, lr=1e-4, weight_decay=0.1, epochs=30,
                                batch_size=8, num_workers=2, device="cuda",
                                half_precision=True),
        logging=LoggingConfig(),
        data=DataConfig(num_classes=classes, length_bucket=128, max_seq_len=2048),
        model=TFAMModelConfig(d_model=d, nhead=heads, num_layers=layers, dim_feedforward=2048,
                              use_cross_attention=True, dropout=0.1, mlp_dropout=0.1,
                              attention_impl="flash"),
    )
    rng = np.random.default_rng(seed)
    train_items = _clips(rng, rng.integers(60, 501, 40), d, classes, "train")
    val_items = _clips(rng, rng.integers(60, 501, 16), d, classes, "val")
    long_lengths = rng.integers(60, 501, 8)
    long_lengths[3] = rng.integers(700, 1001)
    long_items = _clips(rng, long_lengths, d, classes, "long")
    run_dir = HERE / "build" / "chip_smoke_train"
    trainer = TFAMTrainer(cfg, log_dir=str(run_dir / "logs"),
                          checkpoint_dir=str(run_dir / "checkpoints"),
                          train_dataset=train_items, val_dataset=val_items)
    trainer.train_loader.set_epoch(0)
    batches = list(trainer.train_loader) + [trainer.collate(long_items)]
    check(len(batches) == 6, f"{len(batches)} batches")
    steps = [_step_launches(b, layers, heads, SINGLE_PASS_MAX_TK) for b in batches]
    total = sum(steps, start=Counter())
    # each kernel's most launched shape on the main path
    main_shapes = {}
    for (kind, shape), n in sorted(total.items(), key=lambda kv: -kv[1]):
        main_shapes.setdefault(kind, shape)
    return {"cfg": cfg, "trainer": trainer, "batches": batches, "steps": steps,
            "main_shapes": main_shapes, "rng": rng}


def phase_training(torch, setup: dict, smi: str) -> dict:
    import dataclasses

    import numpy as np

    from vimoclip_tpu_torch import losses
    from vimoclip_tpu_torch.data.pipeline import to_device
    from vimoclip_tpu_torch.models.tfam import TFAM
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa

    cfg, trainer, batches = setup["cfg"], setup["trainer"], setup["batches"]
    classes, layers = cfg.data.num_classes, cfg.model.num_layers

    # the main path: the trainer's own step over the epoch and the long batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    step_losses, per_step = [], []
    for batch, expected in zip(batches, setup["steps"]):
        before = dict(fa.flash_attention.launches)
        loss, _ = trainer.train_step(batch)
        torch.cuda.synchronize()
        got = {k: fa.flash_attention.launches[k] - before[k] for k in fa.LAUNCH_KINDS}
        want = _per_kind(expected)
        check(got == want, f"step launches {got}, expected {want} "
                           f"(T {batch['embeddings'].shape[1]}/{batch['motion_embeddings'].shape[1]})")
        step_losses.append(float(loss))
        per_step.append(got)
    launches = dict(fa.flash_attention.launches)
    peak_bytes = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(step_losses)), f"non-finite loss {step_losses}")
    check(any(s["bwd_dq"] for s in per_step) and any(s["bwd_dqkv"] for s in per_step),
          "the long batch did not reach K3/K4 or the others K2")

    # validate: the eval path runs K1 only
    fa.reset_launch_counts()
    val_loss, val_map = trainer.validate()
    val_counts = dict(fa.flash_attention.launches)
    n_val = len(trainer.val_loader)
    check(val_counts == {**dict.fromkeys(fa.LAUNCH_KINDS, 0), "fwd": 2 * layers * n_val},
          f"validate launched {val_counts}")
    check(np.isfinite(val_loss) and 0.0 <= val_map <= 1.0, f"validate {val_loss} {val_map}")

    # 15 steps on one batch lower its loss; the later ones time a warm step
    fixed = to_device(batches[0], trainer.device)
    fit, times = [], []
    for i in range(15):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.train_step(fixed)
        fit.append(float(loss))
        if i >= 5:
            times.append(time.perf_counter() - t0)
    check(all(np.isfinite(fit)), f"non-finite loss {fit}")
    check(np.mean(fit[-3:]) < fit[0], f"15 steps on one batch did not lower the loss: {fit}")
    step_ms = float(np.mean(times)) * 1e3
    prof = profile_request(torch, lambda: trainer.train_step(fixed), smi, label="train-profile")

    # the long batch (a clip past 512 frames: K3 + K4 at every attention
    # site), warm: steps 3-8 of 8
    long = to_device(batches[-1], trainer.device)
    long_times = []
    for i in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.train_step(long)
        check(np.isfinite(float(loss)), f"non-finite loss on the long batch: {float(loss)}")
        if i >= 2:
            long_times.append(time.perf_counter() - t0)
    long_step_ms = float(np.mean(long_times)) * 1e3
    long_prof = profile_request(torch, lambda: trainer.train_step(long), smi,
                                label="train-long-profile")

    # flash against eager: one dropout-0 step from the same weights
    state = trainer.model.state_dict()

    def loss_and_grads(impl):
        model_cfg = dataclasses.replace(cfg.model, dropout=0.0, mlp_dropout=0.0,
                                        attention_impl=impl)
        model = TFAM(model_cfg, num_classes=classes, dtype=torch.bfloat16).cuda()
        model.load_state_dict(state)
        model.train()
        logits = model(fixed["embeddings"], fixed["motion_embeddings"],
                       fixed["mask_rgb"], fixed["mask_motion"])
        loss = losses.bce_with_logits(logits, fixed["labels"])
        loss.backward()
        grads = [p.grad.float().flatten() for p in model.parameters() if p.grad is not None]
        return loss.item(), torch.cat(grads)

    loss_f, grads_f = loss_and_grads("flash")
    loss_x, grads_x = loss_and_grads("xla")
    grad_rel_l2 = ((grads_f - grads_x).norm() / grads_x.norm()).item()
    check(abs(loss_f - loss_x) <= TRAIN_LOSS_TOL,
          f"flash vs eager loss {loss_f} vs {loss_x} > {TRAIN_LOSS_TOL}")
    check(grad_rel_l2 <= TRAIN_GRAD_TOL,
          f"flash vs eager gradients: relative L2 {grad_rel_l2} > {TRAIN_GRAD_TOL}")
    crossover = _crossover(torch, setup, smi)
    float32_auto = _f32_recipe(torch, setup, smi)

    stats = {
        "step_losses": step_losses, "fit_losses": fit, "launches": launches,
        "launches_per_step": per_step, "val_loss": val_loss, "val_map": val_map,
        "val_launches": val_counts, "warm_step_ms": step_ms,
        "clips_per_s": 8 / (step_ms / 1e3), "peak_mem_bytes": peak_bytes,
        "flash_vs_eager_loss": [loss_f, loss_x], "flash_vs_eager_grad_rel_l2": grad_rel_l2,
        "device_idle_share": prof["device_idle_share"],
        "long_step_ms": long_step_ms, "long_device_busy_ms": long_prof["device_busy_ms"],
        "long_device_idle_share": long_prof["device_idle_share"],
        "lengths": [[int(b["embeddings"].shape[1]), int(b["motion_embeddings"].shape[1])]
                    for b in batches],
        "kernel_main_shapes": setup["main_shapes"], "crossover": crossover,
        "float32_auto": float32_auto,
    }
    print("[train] " + json.dumps(stats) + f" [{smi}]")
    return stats


def _f32_recipe(torch, setup: dict, smi: str) -> dict:
    """Phase 6's recipe in float32, the trainer's default (``half_precision``
    False; the main path above runs bf16), under ``attention_impl: auto``:
    15 steps on the first batch that lower its loss, each step's launches by
    kind (``auto`` sends every site with dropout to the kernels at head dim
    64), a warm step's ms and idle share, then one step of the long batch (K3
    + K4) and ``validate`` (K1); and the ``xla`` route's warm step on the
    same batch, a trainer of its own. Each route also times the long batch's
    warm step."""
    import tempfile

    import numpy as np

    from vimoclip_tpu_torch.data.pipeline import to_device
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa
    from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer

    cfg, batches = setup["cfg"], setup["batches"]
    datasets = {"train_dataset": setup["trainer"].train_loader.dataset,
                "val_dataset": setup["trainer"].val_loader.dataset}
    run = Path(tempfile.mkdtemp(dir=HERE / "build"))
    out = {"dtype": "float32", "bucket": int(batches[0]["embeddings"].shape[1])}
    for impl in ("auto", "xla"):
        c = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, attention_impl=impl),
            training=dataclasses.replace(cfg.training, half_precision=False))
        trainer = TFAMTrainer(c, log_dir=str(run / impl / "logs"),
                              checkpoint_dir=str(run / impl / "ckpt"), **datasets)
        check(trainer.dtype == torch.float32, f"the trainer runs {trainer.dtype}, not float32")
        fixed = to_device(batches[0], trainer.device)
        fa.reset_launch_counts()
        fit, times = [], []
        for i in range(15):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit.append(float(trainer.train_step(fixed)[0]))
            if i >= 5:
                times.append(time.perf_counter() - t0)
        launches = dict(fa.flash_attention.launches)
        check(all(np.isfinite(fit)) and np.mean(fit[-3:]) < fit[0],
              f"float32 {impl}: 15 steps on one batch did not lower the loss: {fit}")
        prof = profile_request(torch, lambda: trainer.train_step(fixed), smi,
                               label=f"train-f32-{impl}-profile")
        row = {"warm_step_ms": float(np.mean(times)) * 1e3,
               "device_idle_share": prof["device_idle_share"], "fit_losses": fit,
               "launches_per_step": {k: n // 15 for k, n in launches.items() if n}}
        if impl == "auto":
            want = {k: 15 * n for k, n in _per_kind(setup["steps"][0]).items()}
            check(launches == want, f"float32 auto: 15 steps launched {launches}, expected {want}")
            fa.reset_launch_counts()
            loss, _ = trainer.train_step(batches[-1])  # the long batch: K3 + K4
            check(np.isfinite(float(loss)), f"float32 auto: long batch loss {float(loss)}")
            check(dict(fa.flash_attention.launches) == _per_kind(setup["steps"][-1]),
                  f"float32 auto: the long batch launched {fa.flash_attention.launches}")
            val_loss, val_map = trainer.validate()
            check(np.isfinite(val_loss) and 0.0 <= val_map <= 1.0, f"validate {val_loss} {val_map}")
            row["launches"] = {k: n + launches[k] for k, n in fa.flash_attention.launches.items()}
        else:
            check(sum(launches.values()) == 0, f"float32 xla launched {launches}")
        # the long batch's warm step (under auto: K1' + K3 + K4 where its keys
        # pass 512)
        long = to_device(batches[-1], trainer.device)
        row["long_bucket"] = int(long["embeddings"].shape[1])
        row["long_step_ms"] = cuda_ms(torch, lambda: trainer.train_step(long), iters=3, warmup=1)
        out[impl] = row
        del trainer
    print("[train-f32] " + json.dumps(out) + f" [{smi}]")
    return out


def _crossover(torch, setup: dict, smi: str) -> list[dict]:
    """The trainer's step with dropout on, at each of ``CROSSOVER_BUCKETS``,
    and its eval-mode step without dropout (``eval_step``, what ``validate``
    runs), at each of ``NODROP_BUCKETS``, every attention site on the eager
    path and on the kernels in turn (eager, kernels, kernels, eager): ms per
    step from CUDA events (the host's launches included; mean of the two runs
    of each) and device-busy ms per step from the profiler."""
    from vimoclip_tpu_torch.data.pipeline import to_device
    from vimoclip_tpu_torch.ops.attention import MultiHeadAttention

    cfg, trainer, rng = setup["cfg"], setup["trainer"], setup["rng"]
    sites = [m for m in trainer.model.modules() if isinstance(m, MultiHeadAttention)]
    rows = []
    for mode, buckets in (("train", CROSSOVER_BUCKETS), ("eval", NODROP_BUCKETS)):
        for bucket in buckets:
            items = _clips(rng, rng.integers(bucket - 27, bucket + 1, 8), cfg.model.d_model,
                           cfg.data.num_classes, f"b{bucket}-")
            batch = to_device(trainer.collate(items), trainer.device)
            lengths = (batch["embeddings"].shape[1], batch["motion_embeddings"].shape[1])
            check(lengths == (bucket, bucket), f"bucket {bucket}: lengths {lengths}")
            step = trainer.train_step if mode == "train" else trainer.eval_step
            row = {"mode": mode, "dropout": cfg.model.dropout if mode == "train" else 0.0,
                   "bucket": bucket, "xla_ms": 0.0, "flash_ms": 0.0}
            for impl in ("xla", "flash", "flash", "xla"):
                for m in sites:
                    m.implementation = impl
                row[f"{impl}_ms"] += cuda_ms(torch, lambda: step(batch), iters=10, warmup=2) / 2
            for impl in ("xla", "flash"):
                for m in sites:
                    m.implementation = impl
                row[f"{impl}_device_ms"] = device_ms(torch, lambda: step(batch), iters=5)
            print("[crossover] " + json.dumps(row) + f" [{smi}]")
            rows.append(row)
    for m in sites:
        m.implementation = cfg.model.attention_impl
    return rows


def phase_normalize_kernel(torch, seed: int, smi: str) -> dict:
    """K5 against its plain version, bit for bit, at the stage-1 shapes and
    an odd view; returns the bf16 row at the MN training step's shape."""
    from vimoclip_tpu_torch.ops.kernels.normalize import (
        fused_normalize,
        fused_normalize_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    # on the path K5 reads frames just uploaded and writes a fresh buffer:
    # its time is taken with the 50 MB L2 flushed before every call (the
    # profiler counts only the kernel's own events), and also warm
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    main = None
    for shape, offset in NORMALIZE_SHAPES:
        n = 1
        for s in shape:
            n *= s
        base = torch.randint(0, 256, (n + offset,), device="cuda", generator=g,
                             dtype=torch.uint8)
        x = base[offset:].view(shape)  # offset > 0: a misaligned view
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            out = fused_normalize(x, dtype=dtype)
            ref = fused_normalize_reference(x, dtype=dtype)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            check(torch.equal(out, ref), f"fused_normalize {dtype_name} {shape}+{offset}: "
                                         f"not bitwise equal to the plain version ({err})")
            # the median of three traces: a trace now and then mistimes its
            # events (one read a flushed time below the bytes bound)
            ms = statistics.median(
                device_ms(torch, lambda: (flush.zero_(), fused_normalize(x, dtype=dtype)),
                          names=("normalize_kernel",), per_call=1) for _ in range(3))
            warm_ms = statistics.median(
                device_ms(torch, lambda: fused_normalize(x, dtype=dtype),
                          names=("normalize_kernel",), per_call=1) for _ in range(3))
            plain_ms = device_ms(torch, lambda: fused_normalize_reference(x, dtype=dtype))
            moved = n * (1 + dtype.itemsize)  # uint8 in, dtype out
            t_bytes = moved / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * n / FMA_FLOPS * 1e3  # a subtraction and a product (FMA units)
            row = {"dtype": dtype_name, "shape": list(shape), "offset": offset,
                   "max_abs_err": err, "bitwise": True, "ms": ms, "warm_ms": warm_ms,
                   "plain_ms": plain_ms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "achieved_GB_per_s": moved / (ms * 1e-3) / 1e9,
                   "plain_GB_per_s": moved / (plain_ms * 1e-3) / 1e9}
            print("[normalize] " + json.dumps(row) + f" [{smi}]")
            if dtype_name == "bfloat16" and shape == NORMALIZE_SHAPES[0][0]:
                main = row
    check(main is not None, "no K5 measurement at the training step's shape")
    return main


def _segments(rng, n: int, hw: tuple[int, int], classes: int, multi_label: bool) -> list[dict]:
    """Synthetic stage-1 segments: teacher embeddings (30, 512) and 29 uint8
    motion frames; one label (MN) or 1-3 (AK)."""
    import numpy as np

    items = []
    for i in range(n):
        labels = np.zeros(classes, np.float32)
        k = int(rng.integers(1, 4)) if multi_label else 1
        labels[rng.choice(classes, k, replace=False)] = 1.0
        items.append({
            "video_id": f"seg{i:03d}",
            "rgb_emb": rng.standard_normal((STUDENT_SEQ, 512)).astype(np.float32),
            "motion_frames": rng.integers(0, 256, (STUDENT_SEQ - 1, *hw, 3), dtype=np.uint8),
            "labels": labels,
        })
    return items


def _student_trainer(torch, items, val_items, run: str, seed: int, **kw):
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig
    from vimoclip_tpu_torch.train.student_trainer import StudentTrainer

    run_dir = HERE / "build" / "chip_smoke_student" / run
    return StudentTrainer(items, val_items, checkpoint_dir=str(run_dir / "checkpoints"),
                          vision_config=ClipVisionConfig.vit_b_32(), lr=1e-5, batch_size=8,
                          num_workers=2, epochs=1, half_precision=True, seed=seed,
                          device="cuda", **kw)


def phase_student(torch, seed: int, smi: str) -> tuple[dict, object]:
    """Stage-1 training at ViT-B/32's full width, batch 8, 29 motion frames,
    bf16, Adam 1e-5: the MN recipe (224x224, K5 once per step) through
    ``train()`` over one epoch and its ``evaluate``, and the AK recipe
    (360x640, the resize branch, no K5) for three steps."""
    import numpy as np

    from vimoclip_tpu_torch.data.pipeline import to_device
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa
    from vimoclip_tpu_torch.ops.kernels.layer_norm import add_layer_norm
    from vimoclip_tpu_torch.ops.kernels.normalize import fused_normalize

    rng = np.random.default_rng(seed + 3)
    mn_train = _segments(rng, 6 * 8, (224, 224), 12, multi_label=False)
    mn_val = _segments(rng, 2 * 8, (224, 224), 12, multi_label=False)
    mn = _student_trainer(torch, mn_train, mn_val, "mn", seed, num_classes=12,
                          class_loss="ce")

    # the main path: the MN recipe's train() (one epoch, evaluate, checkpoints)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    fused_normalize.launches = 0
    add_layer_norm.launches = 0
    t0 = time.perf_counter()
    best = mn.train()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    mn_launches, mn_norms = fused_normalize.launches, add_layer_norm.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    n_train, n_val = len(mn.train_loader), len(mn.val_loader)
    check((n_train, n_val) == (6, 2), f"MN batches {n_train} train, {n_val} val")
    check(mn_launches == n_train + n_val,
          f"K5 launched {mn_launches} times in the MN epoch, expected {n_train + n_val} "
          "(one per train step and per eval batch)")
    check(sum(fa.flash_attention.launches.values()) == 0,
          "the student's eager attention launched a flash kernel")
    # ViT-B/32's 12 blocks x 2 LayerNorms a tower call, one call a train
    # step (autograd recording) and one an eval batch
    check(mn_norms == 24 * (n_train + n_val),
          f"add_layer_norm launched {mn_norms} times in the MN epoch, expected "
          f"{24 * (n_train + n_val)} (24 per train step and per eval batch)")
    check(np.isfinite(best), f"MN best val loss {best}")

    # the AK recipe: 360x640 frames take the resize branch, so no K5
    ak_items = _segments(rng, 3 * 8, (360, 640), 140, multi_label=True)
    ak = _student_trainer(torch, ak_items, ak_items[:8], "ak", seed, num_classes=140,
                          class_loss="bce", class_pos_weight=9.0)
    fused_normalize.launches = 0
    ak_train = ak.train_epoch(0)
    torch.cuda.synchronize()
    ak_launches = fused_normalize.launches
    check(len(ak.train_loader) == 3 and ak_launches == 0,
          f"AK: {len(ak.train_loader)} steps launched K5 {ak_launches} times, expected 0")
    check(np.isfinite(ak_train["total"]), f"AK loss {ak_train}")
    del ak

    # 15 steps on one MN batch lower its loss; steps 6-15 time a warm step
    fixed = to_device(mn.train_loader.collate(mn_train[:8]), mn.device)
    fit, times = [], []
    for i in range(15):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals, _ = mn.train_step(fixed)
        fit.append(float(vals[0]))
        if i >= 5:
            times.append(time.perf_counter() - t0)
    check(all(np.isfinite(fit)), f"non-finite loss {fit}")
    check(np.mean(fit[-3:]) < fit[0], f"15 steps on one batch did not lower the loss: {fit}")
    step_ms = float(np.mean(times)) * 1e3
    prof = profile_request(torch, lambda: mn.train_step(fixed), smi, label="student-profile")

    # grad_accum=2 from the same state as one full-batch step
    accum = _student_trainer(torch, mn_train, mn_val, "accum", seed, num_classes=12,
                             class_loss="ce", grad_accum=2)
    accum.model.load_state_dict(mn.model.state_dict())
    accum.state.optimizer.load_state_dict(mn.state.optimizer.state_dict())
    full_vals, _ = mn.train_step(fixed)
    accum_vals, _ = accum.train_step(fixed)
    grads = [torch.cat([p.grad.float().flatten() for p in t.model.parameters()])
             for t in (mn, accum)]
    grad_rel_l2 = ((grads[0] - grads[1]).norm() / grads[0].norm()).item()
    loss_rel = ((full_vals - accum_vals).abs() / full_vals.abs()).max().item()
    param_max_abs = max((a - b).abs().max().item() for a, b in
                        zip(mn.model.parameters(), accum.model.parameters()))
    check(loss_rel <= ACCUM_LOSS_TOL, f"grad_accum=2 vs 1 losses: rel {loss_rel} > "
                                      f"{ACCUM_LOSS_TOL}")
    check(grad_rel_l2 <= ACCUM_GRAD_TOL, f"grad_accum=2 vs 1 gradients: relative L2 "
                                         f"{grad_rel_l2} > {ACCUM_GRAD_TOL}")
    del accum

    stats = {
        "mn_k5_launches": mn_launches, "mn_add_layer_norm_launches": mn_norms,
        "mn_epoch_s": epoch_s, "mn_best_val": best,
        "ak_k5_launches": ak_launches, "ak_train": ak_train, "fit_losses": fit,
        "warm_step_ms": step_ms, "segments_per_s": 8 / (step_ms / 1e3),
        "frames_per_s": 8 * (STUDENT_SEQ - 1) / (step_ms / 1e3), "peak_mem_bytes": peak_bytes,
        "accum_loss_rel": loss_rel, "accum_grad_rel_l2": grad_rel_l2,
        "accum_param_max_abs": param_max_abs,
        "device_idle_share": prof["device_idle_share"],
    }
    print("[student] " + json.dumps(stats) + f" [{smi}]")
    return stats, mn


def phase_export(torch, trainer, seed: int, smi: str) -> dict:
    """The exporter's device path on the trained student: two 128-frame
    chunks and a 77-frame tail at 224x224, K5 once per chunk, embeddings
    equal to the trainer's own tower on the same (padded) frames."""
    import numpy as np

    from vimoclip_tpu_torch.export import MotionEmbeddingExporter
    from vimoclip_tpu_torch.ops.batching import pad_to_batch
    from vimoclip_tpu_torch.ops.kernels.normalize import fused_normalize
    from vimoclip_tpu_torch.ops.preprocess import clip_preprocess

    rng = np.random.default_rng(seed + 4)
    video = rng.integers(0, 256, (2 * EXPORT_CHUNK + 77, 224, 224, 3), dtype=np.uint8)
    chunks = [video[i:i + EXPORT_CHUNK] for i in range(0, len(video), EXPORT_CHUNK)]
    exporter = MotionEmbeddingExporter(trainer.model.state_dict(), trainer.vision_config,
                                       chunk_size=EXPORT_CHUNK, device="cuda")
    torch.cuda.synchronize()
    fused_normalize.launches = 0
    t0 = time.perf_counter()
    embs = [exporter._embed_chunk(c) for c in chunks]
    export_s = time.perf_counter() - t0
    launches = fused_normalize.launches
    check(launches == len(chunks), f"K5 launched {launches} times for {len(chunks)} chunks")
    check([e.shape for e in embs] == [(len(c), 512) for c in chunks],
          f"export shapes {[e.shape for e in embs]}")
    check(all(np.isfinite(e).all() for e in embs), "non-finite export embeddings")
    tower = trainer.model.visual_encoder.eval()
    max_diff = 0.0
    with torch.inference_mode():
        for c, e in zip(chunks, embs):
            x = torch.from_numpy(pad_to_batch(c, EXPORT_CHUNK)).cuda()
            ref = tower(clip_preprocess(x, 224, dtype=torch.bfloat16)).float()[:len(c)]
            max_diff = max(max_diff, float(np.abs(ref.cpu().numpy() - e).max()))
    check(max_diff == 0.0, f"export embeddings differ from the trainer's tower by {max_diff}")
    t0 = time.perf_counter()  # the same chunks again, warm
    for c in chunks:
        exporter._embed_chunk(c)
    warm_s = time.perf_counter() - t0
    stats = {"k5_launches": launches, "frames": len(video), "export_s": export_s,
             "frames_per_s": len(video) / export_s, "warm_frames_per_s": len(video) / warm_s,
             "max_abs_vs_tower": max_diff}
    print("[export] " + json.dumps(stats) + f" [{smi}]")
    return stats


def _decoder(videos: dict, fail: str | None = None):
    """``decode_fn`` over in-memory videos keyed by path: chunks of
    ``chunk_size`` views; the video named ``fail`` raises after two chunks."""
    def decode(path, chunk_size):
        frames = videos[path]
        for j, i in enumerate(range(0, len(frames), chunk_size)):
            if path == fail and j == 2:
                raise IOError("synthetic mid-decode failure")
            yield frames[i:i + chunk_size]
    return decode


def _run_extract(torch, extractor, videos: dict, **kw) -> tuple[dict, dict, dict]:
    """One ``extract`` pass ending in a synchronise: (whole-video results,
    streamed chunks when ``stream_rows`` is given, errors)."""
    done, chunks = {}, {}
    if "stream_rows" in kw:
        kw["on_video_chunk"] = lambda v, c: chunks.setdefault(v, []).append(c)
    errors = extractor.extract([(k, k) for k in videos],
                               lambda v, e: done.__setitem__(v, e), **kw)
    torch.cuda.synchronize()
    return done, chunks, errors


def _rel_l2(a, b) -> float:
    import numpy as np

    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _sequential(torch, extractor, frames):
    """One video alone: padded ``EXTRACT_BATCH``-frame batches through the
    extractor's preprocessing and encoder."""
    import numpy as np

    from vimoclip_tpu_torch.ops.batching import pad_to_batch

    out = []
    for i in range(0, len(frames), EXTRACT_BATCH):
        part = frames[i:i + EXTRACT_BATCH]
        x = torch.from_numpy(pad_to_batch(part, EXTRACT_BATCH)).cuda()
        out.append(extractor._embed(x)[:len(part)].cpu().numpy())
    return np.concatenate(out)


def _tower_kernel(torch, shape, smi: str) -> dict:
    """K1 at a tower's attention shape, on q/k/v split from one packed
    projection as ``MultiHeadAttention`` makes them: TMA legality, the
    kernel against its plain version, and its device time beside SDPA's and
    the eager path's."""
    import torch.nn.functional as F

    from vimoclip_tpu_torch.ops.attention import dot_product_attention
    from vimoclip_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_reference,
        tma_legal,
    )

    b, h, t, _, d = shape
    g = torch.Generator(device="cuda").manual_seed(7)
    qkv = torch.randn(b, t, 3 * h * d, device="cuda", generator=g).to(torch.bfloat16)
    q, k, v = (x.view(b, t, h, d).transpose(1, 2) for x in qkv.split(h * d, dim=-1))
    legal = all(tma_legal(x) for x in (q, k, v))
    check(legal, f"the tower's q/k/v at {shape} are not TMA-legal")
    out = flash_attention(q, k, v)
    err = (out.float() - flash_attention_reference(q, k, v).float()).abs().max().item()
    check(err <= KERNEL_TOL["bfloat16"], f"K1 at {shape}: max|d| {err}")
    ms = device_ms(torch, lambda: flash_attention(q, k, v),
                   names=KERNEL_NAMES["fwd"]["bfloat16"],
                   per_call=KERNEL_PER_CALL["fwd"]["bfloat16"])
    sdpa_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v),
                        required=False)
    eager_ms = device_ms(torch, lambda: dot_product_attention(q, k, v))
    moved = 4 * b * h * t * d * 2  # q, k, v in, o out, bf16
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * b * h * t * t * d / PEAK_FLOPS["bfloat16"] * 1e3
    row = {"shape": list(shape), "tma_legal": legal, "max_abs_err": err, "ms": ms,
           "sdpa_ms": sdpa_ms, "eager_ms": eager_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print("[extract-k1] " + json.dumps(row) + f" [{smi}]")
    return row


def _tower_pair(torch, cfg, state, videos: dict, smi: str, label: str) -> dict:
    """The same teacher with eager attention ("xla", the default) and with
    K1 ("flash"): warm frames/s of each, K1 launches per dispatch, and the
    per-frame cosine of the two paths' embeddings."""
    import dataclasses

    import numpy as np

    from vimoclip_tpu_torch.extraction import ClipExtractor
    from vimoclip_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        reset_launch_counts,
    )

    n = sum(len(v) for v in videos.values())
    dispatches = -(-n // EXTRACT_BATCH)
    out, emb = {}, {}
    for impl in ("xla", "flash"):
        ext = ClipExtractor(state, dataclasses.replace(cfg, attention_impl=impl),
                            batch_size=EXTRACT_BATCH, decode_fn=_decoder(videos),
                            device="cuda")
        _run_extract(torch, ext, videos)  # cold
        reset_launch_counts()
        t0 = time.perf_counter()
        emb[impl], _, errors = _run_extract(torch, ext, videos)
        out[f"{impl}_frames_per_s"] = n / (time.perf_counter() - t0)
        check(errors == {}, f"{label} {impl}: {errors}")
        out[f"{impl}_k1_launches"] = flash_attention.launches["fwd"]
    layers = cfg.num_layers
    check(out["xla_k1_launches"] == 0, f"{label}: the eager towers launched K1")
    check(out["flash_k1_launches"] == layers * dispatches,
          f"{label}: K1 launched {out['flash_k1_launches']} times, expected "
          f"{layers} per dispatch x {dispatches}")
    cos = []
    for vid in videos:
        a, b = emb["flash"][vid], emb["xla"][vid]
        cos.append(float((np.sum(a * b, 1) / (np.linalg.norm(a, axis=1)
                                                * np.linalg.norm(b, axis=1))).min()))
    out["min_cosine_flash_vs_xla"] = min(cos)
    check(out["min_cosine_flash_vs_xla"] >= TOWER_COS_MIN,
          f"{label}: flash vs eager cosine {min(cos)} < {TOWER_COS_MIN}")
    print(f"[extract-{label}] " + json.dumps(out) + f" [{smi}]")
    return out


def phase_extraction(torch, seed: int, smi: str) -> dict:
    """Teacher extraction through ``ClipExtractor.extract`` with synthetic
    videos fed through its decode seam (OpenCV and h5py are not assumed on
    the card's machine): the AK teacher at full width against each video run alone, warm
    frames/s, streaming, a failing reader, a profiled dispatch and pass; the MN
    teacher's 224x224 frames with K5 once per dispatch; K1 at the towers'
    shapes and the towers on it; the frame difference on the card."""
    import numpy as np

    # these import without cv2, h5py, pandas or PyYAML, which the card's
    # machine is not assumed to have: they import those where they use them
    import vimoclip_tpu_torch.pipeline  # noqa: F401
    from vimoclip_tpu_torch.extraction import ClipExtractor
    from vimoclip_tpu_torch.models import init_parameters_
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
    from vimoclip_tpu_torch.motion import DIFF_CHUNK
    from vimoclip_tpu_torch.ops.batching import pad_to_batch
    from vimoclip_tpu_torch.ops.kernels.normalize import fused_normalize
    from vimoclip_tpu_torch.ops.preprocess import frame_diff

    host_libs = {m: m in sys.modules for m in ("cv2", "h5py", "pandas", "yaml")}
    g = torch.Generator(device="cuda").manual_seed(seed + 5)

    def corpus(lengths, hw):
        frames = torch.randint(0, 256, (sum(lengths), *hw, 3), device="cuda",
                               generator=g, dtype=torch.uint8).cpu().numpy()
        starts = np.cumsum((0,) + lengths)
        return {f"v{i}": frames[starts[i]:starts[i + 1]] for i in range(len(lengths))}

    def teacher(cfg):
        return init_parameters_(ClipVisionEncoder(cfg), g).state_dict()

    # --- the AK teacher: ViT-B/16 at full width, 360x640 frames ---------------
    ak_cfg = ClipVisionConfig.vit_b_16()
    ak_state = teacher(ak_cfg)
    videos = corpus(EXTRACT_LENGTHS, EXTRACT_HW)
    n_frames = sum(EXTRACT_LENGTHS)
    dispatches = -(-n_frames // EXTRACT_BATCH)
    ext = ClipExtractor(ak_state, ak_cfg, batch_size=EXTRACT_BATCH, decode_workers=4,
                        decode_fn=_decoder(videos), device="cuda")
    fused_normalize.launches = 0
    t0 = time.perf_counter()
    first, _, errors = _run_extract(torch, ext, videos)
    cold_s = time.perf_counter() - t0
    check(errors == {} and set(first) == set(videos), f"AK extraction: {errors}")
    check(fused_normalize.launches == 0, "360x640 frames launched K5 (the resize branch "
                                         "launches none)")
    gaps = []
    for vid, frames in videos.items():
        e = first[vid]
        check(e.shape == (len(frames), 512), f"{vid}: embeddings {e.shape}")
        check(bool(np.isfinite(e).all()), f"{vid}: non-finite embeddings")
        gaps.append(_rel_l2(e, _sequential(torch, ext, frames)))
    check(max(gaps) <= EXTRACT_TOL, f"extractor vs sequential: rel. L2 {max(gaps)} > "
                                    f"{EXTRACT_TOL}")

    # warm: the second pass over the same corpus, ending in a synchronise
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    second, _, errors = _run_extract(torch, ext, videos)
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(errors == {}, f"warm pass: {errors}")
    repeat = max(_rel_l2(second[v], first[v]) for v in videos)
    check(repeat <= EXTRACT_TOL, f"two passes differ by rel. L2 {repeat}")

    # streaming at 128 rows with a reader that fails after two chunks
    ext_fail = ClipExtractor(ak_state, ak_cfg, batch_size=EXTRACT_BATCH, decode_workers=4,
                             decode_fn=_decoder(videos, fail="v4"), device="cuda")
    aborted = []
    done, chunks, errors = _run_extract(torch, ext_fail, videos, stream_rows=EXTRACT_STREAM_ROWS,
                                        on_video_abort=aborted.append)
    check(set(errors) == {"v4"}, f"failing reader: errors {errors}")
    check("v4" not in done, "the failed video finished")
    stream_gap = 0.0
    for vid, frames in videos.items():
        if vid == "v4":
            continue
        if done[vid] is None:  # streamed
            check(all(len(c) < EXTRACT_STREAM_ROWS + EXTRACT_BATCH for c in chunks[vid]),
                  f"{vid}: a chunk over the bound")
            got = np.concatenate(chunks[vid])
        else:
            check(len(frames) < EXTRACT_STREAM_ROWS and vid not in chunks,
                  f"{vid}: a short video streamed")
            got = done[vid]
        check(got.shape == first[vid].shape, f"{vid}: streamed {got.shape}")
        stream_gap = max(stream_gap, _rel_l2(got, first[vid]))
    check(stream_gap <= EXTRACT_TOL, f"streamed vs whole: rel. L2 {stream_gap}")

    # one dispatch, host packing and pinning included, under the profiler
    stack_src = np.concatenate([videos["v4"][:EXTRACT_BATCH - 10], videos["v5"][:10]])
    prof = profile_request(
        torch, lambda: ext._fetch(ext._dispatch(pad_to_batch(stack_src, EXTRACT_BATCH))),
        smi, label="extract-dispatch")
    # and a whole warm pass: how much of it the card sits idle
    pass_prof = profile_request(torch, lambda: _run_extract(torch, ext, videos), smi,
                                label="extract-pass")

    # --- the MN teacher: ViT-B/32 over 224x224 frames, K5 once per dispatch ------
    mn_cfg = ClipVisionConfig.vit_b_32()
    mn_state = teacher(mn_cfg)
    mn_videos = corpus(MN_EXTRACT_LENGTHS, (224, 224))
    mn_dispatches = -(-sum(MN_EXTRACT_LENGTHS) // EXTRACT_BATCH)
    mn = ClipExtractor(mn_state, mn_cfg, batch_size=EXTRACT_BATCH,
                       decode_fn=_decoder(mn_videos), device="cuda")
    fused_normalize.launches = 0
    mn_done, _, errors = _run_extract(torch, mn, mn_videos)
    k5_launches = fused_normalize.launches
    check(errors == {}, f"MN extraction: {errors}")
    check(k5_launches == mn_dispatches, f"K5 launched {k5_launches} times for "
                                        f"{mn_dispatches} dispatches")
    mn_gap = max(_rel_l2(mn_done[v], _sequential(torch, mn, f)) for v, f in mn_videos.items())
    check(mn_gap <= EXTRACT_TOL, f"MN extractor vs sequential: rel. L2 {mn_gap}")
    check(all(np.isfinite(e).all() for e in mn_done.values()), "non-finite MN embeddings")

    # --- K1 at the towers' shapes, and the towers on it --------------------------
    k1 = {"vit_b_16": _tower_kernel(torch, (EXTRACT_BATCH, 12, ak_cfg.num_patches + 1,
                                            ak_cfg.num_patches + 1, 64), smi),
          "vit_b_32": _tower_kernel(torch, (EXTRACT_BATCH, 12, mn_cfg.num_patches + 1,
                                            mn_cfg.num_patches + 1, 64), smi)}
    towers = {"vit_b_16": _tower_pair(torch, ak_cfg, ak_state, videos, smi, "vit_b_16"),
              "vit_b_32": _tower_pair(torch, mn_cfg, mn_state, mn_videos, smi, "vit_b_32")}

    # --- the frame difference on the card -----------------------------------------
    chunk = videos["v4"][:DIFF_CHUNK]
    x = torch.from_numpy(chunk).cuda()
    with torch.inference_mode():
        diff = frame_diff(x, replicate_channels=False)
        diff_ms = cuda_ms(torch, lambda: frame_diff(x, replicate_channels=False),
                          iters=10, warmup=2)
    check(torch.equal(diff.cpu(), frame_diff(torch.from_numpy(chunk),
                                             replicate_channels=False)),
          "frame_diff on the card differs from the CPU")

    stats = {
        "frames": n_frames, "dispatches": dispatches, "batch": EXTRACT_BATCH,
        "cold_s": cold_s, "warm_frames_per_s": n_frames / warm_s,
        "peak_mem_bytes": peak, "max_rel_l2_vs_sequential": max(gaps),
        "max_rel_l2_stream_vs_whole": stream_gap, "max_rel_l2_pass_to_pass": repeat,
        "tol_rel_l2": EXTRACT_TOL, "bitwise_vs_sequential": max(gaps) == 0.0,
        "aborted": aborted, "dispatch_device_ms": prof["device_busy_ms"],
        "dispatch_wall_ms": prof["profiled_wall_ms"],
        "dispatch_idle_share": prof["device_idle_share"],
        "pass_device_ms": pass_prof["device_busy_ms"],
        "pass_wall_ms": pass_prof["profiled_wall_ms"],
        "pass_idle_share": pass_prof["device_idle_share"],
        "mn_frames": sum(MN_EXTRACT_LENGTHS), "mn_dispatches": mn_dispatches,
        "k5_launches": k5_launches, "mn_max_rel_l2_vs_sequential": mn_gap,
        "frame_diff_ms": diff_ms, "frame_diff_shape": list(diff.shape),
        "host_libraries_present": host_libs,
    }
    print("[extract] " + json.dumps(stats) + f" [{smi}]")
    return {"stats": stats, "k1": k1, "towers": towers}


class _Observed:
    """The daemon's predictor, observed: each call is passed on unchanged
    and the raw probabilities it returns are kept by video. After each call
    it sets ``started`` and waits for ``gate``, which is set except while
    the drain check holds its request in flight."""

    def __init__(self, inner):
        self.inner = inner
        self.raw: dict[str, list] = {}
        self.started = threading.Event()
        self.gate = threading.Event()
        self.gate.set()

    def _seen(self, preds):
        self.started.set()
        check(self.gate.wait(timeout=300), "the drain check never released its request")
        for p in preds:
            self.raw.setdefault(p.video_id, []).append(p.probabilities)
        return preds

    def predict_batch(self, videos, top_k=5, max_frames=None):
        return self._seen(self.inner.predict_batch(videos, top_k=top_k,
                                                   max_frames=max_frames))

    def predict(self, video, motion_video_path=None, top_k=5, max_frames=None):
        return self._seen([self.inner.predict(video, motion_video_path=motion_video_path,
                                              top_k=top_k, max_frames=max_frames)])[0]


def _post(url: str, payload: dict, timeout: float = 300) -> tuple[int, dict, float]:
    """POST JSON; (status, body, seconds until the response arrived)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.load(e), time.perf_counter() - t0


def _requests(rng, clips: list[str], n: int) -> list[dict]:
    """``n`` requests of 1-2 distinct clips each, top_k 3 or 5."""
    out = []
    for _ in range(n):
        pick = rng.choice(len(clips), int(rng.integers(1, 3)), replace=False)
        out.append({"videos": [clips[i] for i in pick], "top_k": int(rng.choice([3, 5]))})
    return out


def phase_serving(torch, seed: int, smi: str) -> dict:
    """The serving daemon (``cli/serve.py``) at full width: ``DynamicBatcher``
    and the HTTP frontend on 127.0.0.1 over the phase-4 predictor, eight
    client threads, two rounds of concurrent requests (cold, warm), checked
    against solo calls; K1 and K5 launches over the rounds; a request of
    360x640 clips only; one profiled coalesced call; the pooled/serial
    ratio; a drain with a request in flight."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from vimoclip_tpu_torch import serving
    from vimoclip_tpu_torch.cli.serve import (
        DynamicBatcher,
        make_http_server,
        prediction_record,
        serve_http,
    )
    from vimoclip_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        reset_launch_counts,
    )
    from vimoclip_tpu_torch.ops.kernels.normalize import fused_normalize

    teacher_cfg, student_cfg, tfam_cfg, states = _predictor_states(torch, seed)
    pred = serving.ViMoCLIPPredictor(
        teacher_state=states["teacher"], teacher_config=teacher_cfg,
        student_state=states["student"], student_config=student_cfg,
        tfam_state=states["tfam"], tfam_config=tfam_cfg, num_classes=140,
        frame_batch=128, length_bucket=128, max_seq_len=2048, half_precision=True,
        batch_invariant=True, device="cuda")
    del states
    rng = np.random.default_rng(seed + 11)
    clips = {f"/serve/{h}x{w}_{t}.mp4": rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)
             for (h, w), lengths in SERVE_CLIPS for t in lengths}
    names = list(clips)
    small = [n for n in names if clips[n].shape[1:3] == SERVE_CLIPS[1][0]]  # K5
    # OpenCV is not assumed on the card's machine: the script decodes from memory
    real_read = serving.read_video
    serving.read_video = lambda path, max_frames=None: clips[path][:max_frames]
    observed = _Observed(pred)
    batcher = DynamicBatcher(observed, max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS)
    server = make_http_server(observed, "127.0.0.1", 0, batcher=batcher)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    serve_thread = threading.Thread(target=serve_http, args=(server, batcher),
                                    kwargs={"install_signal_handlers": False}, daemon=True)
    serve_thread.start()
    try:
        import urllib.request

        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            check(r.status == 200, f"/healthz answered {r.status}")

        def round_(reqs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
                out = list(pool.map(lambda body: _post(f"{url}/predict", body), reqs))
            wall = time.perf_counter() - t0
            for body, (code, resp, _) in zip(reqs, out):
                check(code == 200, f"request {body} answered {code}: {resp}")
            return out, wall

        rounds = [_requests(rng, names, SERVE_REQUESTS), _requests(rng, names, SERVE_REQUESTS)]
        check(all(any(v in small for r in reqs for v in r["videos"]) for reqs in rounds),
              "a round without a 224x224 clip")
        reset_launch_counts()
        fused_normalize.launches = 0
        calls0 = batcher.stats()["predictor_calls"]
        cold, cold_s = round_(rounds[0])
        torch.cuda.reset_peak_memory_stats()
        warm, warm_s = round_(rounds[1])
        peak = torch.cuda.max_memory_allocated()
        k1 = flash_attention.launches["fwd"]
        k5 = fused_normalize.launches
        stats = batcher.stats()
        calls = stats["predictor_calls"] - calls0
        check(sum(flash_attention.launches.values()) == k1,
              f"the daemon launched other attention kernels: {flash_attention.launches}")
        check(k1 == 8 * calls, f"K1 launched {k1} times for {calls} predictor calls "
                               "(8 each: 4 layers x self + cross)")
        check(k5 > 0, "no K5 launch over requests with 224x224 clips")
        check(stats["predictor_calls"] < stats["requests"],
              f"no coalescing: {stats}")
        check(stats["max_coalesced"] >= 2, f"no pooled group of 2 or more: {stats}")
        with urllib.request.urlopen(f"{url}/stats", timeout=60) as r:
            check(json.load(r) == batcher.stats(), "/stats differs from the batcher's")

        # one request of 360x640 clips only: the resize branch, no K5
        reset_launch_counts()
        fused_normalize.launches = 0
        calls0 = batcher.stats()["predictor_calls"]
        big = [n for n in names if n not in small]
        code, resp, _ = _post(f"{url}/predict", {"videos": big, "top_k": 5})
        check(code == 200, f"360x640 request answered {code}")
        big_calls = batcher.stats()["predictor_calls"] - calls0
        check(fused_normalize.launches == 0, f"360x640 clips launched K5 "
                                             f"{fused_normalize.launches} times")
        check(flash_attention.launches["fwd"] == 8 * big_calls,
              f"K1 {flash_attention.launches['fwd']} for {big_calls} calls")

        # every record against a solo predict_batch of its clip
        solo = {v: pred.predict_batch([v], top_k=5)[0] for v in names}
        for (reqs, out) in ((rounds[0], cold), (rounds[1], warm)):
            for body, (_, resp, _) in zip(reqs, out):
                for v, rec in zip(body["videos"], resp["results"]):
                    want = prediction_record(v, dataclasses.replace(
                        solo[v], top_classes=solo[v].top_classes[: body["top_k"]]))
                    check(rec == want, f"{v}: daemon {rec} vs solo {want}")
        raw_err, bitwise = 0.0, True
        for v, probs in observed.raw.items():
            for p in probs:
                raw_err = max(raw_err, float(np.abs(p - solo[v].probabilities).max()))
                bitwise &= bool(np.array_equal(p, solo[v].probabilities))
        check(raw_err <= SERVE_TOL, f"pooled vs solo probabilities: max|d| {raw_err} "
                                    f"> {SERVE_TOL}")

        # one coalesced call under the profiler
        group = small[:2] + big[:2]
        prof = profile_request(torch, lambda: pred.predict_batch(group), smi,
                               label="serve-coalesced")

        # the pooled/serial ratio: all six clips, warm, in turns
        def pooled():
            pred.predict_batch(names)
            torch.cuda.synchronize()

        def serial():
            for v in names:
                pred.predict(v)
            torch.cuda.synchronize()

        times = {"pooled": [], "serial": []}
        pooled()
        serial()
        for name in ("serial", "pooled", "pooled", "serial"):
            t0 = time.perf_counter()
            (pooled if name == "pooled" else serial)()
            times[name].append((time.perf_counter() - t0) * 1e3)
        pooled_ms, serial_ms = min(times["pooled"]), min(times["serial"])

        # the drain: a request in flight when the server is shut down
        observed.started.clear()
        observed.gate.clear()
        inflight = {}
        client = threading.Thread(target=lambda: inflight.update(
            r=_post(f"{url}/predict", {"video": small[0], "top_k": 3})), daemon=True)
        client.start()
        check(observed.started.wait(timeout=120), "the drain's request never started")
        server.shutdown()  # the accept loop stops; the handler is still waiting
        observed.gate.set()
        serve_thread.join(timeout=300)
        client.join(timeout=60)
        check(not serve_thread.is_alive() and not client.is_alive(), "the drain hung")
        check(inflight.get("r", (None,))[0] == 200, f"in-flight request: {inflight}")
        refused = False
        try:
            urllib.request.urlopen(f"{url}/healthz", timeout=10)
        except OSError:
            refused = True
        check(refused, "a new connection was accepted after the drain")
    finally:
        observed.gate.set()
        serving.read_video = real_read
        if serve_thread.is_alive():
            server.shutdown()
            serve_thread.join(timeout=60)
        batcher.shutdown()

    lat = sorted(e for _, _, e in warm)
    out = {
        "requests_per_round": SERVE_REQUESTS, "clients": SERVE_CLIENTS,
        "max_batch": SERVE_MAX_BATCH, "max_wait_ms": SERVE_WAIT_MS,
        "videos_per_round": [sum(len(r["videos"]) for r in reqs) for reqs in rounds],
        "cold_round_s": cold_s, "warm_round_s": warm_s,
        "warm_requests_per_s": SERVE_REQUESTS / warm_s,
        "warm_p50_ms": statistics.median(lat) * 1e3,
        "warm_p95_ms": float(np.percentile(lat, 95)) * 1e3,
        "cold_p50_ms": statistics.median(e for _, _, e in cold) * 1e3,
        "peak_mem_bytes": peak, "batcher": stats, "rounds_predictor_calls": calls,
        "k1_launches": k1, "k5_launches": k5, "big_only_calls": big_calls,
        "pooled_vs_solo_max_abs": raw_err, "pooled_vs_solo_bitwise": bitwise,
        "coalesced_device_ms": prof["device_busy_ms"],
        "coalesced_wall_ms": prof["profiled_wall_ms"],
        "coalesced_idle_share": prof["device_idle_share"],
        "pooled_ms": pooled_ms, "serial_ms": serial_ms,
        "pooled_over_serial": serial_ms / pooled_ms, "pooled_serial_runs_ms": times,
    }
    print("[serve] " + json.dumps(out) + f" [{smi}]")
    return out


def phase_benchmark(torch, seed: int, smi: str) -> dict:
    """``vimo-benchmark-torch``'s device section at its CLI defaults."""
    from vimoclip_tpu_torch.cli.benchmark import _bench_gpu

    out = _bench_gpu(seed=seed)
    check(out["device"] == torch.cuda.get_device_name(0), f"benchmark device {out['device']}")
    for key in ("extract_frames_per_s", "tfam_clips_per_s"):
        check(out[key] > 0 and out[key] < float("inf"), f"benchmark {key} {out[key]}")
    print("[benchmark] " + json.dumps(out) + f" [{smi}]")
    return out


def _int_mm_check(torch, smi: str) -> dict:
    """``ops/quant.int_mm`` (``torch._int_mm`` behind row, K and N padding)
    bit for bit against the exact product in float64 (every partial sum of
    int8 products is an integer below 2^53), at 8, 16, 17 and 512 rows and
    at the ViT-B/16 blocks' shapes at the extraction batch; and the int8
    route (quantise both operands, ``_int_mm``, rescale) timed beside the
    bf16 ``F.linear`` it replaces."""
    import torch.nn.functional as F

    from vimoclip_tpu_torch.ops.quant import int8_linear, int_mm

    g = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for m, k, n in INT_MM_SHAPES:
        a = torch.randint(-127, 128, (m, k), device="cuda", generator=g, dtype=torch.int8)
        b = torch.randint(-127, 128, (n, k), device="cuda", generator=g, dtype=torch.int8)
        got = int_mm(a, b)
        exact = a.double() @ b.double().t()
        check(got.dtype == torch.int32 and tuple(got.shape) == (m, n),
              f"int_mm at {(m, k, n)}: {got.dtype} {tuple(got.shape)}")
        check(torch.equal(got.double(), exact), f"int_mm at {(m, k, n)} differs from the "
                                                "exact product")
        row = {"shape": [m, k, n], "bitwise": True}
        if m >= 4096:
            x = torch.randn(m, k, device="cuda", generator=g)
            w = torch.randn(n, k, device="cuda", generator=g) * 0.02
            xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
            row["int_mm_ms"] = cuda_ms(torch, lambda: int_mm(a, b), iters=10)
            row["int8_linear_ms"] = cuda_ms(torch, lambda: int8_linear(x, w, None,
                                                                       torch.bfloat16),
                                            iters=10)
            row["bf16_linear_ms"] = cuda_ms(torch, lambda: F.linear(xb, wb), iters=10)
        rows.append(row)
        del a, b, got, exact
    print("[accel-int-mm] " + json.dumps(rows) + f" [{smi}]")
    return {"shapes": rows}


def _k1_readings(ref, got) -> tuple[float, float]:
    """max|got - ref| / max|ref| and sum(got * ref) / sum(ref * ref) - 1."""
    ref, got = ref.double(), got.double()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    gain = ((got * ref).sum() / (ref * ref).sum()).item() - 1.0
    return rel, gain


def _k1_under_tome(torch, smi: str) -> dict:
    """K1 at every token count the two ToMe schedules leave, on q/k/v of a
    packed projection of the layer-normed merged residual stream (as
    ``MultiHeadAttention`` makes them, ~N(0, 1)): the stream stays
    contiguous, TMA reads the operands in place, and K1 agrees with its plain
    version within ``K1_TOME_REL`` and ``K1_TOME_GAIN``, limits that refuse
    a key dropped or added at the ragged tail (planted at every count)."""
    import torch.nn.functional as F

    from vimoclip_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_reference,
        tma_legal,
    )
    from vimoclip_tpu_torch.ops.tome import bipartite_merge, merge_schedule

    def refused(rel, gain):
        return rel > K1_TOME_REL or abs(gain) > K1_TOME_GAIN

    g = torch.Generator(device="cuda").manual_seed(17)
    h, d = 12, 64
    e = h * d
    w = (torch.randn(3 * e, e, device="cuda", generator=g) * e ** -0.5).to(torch.bfloat16)
    out = {"rel_limit": K1_TOME_REL, "gain_limit": K1_TOME_GAIN}
    launches = 0
    for name, (n, r) in ACCEL_TOWERS.items():
        x = torch.randn(ACCEL_BATCH, n, e, device="cuda", generator=g)
        sizes = torch.ones(x.shape[:2], device="cuda")
        schedule = merge_schedule(n, 12, r) + [0]
        rows, legal = [], True
        for step in schedule:
            t = x.shape[1]
            qkv = F.linear(F.layer_norm(x, (e,)).to(torch.bfloat16), w)
            q, k, v = (y.view(ACCEL_BATCH, t, h, d).transpose(1, 2)
                       for y in qkv.split(e, dim=-1))
            legal &= x.is_contiguous() and all(tma_legal(y) for y in (q, k, v))
            got = flash_attention(q, k, v)
            launches += 1
            ref = flash_attention_reference(q, k, v)
            rel, gain = _k1_readings(ref, got)
            check(not refused(rel, gain), f"K1 at {t} tokens ({name}, ToMe r={r}): "
                                          f"max|d|/max|ref| {rel}, gain {gain}")
            zero = torch.zeros_like(k[:, :, :1])
            faults = {
                "drop_last": (k[:, :, :-1], v[:, :, :-1]),
                "add_next": (torch.cat([k, k[:, :, :1].roll(-1, 0)], 2),
                             torch.cat([v, v[:, :, :1].roll(-1, 0)], 2)),
                "add_zero": (torch.cat([k, zero], 2), torch.cat([v, zero], 2)),
            }
            row = {"tokens": t, "rel": rel, "gain": gain}
            for fault, (fk, fv) in faults.items():
                f_rel, f_gain = _k1_readings(ref, flash_attention_reference(q, fk, fv))
                check(refused(f_rel, f_gain), f"K1's limits at {t} tokens ({name}) pass "
                      f"a planted {fault}: max|d|/max|ref| {f_rel}, gain {f_gain}")
                row[fault] = [f_rel, f_gain]
            rows.append(row)
            del qkv, q, k, v, got, ref, faults
            if step:
                x, sizes = bipartite_merge(x, sizes, step)
        check(legal, f"{name}: a merged stream or its q/k/v is not TMA-legal")
        out[name] = {"r": r, "readings": rows, "tma_legal": legal}
    torch.cuda.synchronize()
    out["k1_launches"] = launches
    print("[accel-k1] " + json.dumps(out) + f" [{smi}]")
    return out


def _replayed_merges_cos(torch, base, state, frames, r: int) -> float:
    """The bf16 ToMe tower on K1 against the same tower on eager attention,
    both applying the merges the eager run chose (``bipartite_merge``'s
    ``plan``): the per-frame cosine's minimum, with the kernel's rounding
    the only difference left."""
    from vimoclip_tpu_torch.models import clip_vit
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionEncoder
    from vimoclip_tpu_torch.ops.preprocess import clip_preprocess
    from vimoclip_tpu_torch.ops.tome import bipartite_merge, merge_plan

    plans = []
    replay = None

    def record(x, sizes, step):
        plans.append(merge_plan(x, step))
        return bipartite_merge(x, sizes, step, plan=plans[-1])

    def apply(x, sizes, step):
        return bipartite_merge(x, sizes, step, plan=next(replay))

    emb = {}
    try:
        for impl, merge in (("xla", record), ("flash", apply)):
            replay = iter(plans)
            clip_vit.bipartite_merge = merge
            cfg = dataclasses.replace(base, attention_impl=impl, token_merge_r=r)
            enc = ClipVisionEncoder(cfg, dtype=torch.bfloat16)
            enc.load_state_dict(state, strict=True)
            enc = enc.to("cuda").eval()
            with torch.inference_mode():
                emb[impl] = enc(clip_preprocess(frames, 224, dtype=torch.bfloat16)).double()
            del enc
    finally:
        clip_vit.bipartite_merge = bipartite_merge
    check(next(replay, None) is None and plans, f"{len(plans)} merges recorded, not all "
                                                "replayed")
    return torch.nn.functional.cosine_similarity(emb["flash"], emb["xla"],
                                                 dim=-1).min().item()


def _accel_towers(torch, seed: int, smi: str) -> dict:
    """Both towers at full width, bf16, the extraction batch of 256 frames
    at 224x224 (K5 then the tower), exact / int8 / ToMe / int8 + ToMe, each
    on eager attention and on K1: warm frames/s (CUDA events), the device
    ms of one dispatch, the per-frame cosine min/mean against the exact
    tower on the same attention path, K1 launches per dispatch, and each
    variant on K1 against the same variant on eager attention."""
    from vimoclip_tpu_torch.models import init_parameters_
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
    from vimoclip_tpu_torch.ops.kernels.flash_attention import flash_attention
    from vimoclip_tpu_torch.ops.preprocess import clip_preprocess

    g = torch.Generator(device="cuda").manual_seed(seed + 13)
    frames = torch.randint(0, 256, (ACCEL_BATCH, 224, 224, 3), device="cuda", generator=g,
                           dtype=torch.uint8)
    out = {}
    for name, (_, r) in ACCEL_TOWERS.items():
        base = getattr(ClipVisionConfig, name)()
        state = init_parameters_(ClipVisionEncoder(base), g).state_dict()
        variants = {"exact": {}, "int8": {"matmul_quant": "int8"},
                    "tome": {"token_merge_r": r},
                    "int8+tome": {"matmul_quant": "int8", "token_merge_r": r}}
        rows, eager = {}, {}
        for impl in ("xla", "flash"):
            exact = None
            for tag, approx in variants.items():
                cfg = dataclasses.replace(base, attention_impl=impl, **approx)
                enc = ClipVisionEncoder(cfg, dtype=torch.bfloat16)
                enc.load_state_dict(state, strict=True)
                enc = enc.to("cuda").eval()

                def run():
                    return enc(clip_preprocess(frames, 224, dtype=torch.bfloat16))

                with torch.inference_mode():
                    before = flash_attention.launches["fwd"]
                    emb = run().double()
                    torch.cuda.synchronize()
                    k1 = flash_attention.launches["fwd"] - before
                    ms = cuda_ms(torch, run, iters=4, warmup=1)
                    dev_ms = device_ms(torch, run, iters=2)
                check(bool(torch.isfinite(emb).all()), f"{name} {tag} {impl}: non-finite")
                check(k1 == (cfg.num_layers if impl == "flash" else 0),
                      f"{name} {tag} {impl}: K1 launched {k1} times in one dispatch")
                if exact is None:
                    exact = emb
                cos = torch.nn.functional.cosine_similarity(emb, exact, dim=-1)
                rows[f"{tag}/{impl}"] = row = {
                    "frames_per_s": ACCEL_BATCH / ms * 1e3, "call_ms": ms,
                    "dispatch_device_ms": dev_ms, "cos_min": cos.min().item(),
                    "cos_mean": cos.mean().item(), "k1_per_dispatch": k1}
                if impl == "xla":
                    eager[tag] = emb
                else:  # bf16 rounding differs between the paths; int8 codes
                    # and ToMe's discrete merges follow it
                    row["cos_min_vs_eager"] = vs = torch.nn.functional.cosine_similarity(
                        emb, eager[tag], dim=-1).min().item()
                    check(vs >= ACCEL_EAGER_COS_MIN[tag], f"{name} {tag}: K1 against eager "
                          f"attention, cosine {vs} < {ACCEL_EAGER_COS_MIN[tag]}")
                del enc
        rows["tome/flash"]["cos_min_vs_eager_replayed_merges"] = vs = _replayed_merges_cos(
            torch, base, state, frames, r)
        check(vs >= ACCEL_REPLAY_COS_MIN, f"{name} ToMe on K1 against eager attention with "
              f"the same merges: cosine {vs} < {ACCEL_REPLAY_COS_MIN}")
        for tag in variants:
            rows[tag + "/speedup_vs_exact_xla"] = (rows[f"{tag}/xla"]["frames_per_s"]
                                                   / rows["exact/xla"]["frames_per_s"])
        out[name] = rows
        print(f"[accel-{name}] " + json.dumps(rows) + f" [{smi}]")
        del state
        torch.cuda.empty_cache()
    return out


def _json_yaml_stand_in():
    """The card's machine has no PyYAML: the script writes the stage-2
    config as JSON, which YAML parses alike, and reads it through a stand-in
    ``yaml`` whose ``safe_load`` is ``json.load``. None when PyYAML is
    installed."""
    try:
        import yaml  # noqa: F401
        return None
    except ImportError:
        import types

        mod = types.ModuleType("yaml")
        mod.safe_load = json.load
        return mod


def phase_accelerators(torch, seed: int, smi: str) -> dict:
    """The opt-in accelerators at full width: ``_int_mm`` against the exact
    product; K1 at every ToMe token count; both towers in every variant; the
    fidelity probe on frames from the decode seam; and ``vimo-predict-torch``
    (``cli.predict.main``) with ``--quantize int8 --token-merge 16
    --verify-fidelity 8`` on reference-format files, answering two clips
    with K1 8 times per predictor call, then refusing to start at
    ``--fidelity-threshold 0.99999`` with ``FidelityError``."""
    import os
    import tempfile

    import numpy as np

    from vimoclip_tpu_torch import serving
    from vimoclip_tpu_torch.cli import predict as predict_cli
    from vimoclip_tpu_torch.data import video_reader
    from vimoclip_tpu_torch.fidelity import (
        FidelityError,
        check_encoder_fidelity,
        sample_motion_probe_frames,
    )
    from vimoclip_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        reset_launch_counts,
    )

    t_phase = time.perf_counter()
    int_mm = _int_mm_check(torch, smi)
    k1 = _k1_under_tome(torch, smi)
    towers = _accel_towers(torch, seed, smi)

    teacher_cfg, student_cfg, tfam_cfg, states = _predictor_states(torch, seed)
    rng = np.random.default_rng(seed + 13)
    clips = {f"/accel/clip{i}.mp4": rng.integers(0, 256, (t, 360, 640, 3), dtype=np.uint8)
             for i, t in enumerate(ACCEL_CLIPS)}
    names = list(clips)
    probe_frames = clips[names[0]][np.unique(np.linspace(0, ACCEL_CLIPS[0] - 1,
                                                         ACCEL_PROBE).astype(int))]
    # OpenCV is not assumed on the card's machine: both readers decode from memory
    reads = (serving.read_video, video_reader.read_video)
    serving.read_video = lambda path, max_frames=None: clips[path][:max_frames]
    video_reader.read_video = serving.read_video
    stand_in = _json_yaml_stand_in()
    if stand_in is not None:
        sys.modules["yaml"] = stand_in
    try:
        teacher_q = dataclasses.replace(teacher_cfg, matmul_quant="int8",
                                        token_merge_r=ACCEL_TOWERS["vit_b_16"][1])
        student_q = dataclasses.replace(student_cfg, matmul_quant="int8")
        probes = {
            "teacher_int8_tome16": check_encoder_fidelity(
                states["teacher"], teacher_q, names[0], ACCEL_PROBE, 0.0,
                encoder_name="teacher ViT", frames=probe_frames),
            "student_int8_frame_diff": check_encoder_fidelity(
                states["student"], student_q, names[0], ACCEL_PROBE, 0.0,
                encoder_name="student ViT",
                frames=sample_motion_probe_frames(names[0], ACCEL_PROBE)),
        }
        with tempfile.TemporaryDirectory() as tmp:
            paths = {n: os.path.join(tmp, f"{n}.pth") for n in ("teacher", "student", "tfam")}
            torch.save({f"visual.{k}": v.cpu() for k, v in states["teacher"].items()},
                       paths["teacher"])
            torch.save({f"visual_encoder.{k}": v.cpu() for k, v in states["student"].items()},
                       paths["student"])
            torch.save({k: v.cpu() for k, v in states["tfam"].items()}, paths["tfam"])
            config = os.path.join(tmp, "tfam.yaml")
            with open(config, "w") as f:
                json.dump({"data": {"num_classes": 140, "length_bucket": 128,
                                    "max_seq_len": 2048},
                           "model": dataclasses.asdict(tfam_cfg)}, f)
            del states
            argv = names + [
                "--teacher-weights", paths["teacher"],
                "--student-torch-checkpoint", paths["student"],
                "--tfam-torch-checkpoint", paths["tfam"], "--tfam-config", config,
                "--quantize", "int8", "--token-merge", str(ACCEL_TOWERS["vit_b_16"][1]),
                "--verify-fidelity", str(ACCEL_PROBE), "--top-k", "140",
                "--output", os.path.join(tmp, "pred.json")]
            reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):  # 140 lines a clip
                predict_cli.main(argv)
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            launches = dict(flash_attention.launches)
            with open(os.path.join(tmp, "pred.json")) as f:
                records = json.load(f)
            check(launches["fwd"] == 8 * len(names) and sum(launches.values()) == launches["fwd"],
                  f"vimo-predict-torch launched {launches} for {len(names)} predictor calls "
                  "(K1 8 each: 4 layers x self + cross; the towers run eager attention)")
            check([r["video"] for r in records] == names, f"records {records}")
            probs = np.array([[p["probability"] for p in r["predictions"]] for r in records])
            check(probs.shape == (len(names), 140), f"probabilities {probs.shape}")
            check(bool(np.isfinite(probs).all() and ((probs >= 0) & (probs <= 1)).all()),
                  "probabilities not finite or outside [0, 1]")
            refused = None
            try:
                predict_cli.main(argv + ["--fidelity-threshold", str(ACCEL_STRICT)])
            except FidelityError as e:
                refused = str(e)
            check(refused is not None, f"--fidelity-threshold {ACCEL_STRICT} did not stop "
                                       "vimo-predict-torch")
    finally:
        serving.read_video, video_reader.read_video = reads
        if stand_in is not None:
            sys.modules.pop("yaml", None)
    out = {"int_mm": int_mm, "k1": k1, "towers": towers, "probes": probes,
           "cli_predict_s": cli_s, "cli_k1_launches": launches["fwd"],
           "cli_calls": len(names), "strict_threshold": ACCEL_STRICT,
           "strict_refusal": refused[:160], "phase_s": time.perf_counter() - t_phase}
    print("[accel] " + json.dumps({k: v for k, v in out.items() if k not in
                                   ("int_mm", "k1", "towers")}) + f" [{smi}]")
    return out


def _gloo_rank(rank: int, store: str, out: str, cfg, items, batch) -> None:
    """Phase 14(e): one of two ranks on ``cuda:0`` over gloo, one
    data-parallel TFAM step on the global batch; rank 0 saves its loss, the
    averaged gradients and its kernel launches."""
    import torch
    import torch.distributed as dist

    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa
    from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, PAR_GLOO_RANKS), rank=rank,
                            world_size=PAR_GLOO_RANKS)
    try:
        run = Path(out) / f"rank{rank}"
        trainer = TFAMTrainer(cfg, log_dir=str(run / "logs"), checkpoint_dir=str(run / "ck"),
                              train_dataset=items, val_dataset=items)
        check(trainer.mesh.size(0) == PAR_GLOO_RANKS, "the gloo mesh is not 2 x 1")
        fa.reset_launch_counts()
        loss, _ = trainer.train_step(batch)
        torch.cuda.synchronize()
        if rank == 0:
            torch.save({"loss": float(loss), "launches": dict(fa.flash_attention.launches),
                        "grads": [p.grad.float().cpu() for p in trainer.model.parameters()
                                  if p.grad is not None]}, Path(out) / "rank0.pt")
    finally:
        dist.destroy_process_group()


def phase_parallel(torch, seed: int, smi: str, setup: dict, train: dict, student: dict,
                   main_path: dict) -> dict:
    """Data and tensor parallelism (``vimoclip_tpu_torch/parallel``) at full
    width on the one card: (a) the AK TFAM recipe in a one-rank NCCL group
    (``data_parallel: -1``) against phase 6's trainer on the same batches;
    (b) the MN student recipe the same way against phase 8; (c) ViT-B/16
    extraction with two replicas on ``cuda:0`` against one; (d) the serving
    predictor with two replicas of each tower against phase 4; (e) two
    ranks on ``cuda:0`` over gloo (CUDA tensors; checked on this card
    before the phase was written), one dropout-0.1 step held to (a)'s
    first."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from vimoclip_tpu_torch.data.pipeline import to_device
    from vimoclip_tpu_torch.extraction import ClipExtractor
    from vimoclip_tpu_torch.models import init_parameters_
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa
    from vimoclip_tpu_torch.ops.kernels.normalize import fused_normalize
    from vimoclip_tpu_torch.serving import ViMoCLIPPredictor
    from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer

    tmp = Path(tempfile.mkdtemp(dir=HERE / "build"))
    cfg, batches = setup["cfg"], setup["batches"]
    items = (setup["train_items"], setup["val_items"])
    out: dict = {}

    # --- (a), (b): a one-rank NCCL group -------------------------------------
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp / "nccl"), 1), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        dp_cfg = dataclasses.replace(cfg, training=dataclasses.replace(
            cfg.training, data_parallel=-1))
        trainer = TFAMTrainer(dp_cfg, log_dir=str(tmp / "tfam" / "logs"),
                              checkpoint_dir=str(tmp / "tfam" / "ck"),
                              train_dataset=items[0], val_dataset=items[1])
        check(trainer.mesh is not None and trainer.mesh.size() == 1,
              "the trainer built no mesh in the NCCL group")
        losses_, per_step = [], []
        fa.reset_launch_counts()
        for i, (batch, expected) in enumerate(zip(batches, setup["steps"])):
            before = dict(fa.flash_attention.launches)
            loss, _ = trainer.train_step(batch)
            got = {k: fa.flash_attention.launches[k] - before[k] for k in fa.LAUNCH_KINDS}
            check(got == _per_kind(expected), f"NCCL step launches {got}")
            if batch["embeddings"].shape[1] <= 512:
                check(got["fwd_lse"] == 8 and got["bwd_dqkv"] == 8,
                      f"K1'/K2 ran {got['fwd_lse']}/{got['bwd_dqkv']} times, not 8")
            losses_.append(float(loss))
            per_step.append(got)
            if i == 0:
                first = {"loss": losses_[0], "grads": torch.cat(
                    [p.grad.float().flatten() for p in trainer.model.parameters()
                     if p.grad is not None])}
        launches = dict(fa.flash_attention.launches)
        loss_gap = max(abs(a - b) for a, b in zip(losses_, train["step_losses"]))
        check(loss_gap <= PAR_LOSS_TOL, f"NCCL world-1 losses {losses_} vs phase 6 "
                                        f"{train['step_losses']}: {loss_gap} > {PAR_LOSS_TOL}")
        fixed = to_device(batches[0], trainer.device)
        times = []
        for i in range(13):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(fixed)
            torch.cuda.synchronize()
            if i >= 3:
                times.append(time.perf_counter() - t0)
        prof = profile_request(torch, lambda: trainer.train_step(fixed), smi,
                               label="parallel-train-profile")
        out["tfam"] = {"losses": losses_, "max_abs_vs_phase6": loss_gap,
                       "launches_per_step": per_step, "warm_step_ms": float(np.mean(times)) * 1e3,
                       "phase6_warm_step_ms": train["warm_step_ms"],
                       "device_busy_ms": prof["device_busy_ms"],
                       "device_idle_share": prof["device_idle_share"],
                       "phase6_device_idle_share": train["device_idle_share"]}
        del trainer

        rng = np.random.default_rng(seed + 3)  # phase 8's MN segments
        mn_train = _segments(rng, 6 * 8, (224, 224), 12, multi_label=False)
        mn_val = _segments(rng, 2 * 8, (224, 224), 12, multi_label=False)
        mn = _student_trainer(torch, mn_train, mn_val, "mn_dp", seed, num_classes=12,
                              class_loss="ce", data_parallel=-1)
        check(mn.mesh is not None, "the student trainer built no mesh in the NCCL group")
        fused_normalize.launches = 0
        t0 = time.perf_counter()
        best = mn.train()
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        k5 = fused_normalize.launches
        check(k5 == len(mn.train_loader) + len(mn.val_loader),
              f"K5 launched {k5} times in the NCCL student epoch")
        check(abs(best - student["mn_best_val"]) <= PAR_LOSS_TOL,
              f"NCCL student best {best} vs phase 8 {student['mn_best_val']}")
        ck = [torch.load(HERE / "build" / "chip_smoke_student" / run / "checkpoints" / "best"
                         / "best_model.pth", weights_only=True) for run in ("mn", "mn_dp")]
        param_gap = max((ck[0][k].float() - ck[1][k].float()).abs().max().item() for k in ck[0])
        check(ck[0].keys() == ck[1].keys() and param_gap <= PAR_LOSS_TOL,
              f"NCCL student checkpoint vs phase 8's: max|d| {param_gap}")
        out["student"] = {"best_val": best, "phase8_best_val": student["mn_best_val"],
                          "checkpoint_max_abs": param_gap, "k5_launches": k5,
                          "epoch_s": epoch_s, "phase8_epoch_s": student["mn_epoch_s"]}
        del mn
    finally:
        dist.destroy_process_group()

    # --- (c): extraction, two ViT-B/16 replicas on the one card ---------------
    g = torch.Generator(device="cuda").manual_seed(seed + 14)
    vit = ClipVisionConfig.vit_b_16()
    state = init_parameters_(ClipVisionEncoder(vit), g).state_dict()
    frames = torch.randint(0, 256, (sum(MN_EXTRACT_LENGTHS), 224, 224, 3), device="cuda",
                           generator=g, dtype=torch.uint8).cpu().numpy()
    starts = np.cumsum((0,) + MN_EXTRACT_LENGTHS)
    videos = {f"v{i}": frames[starts[i]:starts[i + 1]] for i in range(len(MN_EXTRACT_LENGTHS))}
    dispatches = -(-len(frames) // EXTRACT_BATCH)
    runs = {}
    for name, devices in (("one", None), ("two", ["cuda:0", "cuda:0"])):
        ext = ClipExtractor(state, vit, batch_size=EXTRACT_BATCH, decode_fn=_decoder(videos),
                            devices=devices, device="cuda")
        _run_extract(torch, ext, videos)  # cold
        fused_normalize.launches = 0
        t0 = time.perf_counter()
        done, _, errors = _run_extract(torch, ext, videos)
        runs[name] = (done, len(frames) / (time.perf_counter() - t0), fused_normalize.launches)
        check(errors == {}, f"extraction ({name}): {errors}")
        del ext
    check(runs["two"][2] == 2 * dispatches, f"K5 launched {runs['two'][2]} times for "
                                            f"{dispatches} dispatches of two replicas")
    gap = max(_rel_l2(runs["two"][0][v], runs["one"][0][v]) for v in videos)
    check(gap <= EXTRACT_TOL, f"two replicas vs one: rel. L2 {gap} > {EXTRACT_TOL}")
    out["extract"] = {"frames": len(frames), "dispatches": dispatches,
                      "k5_launches": runs["two"][2], "max_rel_l2_vs_one": gap,
                      "frames_per_s_two": runs["two"][1], "frames_per_s_one": runs["one"][1]}

    # --- (d): the predictor, two replicas of each tower ------------------------
    teacher_cfg, student_cfg, tfam_cfg, states = _predictor_states(torch, seed)
    pred = ViMoCLIPPredictor(
        teacher_state=states["teacher"], teacher_config=teacher_cfg,
        student_state=states["student"], student_config=student_cfg,
        tfam_state=states["tfam"], tfam_config=tfam_cfg, num_classes=140,
        frame_batch=128, length_bucket=128, max_seq_len=2048, half_precision=True,
        device="cuda", devices=["cuda:0", "cuda:0"])
    rng = np.random.default_rng(seed)  # phase 4's three clips
    clips = [rng.integers(0, 256, (t, 360, 640, 3), dtype=np.uint8) for t in (120, 200, 300)]
    pred.predict_videos(clips)  # cold
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    probs = np.stack([p.probabilities for p in pred.predict_videos(clips)])
    torch.cuda.synchronize()
    request_ms = (time.perf_counter() - t0) * 1e3
    k1 = fa.flash_attention.launches["fwd"]
    check(k1 == 8, f"the replicated predictor launched K1 {k1} times, expected 8")
    pred_gap = float(np.abs(probs - main_path["probs"]).max())
    check(pred_gap <= SERVE_TOL, f"two replicas vs phase 4: max|d| {pred_gap} > {SERVE_TOL}")
    out["predict"] = {"k1_launches": k1, "max_abs_vs_phase4": pred_gap,
                      "request_ms": request_ms, "phase4_request_ms": main_path["request_ms"]}
    del pred

    # --- (e): two ranks on cuda:0 over gloo -----------------------------------
    gloo_cfg = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, data_parallel=PAR_GLOO_RANKS))
    t0 = time.perf_counter()
    mp.spawn(_gloo_rank, args=(str(tmp / "gloo"), str(tmp), gloo_cfg, items[0][:8],
                               batches[0]),
             nprocs=PAR_GLOO_RANKS, join=True)
    spawn_s = time.perf_counter() - t0
    got = torch.load(tmp / "rank0.pt", weights_only=True)
    grads = torch.cat([g_.flatten() for g_ in got["grads"]]).to(first["grads"].device)
    gloo_grad = ((grads - first["grads"]).norm() / first["grads"].norm()).item()
    gloo_loss = abs(got["loss"] - first["loss"])
    check(gloo_loss <= TRAIN_LOSS_TOL, f"2 gloo ranks vs world 1: loss {got['loss']} vs "
                                       f"{first['loss']}")
    check(gloo_grad <= TRAIN_GRAD_TOL, f"2 gloo ranks vs world 1: gradients rel. L2 "
                                       f"{gloo_grad} > {TRAIN_GRAD_TOL}")
    check(got["launches"]["fwd_lse"] == 8 and got["launches"]["bwd_dqkv"] == 8,
          f"a gloo rank launched {got['launches']}")
    out["gloo"] = {"ranks": PAR_GLOO_RANKS, "loss": got["loss"], "world1_loss": first["loss"],
                   "loss_abs": gloo_loss, "grad_rel_l2": gloo_grad,
                   "rank0_launches": got["launches"], "spawn_and_step_s": spawn_s}
    out["launches"] = launches
    print("[parallel] " + json.dumps(out) + f" [{smi}]")
    out["k1_launches"] = k1
    out["k5_launches"] = runs["two"][2]
    return out


def _seq_ring(torch, seed: int, smi: str, shape=SEQ_SHAPE, rings=SEQ_RINGS) -> dict:
    """Phase 15(a) (and 17(c) at head dim 256): the ring over in-process
    shards against one call on the whole sequence, with dropout and
    padding-only blocks."""
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa
    from vimoclip_tpu_torch.parallel.sequence import (
        LocalRing,
        ring_forward,
        sequence_parallel_attention,
    )

    b, h, t, _, d = shape
    rate = 0.1
    g = torch.Generator(device="cuda").manual_seed(seed + 15)
    q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=g).to(torch.bfloat16)
               for _ in range(3))
    lengths = torch.randint(300, t + 1, (b,), device="cuda", generator=g)
    lengths[0] = 700  # row 0: key blocks past 1024 (n = 2) and 768 (n = 4) pad only
    mask = torch.arange(t, device="cuda")[None, :] >= lengths[:, None]
    seeds = torch.randint(-2**31, 2**31 - 1, (b, h), device="cuda", generator=g,
                          dtype=torch.int32)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    one = lambda: fa.flash_attention(*leaves, mask, rate, seeds)
    want = one()
    grad = torch.randn(want.shape, device="cuda", generator=g).to(torch.bfloat16)
    want_grads = torch.autograd.grad(want, leaves, grad)
    want_lse = fa.forward_lse(q, k, v, mask, seeds, rate)[1]
    one_ms = cuda_ms(torch, lambda: torch.autograd.grad(one(), leaves, grad), iters=5,
                     warmup=1)
    whole_bits = fa.dropout_keep_mask(seeds, t, t, rate)
    out = {"shape": list(shape), "one_call_fwd_bwd_ms": one_ms, "rings": {}}
    launches = dict.fromkeys(fa.LAUNCH_KINDS, 0)
    for n in rings:
        ring = LocalRing(n)
        run = lambda: sequence_parallel_attention(*leaves, ring, mask, dropout_rate=rate,
                                                  dropout_seed=seeds)
        fa.reset_launch_counts()
        got = run()
        got_grads = torch.autograd.grad(got, leaves, grad)
        torch.cuda.synchronize()
        ran = dict(fa.flash_attention.launches)
        blk = t // n
        bwd = ["bwd_dqkv"] if blk <= 512 else ["bwd_dq", "bwd_dkv"]
        ran_kinds = [fa.launch_kind(kind, d) for kind in ("fwd_lse", *bwd)]
        expected = {kind: n * n if kind in ran_kinds else 0 for kind in fa.LAUNCH_KINDS}
        check(ran == expected, f"ring n={n} launched {ran}, expected {expected}")
        for kind in fa.LAUNCH_KINDS:
            launches[kind] += ran[kind]
        _, lses = ring_forward(ring, seeds, rate, list(q.chunk(n, 2)), list(k.chunk(n, 2)),
                               list(v.chunk(n, 2)),
                               [m.contiguous().view(torch.uint8) for m in mask.chunk(n, 1)])
        out_err = (got.float() - want.float()).abs().max().item()
        lse_err = _lse_err(torch.cat(lses, dim=2), want_lse)
        grad_errs = [((a.float() - w.float()).norm() / w.float().norm()).item()
                     for a, w in zip(got_grads, want_grads)]
        check(bool(torch.isfinite(got).all()), f"ring n={n}: non-finite output")
        check(out_err <= KERNEL_TOL["bfloat16"], f"ring n={n} output vs one call: {out_err}")
        check(lse_err <= LSE_TOL, f"ring n={n} lse vs one call: {lse_err}")
        check(max(grad_errs) <= TRAIN_GRAD_TOL,
              f"ring n={n} dq/dk/dv vs one call: rel. L2 {grad_errs}")
        bits = {}
        for kind in ("fwd_lse", bwd[0]):
            for qi, ki in ((0, 0), (n - 1, 1), (1, n - 1)):
                probe = fa.kernel_keep_bits(kind, seeds, blk, blk, rate, qi * blk, ki * blk,
                                            head_dim=d)
                cut = whole_bits[..., qi * blk:(qi + 1) * blk, ki * blk:(ki + 1) * blk]
                check(torch.equal(probe, cut),
                      f"{kind} at block ({qi}, {ki}) of n={n}: keep bits differ from the "
                      f"whole call's in {int((probe != cut).sum())} places")
            bits[kind] = "equal"
        ring_ms = cuda_ms(torch, lambda: torch.autograd.grad(run(), leaves, grad), iters=5,
                          warmup=1)
        out["rings"][n] = {"launches": ran, "out_max_abs": out_err, "lse_err": lse_err,
                           "grad_rel_l2": grad_errs, "keep_bits": bits,
                           "fwd_bwd_ms": ring_ms}
    out["launches"] = launches
    del whole_bits
    return out


def _seq_pipe_rank(rank: int, world: int, store: str, out: str, jobs: list) -> None:
    """Phase 15(b)-(d): one of ``world`` gloo ranks on ``cuda:0``; every job
    of this world in order. Each saves its losses, the full gradients of its
    first step (gathered over the stages), that step's kernel launches on
    every rank, and a warm step's time."""
    import torch
    import torch.distributed as dist

    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa
    from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        for name, cfg, batches, passes in jobs:
            run = Path(out) / name / f"rank{rank}"
            trainer = TFAMTrainer(cfg, log_dir=str(run / "logs"), checkpoint_dir=str(run / "ck"),
                                  train_dataset=[], val_dataset=[])
            fa.reset_launch_counts()
            loss, logits = trainer.train_step(batches[0])
            torch.cuda.synchronize()
            launches = dict(fa.flash_attention.launches)
            grads = {n: p.grad.float() for n, p in trainer.model.named_parameters()
                     if p.grad is not None}
            if trainer.partition is not None:
                grads = trainer.partition.full_state(grads)
            losses = [float(loss)]
            for i in range(passes * len(batches)):
                if i:
                    losses.append(float(trainer.train_step(batches[i % len(batches)])[0]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(batches[0])
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            torch.save({"launches": launches, "step_ms": step_ms},
                       Path(out) / name / f"launches{rank}.pt")
            if rank == 0:
                torch.save({"losses": losses, "logits": logits.float().cpu(),
                            "grads": {n: g.cpu() for n, g in grads.items()}},
                           Path(out) / name / "rank0.pt")
            del trainer
    finally:
        dist.destroy_process_group()


def _one_card_step(torch, cfg, batch, where: Path) -> dict:
    """The AK recipe's first step on one card without a process group."""
    from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer

    trainer = TFAMTrainer(cfg, log_dir=str(where / "logs"), checkpoint_dir=str(where / "ck"),
                          train_dataset=[], val_dataset=[])
    loss, logits = trainer.train_step(batch)
    return {"loss": float(loss), "logits": logits.float().cpu(),
            "grads": {n: p.grad.float().cpu() for n, p in trainer.model.named_parameters()
                      if p.grad is not None}}


def _held(name: str, got: dict, want: dict, logits: bool = True) -> dict:
    """A sharded first step against the one-card step: loss, gradients
    (relative L2 over every parameter, in the one-card order) and logits."""
    import torch

    check(list(got["grads"]) == list(want["grads"]),
          f"{name}: the gathered gradients name other parameters than one card's")
    flat = lambda gs: torch.cat([g.flatten() for g in gs.values()])
    a, w = flat(got["grads"]), flat(want["grads"])
    grad_rel = ((a - w).norm() / w.norm()).item()
    loss_abs = abs(got["losses"][0] - want["loss"])
    check(loss_abs <= TRAIN_LOSS_TOL, f"{name}: loss {got['losses'][0]} vs one card "
                                      f"{want['loss']}")
    check(grad_rel <= TRAIN_GRAD_TOL, f"{name}: gradients rel. L2 {grad_rel} > {TRAIN_GRAD_TOL}")
    out = {"loss": got["losses"][0], "one_card_loss": want["loss"], "loss_abs": loss_abs,
           "grad_rel_l2": grad_rel}
    if logits:
        rel = ((got["logits"] - want["logits"]).norm() / want["logits"].norm()).item()
        check(rel <= TRAIN_GRAD_TOL, f"{name}: logits rel. L2 {rel} > {TRAIN_GRAD_TOL}")
        out["logits_rel_l2"] = rel
    return out


def phase_seq_pipe(torch, seed: int, smi: str, setup: dict) -> dict:
    """Sequence and pipeline parallelism at the AK recipe's full width:
    (a) the ring on in-process shards; (b)-(d) gloo ranks on ``cuda:0``
    (NCCL refuses two ranks on one card) taking trainer steps at seq 2,
    pipe 2 and pipe 2 x seq 2, held to one card."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch.multiprocessing as mp

    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa

    out = {"ring": _seq_ring(torch, seed, smi)}
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(dir=HERE / "build"))
    cfg, batches = setup["cfg"], setup["batches"]
    rng = np.random.default_rng(seed + 15)
    lengths = rng.integers(1200, SEQ_STEP_BUCKET - 127, 8)
    lengths[2] = SEQ_STEP_BUCKET - 40  # pads to the 2048 bucket
    from vimoclip_tpu_torch.data.embedding_dataset import collate_pad

    long_batch = {k: v for k, v in collate_pad(
        _clips(rng, lengths, 512, 140, "seq"), bucket=128, max_seq_len=2048).items()
        if k != "video_id"}
    check(long_batch["embeddings"].shape[1] == SEQ_STEP_BUCKET, "the seq batch is not 2048 long")
    train = lambda **kw: dataclasses.replace(cfg.training, **kw)
    model = lambda **kw: dataclasses.replace(cfg.model, **kw)
    seq_cfg = dataclasses.replace(cfg, training=train(seq_parallel=2))
    nodrop_cfg = dataclasses.replace(cfg, model=model(dropout=0.0, mlp_dropout=0.0))
    pipe_cfg = dataclasses.replace(nodrop_cfg, training=train(pipeline_parallel=2,
                                                              pipeline_microbatches=2))
    pipe_drop_cfg = dataclasses.replace(pipe_cfg, model=cfg.model)
    both_cfg = dataclasses.replace(pipe_cfg, training=train(
        pipeline_parallel=2, pipeline_microbatches=2, seq_parallel=2))
    check(batches[0]["embeddings"].shape[1] <= 512, "phase 6's first batch is past 512")
    one_seq = _one_card_step(torch, cfg, long_batch, tmp / "one_seq")
    one_pipe = _one_card_step(torch, nodrop_cfg, batches[0], tmp / "one_pipe")
    torch.cuda.empty_cache()
    worlds = {2: [("seq2", seq_cfg, [long_batch], 1), ("pipe2", pipe_cfg, batches[:1], 1),
                  ("pipe2_drop", pipe_drop_cfg, batches, 2)],
              4: [("pipe2seq2", both_cfg, batches[:1], 1)]}
    spawn_s = {}
    for world, jobs in worlds.items():
        for name, *_ in jobs:
            (tmp / name).mkdir()
        t0 = time.perf_counter()
        mp.spawn(_seq_pipe_rank, args=(world, str(tmp / f"store{world}"), str(tmp), jobs),
                 nprocs=world, join=True)
        spawn_s[world] = time.perf_counter() - t0
    got = {name: torch.load(tmp / name / "rank0.pt", weights_only=True)
           for jobs in worlds.values() for name, *_ in jobs}
    ranks = {name: [torch.load(tmp / name / f"launches{r}.pt", weights_only=True)
                    for r in range(world)]
             for world, jobs in worlds.items() for name, *_ in jobs}
    launches = dict(out["ring"]["launches"])
    for per_rank in ranks.values():
        for r in per_rank:
            for kind, n in r["launches"].items():
                launches[kind] += n
    # per rank: (b) 8 ring calls of 2 blocks of 1024 keys; (c) the stage's 2
    # layers x 2 sites x 2 microbatches: K1 in the forward, K1' and K2 when
    # the backward recomputes it; (d) the same sites, each a ring of two
    # 256-key blocks (K1' in both passes)
    expect = {"seq2": {"fwd_lse": 16, "bwd_dq": 16, "bwd_dkv": 16},
              "pipe2": {"fwd": 8, "fwd_lse": 8, "bwd_dqkv": 8},
              "pipe2seq2": {"fwd_lse": 32, "bwd_dqkv": 16}}
    for name, want in expect.items():
        want = {k: want.get(k, 0) for k in fa.LAUNCH_KINDS}
        for r, per in enumerate(ranks[name]):
            check(per["launches"] == want, f"{name} rank {r} launched {per['launches']}, "
                                           f"expected {want}")
    out["seq2"] = dict(_held("seq 2", got["seq2"], one_seq),
                       step_ms=[r["step_ms"] for r in ranks["seq2"]],
                       launches_per_rank=ranks["seq2"][0]["launches"])
    out["pipe2"] = dict(_held("pipe 2", got["pipe2"], one_pipe),
                        launches_per_rank=[r["launches"] for r in ranks["pipe2"]],
                        step_ms=[r["step_ms"] for r in ranks["pipe2"]])
    drop = got["pipe2_drop"]["losses"]
    n = len(batches)
    check(all(np.isfinite(drop)), f"pipe 2 with dropout: losses {drop}")
    check(np.mean(drop[n:]) < np.mean(drop[:n]),
          f"pipe 2 with dropout: the second pass's mean loss {np.mean(drop[n:])} did not fall "
          f"below the first's {np.mean(drop[:n])}")
    out["pipe2_drop"] = {"losses": drop, "launches_per_rank": [
        r["launches"] for r in ranks["pipe2_drop"]]}
    out["pipe2seq2"] = dict(_held("pipe 2 x seq 2", got["pipe2seq2"], one_pipe),
                            launches_per_rank=[r["launches"] for r in ranks["pipe2seq2"]],
                            step_ms=[r["step_ms"] for r in ranks["pipe2seq2"]])
    out["spawn_s"] = spawn_s
    out["launches"] = launches
    print("[seq-pipe] " + json.dumps(out) + f" [{smi}]")
    return out


def _tools():
    """The Table-2 and memory tools (``tools/``) as modules."""
    sys.path.insert(0, str(HERE / "tools"))
    import bench_memory_torch
    import run_table2_fullgeom_torch
    import run_table2_sweep_torch

    return run_table2_sweep_torch, run_table2_fullgeom_torch, bench_memory_torch


def _head_dim_route(torch, setup: dict) -> dict:
    """Phase 16(a): the AK recipe of phase 6 at 2 heads (head dim 256) takes
    one train step with dropout on each route from the same state and
    generator: ``flash`` on the wide kernels, equal to the ``xla`` step
    within ``TRAIN_LOSS_TOL``; ``auto`` where ``_auto_impl`` sends it (the
    kernels: the ``flash`` step; eager attention: the ``xla`` step; the
    same code, so within ``AUTO_LOSS_TOL``)."""
    import tempfile

    from vimoclip_tpu_torch.ops.attention import _auto_impl
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa
    from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer

    cfg, batch = setup["cfg"], setup["batches"][0]
    run = Path(tempfile.mkdtemp(dir=HERE / "build"))
    d = cfg.model.d_model // HEAD_DIM_HEADS
    out = {"heads": HEAD_DIM_HEADS, "head_dim": d}
    for impl in ("xla", "flash", "auto"):
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, nhead=HEAD_DIM_HEADS, attention_impl=impl))
        trainer = TFAMTrainer(c, log_dir=str(run / impl / "logs"),
                              checkpoint_dir=str(run / impl / "ckpt"),
                              train_dataset=setup["train_items"],
                              val_dataset=setup["val_items"])
        fa.reset_launch_counts()
        loss, _ = trainer.train_step(batch)
        torch.cuda.synchronize()
        out[f"{impl}_loss"] = float(loss)
        out[f"{impl}_launches"] = dict(fa.flash_attention.launches)
    sites = {(batch["embeddings"].shape[1], batch["motion_embeddings"].shape[1])}
    routes = {_auto_impl(True, True, tk, d, torch.bfloat16) for tk in next(iter(sites))}
    out["auto_routes"] = sorted(routes)
    layers = cfg.model.num_layers
    want_flash = {k: 0 for k in fa.LAUNCH_KINDS}
    for kind in ("fwd_lse", "bwd_dqkv"):  # both sites' keys fit one 512-key tile
        want_flash[fa.launch_kind(kind, d)] = 2 * layers
    check(max(next(iter(sites))) <= fa.SINGLE_PASS_MAX_TK, f"phase 6's first batch is past 512")
    check(out["flash_launches"] == want_flash,
          f"flash at head dim {d} launched {out['flash_launches']}, expected {want_flash}")
    check(sum(out["xla_launches"].values()) == 0, f"xla launched {out['xla_launches']}")
    diff = abs(out["flash_loss"] - out["xla_loss"])
    check(diff <= TRAIN_LOSS_TOL, f"flash vs xla loss at head dim {d}: {diff} > {TRAIN_LOSS_TOL}")
    out["flash_xla_loss_abs_diff"] = diff
    if len(routes) == 1:
        twin = routes.pop()
        diff = abs(out["auto_loss"] - out[f"{twin}_loss"])
        check(diff <= AUTO_LOSS_TOL, f"auto ({twin}) vs {twin} loss at head dim {d}: {diff} > "
                                     f"{AUTO_LOSS_TOL}")
        check(out["auto_launches"] == out[f"{twin}_launches"],
              f"auto launched {out['auto_launches']}, {twin} {out[f'{twin}_launches']}")
        out["auto_twin_loss_abs_diff"] = diff
    return out


# ---------------------------------------------------------------------------
# phase 17: head dims above 128 on the kernels
# ---------------------------------------------------------------------------


def _wide_trainer(torch, setup: dict, heads: int, where: Path, impl: str = "flash",
                  half: bool = False):
    """Phase 6's AK recipe at ``heads`` heads, float32 unless ``half``, on
    ``impl``."""
    from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer

    cfg = setup["cfg"]
    model = dataclasses.replace(cfg.model, nhead=heads, attention_impl=impl)
    c = dataclasses.replace(cfg, model=model,
                            training=dataclasses.replace(cfg.training, half_precision=half))
    return TFAMTrainer(c, log_dir=str(where / "logs"), checkpoint_dir=str(where / "ckpt"),
                       train_dataset=setup["train_items"], val_dataset=setup["val_items"])


def _wide_training(torch, setup: dict, heads: int, smi: str, base_step_ms: float) -> dict:
    """Phase 17(b) at ``heads`` heads: one epoch of phase 6's batches (the
    long batch too) through ``TFAMTrainer.train_step`` on the wide kernels,
    launches per step; 15 steps on one batch; a dropout-0 step against
    ``xla``; warm step time and idle share against eager attention."""
    import tempfile

    import numpy as np

    from vimoclip_tpu_torch import losses
    from vimoclip_tpu_torch.data.pipeline import to_device
    from vimoclip_tpu_torch.models.tfam import TFAM
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa

    cfg, batches = setup["cfg"], setup["batches"]
    layers, d = cfg.model.num_layers, cfg.model.d_model // heads
    run = Path(tempfile.mkdtemp(dir=HERE / "build"))
    trainer = _wide_trainer(torch, setup, heads, run / "flash")
    check(trainer.dtype == torch.float32, f"the trainer runs {trainer.dtype}, not float32")
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    step_losses, per_step = [], []
    for batch in batches:
        before = dict(fa.flash_attention.launches)
        loss, _ = trainer.train_step(batch)
        torch.cuda.synchronize()
        got = {k: fa.flash_attention.launches[k] - before[k] for k in fa.LAUNCH_KINDS}
        want = dict.fromkeys(fa.LAUNCH_KINDS, 0)
        for (kind, _), n in _step_launches(batch, layers, heads,
                                           fa.SINGLE_PASS_MAX_TK).items():
            want[fa.launch_kind(kind, d)] += n
        check(got == want, f"{heads} heads: step launches {got}, expected {want}")
        step_losses.append(float(loss))
        per_step.append({k: n for k, n in got.items() if n})
    # validate: the eval path, K1 only
    before = dict(fa.flash_attention.launches)
    val_loss, val_map = trainer.validate()
    val_counts = {k: fa.flash_attention.launches[k] - before[k] for k in fa.LAUNCH_KINDS}
    want = {**dict.fromkeys(fa.LAUNCH_KINDS, 0),
            fa.launch_kind("fwd", d): 2 * layers * len(trainer.val_loader)}
    check(val_counts == want, f"{heads} heads: validate launched {val_counts}, expected {want}")
    check(np.isfinite(val_loss) and 0.0 <= val_map <= 1.0, f"validate {val_loss} {val_map}")
    launches = dict(fa.flash_attention.launches)
    check(all(np.isfinite(step_losses)), f"{heads} heads: non-finite loss {step_losses}")
    for kind in ("fwd", "fwd_lse", "bwd_dqkv", "bwd_dq", "bwd_dkv"):
        check(launches[fa.launch_kind(kind, d)] > 0, f"{heads} heads: {kind} never launched")

    fixed = to_device(batches[0], trainer.device)
    fit, times = [], []
    for i in range(15):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit.append(float(trainer.train_step(fixed)[0]))
        if i >= 5:
            times.append(time.perf_counter() - t0)
    check(all(np.isfinite(fit)) and np.mean(fit[-3:]) < fit[0],
          f"{heads} heads: 15 steps on one batch did not lower the loss: {fit}")
    step_ms = float(np.mean(times)) * 1e3
    prof = profile_request(torch, lambda: trainer.train_step(fixed), smi,
                           label=f"wide-train-profile-h{heads}")

    # eager attention's warm step on the same batch (a trainer of its own)
    eager = _wide_trainer(torch, setup, heads, run / "xla", impl="xla")
    eager_times = []
    for i in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager.train_step(fixed)
        if i >= 3:
            eager_times.append(time.perf_counter() - t0)
    eager_ms = float(np.mean(eager_times)) * 1e3
    eager_prof = profile_request(torch, lambda: eager.train_step(fixed), smi,
                                 label=f"wide-eager-profile-h{heads}")
    del eager

    # flash against eager: one dropout-0 step from the same weights
    state = trainer.model.state_dict()

    def loss_and_grads(impl):
        model_cfg = dataclasses.replace(cfg.model, nhead=heads, dropout=0.0, mlp_dropout=0.0,
                                        attention_impl=impl)
        model = TFAM(model_cfg, num_classes=cfg.data.num_classes, dtype=torch.float32).cuda()
        model.load_state_dict(state)
        model.train()
        logits = model(fixed["embeddings"], fixed["motion_embeddings"],
                       fixed["mask_rgb"], fixed["mask_motion"])
        loss = losses.bce_with_logits(logits, fixed["labels"])
        loss.backward()
        grads = [p.grad.float().flatten() for p in model.parameters() if p.grad is not None]
        return loss.item(), torch.cat(grads)

    loss_f, grads_f = loss_and_grads("flash")
    loss_x, grads_x = loss_and_grads("xla")
    grad_rel_l2 = ((grads_f - grads_x).norm() / grads_x.norm()).item()
    check(abs(loss_f - loss_x) <= TRAIN_LOSS_TOL,
          f"{heads} heads: flash vs eager loss {loss_f} vs {loss_x} > {TRAIN_LOSS_TOL}")
    check(grad_rel_l2 <= TRAIN_GRAD_TOL,
          f"{heads} heads: flash vs eager gradients rel. L2 {grad_rel_l2} > {TRAIN_GRAD_TOL}")
    return {
        "heads": heads, "head_dim": d, "dtype": "float32", "step_losses": step_losses,
        "launches": launches, "launches_per_step": per_step, "fit_losses": fit,
        "val_loss": val_loss, "val_map": val_map,
        "warm_step_ms": step_ms, "device_idle_share": prof["device_idle_share"],
        "eager_warm_step_ms": eager_ms, "eager_device_idle_share": eager_prof["device_idle_share"],
        "phase6_8head_bf16_step_ms": base_step_ms,
        "flash_vs_eager_loss": [loss_f, loss_x], "flash_vs_eager_grad_rel_l2": grad_rel_l2,
        "bucket": int(fixed["embeddings"].shape[1]),
    }


def _wide_training_half(torch, setup: dict, heads: int, smi: str) -> dict:
    """Phase 17(b) in bf16 at ``heads`` heads: the AK recipe with
    ``half_precision`` on ``flash``, the slice's main path. Launches are
    counted from 0 over a train step at the 512-frame bucket (K1', K2), one
    at the 1024-frame bucket (K1', K3 + K4), an eval step (K1) and 15 steps
    on the 512-frame batch, which must lower the loss; then the warm step
    time and idle share at both buckets."""
    import tempfile

    import numpy as np

    from vimoclip_tpu_torch.data.pipeline import to_device
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa

    cfg = setup["cfg"]
    layers, d = cfg.model.num_layers, cfg.model.d_model // heads
    run = Path(tempfile.mkdtemp(dir=HERE / "build"))
    trainer = _wide_trainer(torch, setup, heads, run / "bf16", half=True)
    check(trainer.dtype == torch.bfloat16, f"the half-precision trainer runs {trainer.dtype}")
    rng = np.random.default_rng(heads)
    batches = {}
    for bucket in WIDE_HALF_BUCKETS:
        items = _clips(rng, rng.integers(bucket - 27, bucket + 1, 8), cfg.model.d_model,
                       cfg.data.num_classes, f"h{bucket}-")
        batches[bucket] = to_device(trainer.collate(items), trainer.device)
        got = tuple(batches[bucket]["embeddings"].shape[1:2])
        check(got == (bucket,), f"bf16 bucket {bucket}: frames {got}")
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    step_losses, per_step = {}, {}
    for bucket, batch in batches.items():
        before = dict(fa.flash_attention.launches)
        loss, _ = trainer.train_step(batch)
        torch.cuda.synchronize()
        got = {k: fa.flash_attention.launches[k] - before[k] for k in fa.LAUNCH_KINDS}
        want = dict.fromkeys(fa.LAUNCH_KINDS, 0)
        for (kind, _), n in _step_launches(batch, layers, heads, fa.SINGLE_PASS_MAX_TK).items():
            want[fa.launch_kind(kind, d)] += n
        check(got == want, f"bf16 {heads} heads, bucket {bucket}: launches {got}, expected {want}")
        step_losses[bucket] = float(loss)
        per_step[bucket] = {k: n for k, n in got.items() if n}
    before = dict(fa.flash_attention.launches)
    eval_loss = float(trainer.eval_step(batches[WIDE_HALF_BUCKETS[0]])[0])
    got = {k: fa.flash_attention.launches[k] - before[k] for k in fa.LAUNCH_KINDS}
    want = {**dict.fromkeys(fa.LAUNCH_KINDS, 0), fa.launch_kind("fwd", d): 2 * layers}
    check(got == want, f"bf16 {heads} heads: eval step launched {got}, expected {want}")
    fixed = batches[WIDE_HALF_BUCKETS[0]]
    fit = [float(trainer.train_step(fixed)[0]) for _ in range(15)]
    torch.cuda.synchronize()
    launches = dict(fa.flash_attention.launches)
    check(all(np.isfinite(list(step_losses.values()) + fit + [eval_loss])),
          f"bf16 {heads} heads: non-finite loss {step_losses} {fit} {eval_loss}")
    check(np.mean(fit[-3:]) < fit[0],
          f"bf16 {heads} heads: 15 steps on one batch did not lower the loss: {fit}")
    for kind in ("fwd", "fwd_lse", "bwd_dqkv", "bwd_dq", "bwd_dkv"):
        check(launches[fa.launch_kind(kind, d)] > 0, f"bf16 {heads} heads: {kind} never launched")
    step_ms, idle = {}, {}
    for bucket, batch in batches.items():
        step_ms[bucket] = cuda_ms(torch, lambda: trainer.train_step(batch), iters=5, warmup=2)
        idle[bucket] = profile_request(torch, lambda: trainer.train_step(batch), smi,
                                       label=f"wide-bf16-profile-h{heads}-{bucket}"
                                       )["device_idle_share"]
    return {"heads": heads, "head_dim": d, "dtype": "bfloat16", "step_losses": step_losses,
            "eval_loss": eval_loss, "fit_losses": fit, "launches": launches,
            "launches_per_step": per_step, "warm_step_ms": step_ms, "device_idle_share": idle}


def _wide_crossover(torch, setup: dict, smi: str) -> list[dict]:
    """Phase 17(b): ``auto``'s measurement. The trainer's step with dropout
    0.1 (``train_step``) and its eval step without (``eval_step``) at each
    of ``WIDE_CROSSOVER_BUCKETS``: above head dim 128 at 2 and 1 heads in
    float32 (the trainer's default) and bf16, and at 8 heads (head dim 64)
    in float32; every attention site on the eager path and on the kernels in
    turn (eager, kernels, kernels, eager; CUDA events, the host's launches
    included)."""
    import tempfile

    from vimoclip_tpu_torch.data.pipeline import to_device
    from vimoclip_tpu_torch.ops.attention import MultiHeadAttention, _auto_impl

    rng = setup["rng"]
    cfg = setup["cfg"]
    run = Path(tempfile.mkdtemp(dir=HERE / "build"))
    batches = {}
    for bucket in WIDE_CROSSOVER_BUCKETS:
        items = _clips(rng, rng.integers(bucket - 27, bucket + 1, 8), cfg.model.d_model,
                       cfg.data.num_classes, f"w{bucket}-")
        batches[bucket] = items
    rows = []
    for half, heads in ((False, 8), *((h, n) for h in (False, True) for n in WIDE_HEADS)):
        trainer = _wide_trainer(torch, setup, heads, run / f"h{heads}{half}", half=half)
        sites = [m for m in trainer.model.modules() if isinstance(m, MultiHeadAttention)]
        for bucket in WIDE_CROSSOVER_BUCKETS:
            batch = to_device(trainer.collate(batches[bucket]), trainer.device)
            lengths = (batch["embeddings"].shape[1], batch["motion_embeddings"].shape[1])
            check(lengths == (bucket, bucket), f"bucket {bucket}: lengths {lengths}")
            for mode in ("train", "eval"):
                step = trainer.train_step if mode == "train" else trainer.eval_step
                iters, warmup = (2, 1) if bucket >= 1024 else (5, 1)
                row = {"mode": mode, "dropout": cfg.model.dropout if mode == "train" else 0.0,
                       "dtype": "bfloat16" if half else "float32", "heads": heads,
                       "head_dim": cfg.model.d_model // heads, "bucket": bucket,
                       "xla_ms": 0.0, "flash_ms": 0.0}
                for impl in ("xla", "flash", "flash", "xla"):
                    for m in sites:
                        m.implementation = impl
                    row[f"{impl}_ms"] += cuda_ms(torch, lambda: step(batch), iters=iters,
                                                 warmup=warmup) / 2
                row["faster"] = "flash" if row["flash_ms"] < row["xla_ms"] else "xla"
                row["auto"] = _auto_impl(True, mode == "train", bucket, row["head_dim"],
                                         torch.bfloat16 if half else torch.float32)
                print("[wide-crossover] " + json.dumps(row) + f" [{smi}]")
                rows.append(row)
        del trainer
        torch.cuda.empty_cache()
    return rows


def _wide_seq_step(torch, setup: dict, smi: str) -> dict:
    """Phase 17(c): one seq-2 trainer step at 2 heads (head dim 256) as two
    spawned gloo ranks on ``cuda:0``, held to the one-card step."""
    import tempfile

    import torch.multiprocessing as mp

    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa

    cfg, batch = setup["cfg"], setup["batches"][0]
    model = dataclasses.replace(cfg.model, nhead=HEAD_DIM_HEADS)
    one_cfg = dataclasses.replace(cfg, model=model)
    seq_cfg = dataclasses.replace(one_cfg, training=dataclasses.replace(cfg.training,
                                                                         seq_parallel=2))
    tmp = Path(tempfile.mkdtemp(dir=HERE / "build"))
    one = _one_card_step(torch, one_cfg, batch, tmp / "one")
    torch.cuda.empty_cache()
    jobs = [("seq2_h2", seq_cfg, [batch], 1)]
    (tmp / "seq2_h2").mkdir()
    mp.spawn(_seq_pipe_rank, args=(2, str(tmp / "store"), str(tmp), jobs), nprocs=2, join=True)
    got = torch.load(tmp / "seq2_h2" / "rank0.pt", weights_only=True)
    ranks = [torch.load(tmp / "seq2_h2" / f"launches{r}.pt", weights_only=True)
             for r in range(2)]
    d = cfg.model.d_model // HEAD_DIM_HEADS
    layers = cfg.model.num_layers
    # per rank: 2 sites x 4 layers, each a ring of 2 blocks (K1' and K2 per
    # block: the blocks hold at most 256 keys)
    want = dict.fromkeys(fa.LAUNCH_KINDS, 0)
    want[fa.launch_kind("fwd_lse", d)] = 2 * layers * 2
    want[fa.launch_kind("bwd_dqkv", d)] = 2 * layers * 2
    for r, per in enumerate(ranks):
        check(per["launches"] == want, f"seq 2 at 2 heads: rank {r} launched "
                                       f"{per['launches']}, expected {want}")
    out = dict(_held("seq 2 at 2 heads", got, one),
               step_ms=[r["step_ms"] for r in ranks], launches_per_rank=ranks[0]["launches"])
    out["launches"] = {k: sum(r["launches"][k] for r in ranks) for k in fa.LAUNCH_KINDS}
    return out


def phase_wide(torch, seed: int, smi: str, setup: dict, base_step_ms: float) -> dict:
    """Phase 17: the attention kernels at head dims above 128. (a) K1, K1',
    K2, K3 and K4 against their plain versions at the wide shapes, in both
    dtypes, with and without dropout, timed beside SDPA (and its backend),
    and their keep bits against the plain mask; (b) stage-2 training at 2
    and 1 heads on ``flash``, in float32 and in bf16 (the paired kernels'
    path), and ``auto``'s eager-against-kernels measurement; (c) the ring at
    seq 2 and head dim 256 against one call, and a gloo seq-2 step at 2
    heads."""
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa

    out = {"k1": phase_kernels(torch, seed, smi, shapes=[WIDE_K1_SHAPE],
                               main_shape=WIDE_K1_SHAPE)}
    out["train_kernels"] = phase_training_kernels(torch, seed, smi, WIDE_MAIN_SHAPES,
                                                  shapes=WIDE_TRAIN_SHAPES)
    seeds = fa.expand_seed(seed + 17, 2, 2, "cuda")
    bits = {}
    for d in (256, 384, 512):
        for kind, rows, cols in (("fwd_lse", 128, 256), ("bwd_dqkv", 128, 320),
                                 ("bwd_dq", 128, 640)):
            got = fa.kernel_keep_bits(kind, seeds, rows, cols, 0.1, 64, 128, head_dim=d)
            want = fa.dropout_keep_mask(seeds, rows, cols, 0.1, 64, 128)
            check(torch.equal(got, want), f"{kind} at head dim {d}: keep bits differ from the "
                                          f"plain mask in {int((got != want).sum())} places")
            bits[f"{kind} D={d}"] = "equal"
    # the float32 K3 keeps no keep-bit buffer: its bits read back through dq
    for d in (64, 128, 256, 512):
        got = fa.kernel_keep_bits("bwd_dq", seeds, 128, 640, 0.1, 64, 128, head_dim=d,
                                  dtype=torch.float32)
        want = fa.dropout_keep_mask(seeds, 128, 640, 0.1, 64, 128)
        check(torch.equal(got, want), f"float32 bwd_dq at head dim {d}: keep bits differ from "
                                      f"the plain mask in {int((got != want).sum())} places")
        bits[f"bwd_dq float32 D={d}"] = "equal"
    out["keep_bits"] = bits
    print("[wide-keep-bits] " + json.dumps(bits) + f" [{smi}]")
    torch.cuda.empty_cache()

    launches = dict.fromkeys(fa.LAUNCH_KINDS, 0)
    out["training"] = {}
    for heads in WIDE_HEADS:
        row = _wide_training(torch, setup, heads, smi, base_step_ms)
        print("[wide-train] " + json.dumps(row) + f" [{smi}]")
        out["training"][heads] = row
        for k in fa.LAUNCH_KINDS:
            launches[k] += row["launches"][k]
        torch.cuda.empty_cache()
    out["training_bf16"] = {}
    for heads in WIDE_HEADS:
        row = _wide_training_half(torch, setup, heads, smi)
        print("[wide-train-bf16] " + json.dumps(row) + f" [{smi}]")
        out["training_bf16"][heads] = row
        for k in fa.LAUNCH_KINDS:
            launches[k] += row["launches"][k]
        torch.cuda.empty_cache()
    out["crossover"] = _wide_crossover(torch, setup, smi)
    torch.cuda.empty_cache()

    ring = _seq_ring(torch, seed, smi, shape=WIDE_SEQ_SHAPE, rings=(2,))
    print("[wide-ring] " + json.dumps(ring) + f" [{smi}]")
    out["ring"] = ring
    torch.cuda.empty_cache()
    out["seq2"] = _wide_seq_step(torch, setup, smi)
    print("[wide-seq2] " + json.dumps(out["seq2"]) + f" [{smi}]")
    for part in (ring, out["seq2"]):
        for k in fa.LAUNCH_KINDS:
            launches[k] += part["launches"][k]
    out["launches"] = launches
    return out


def _memory_corpus(torch, seed: int, sweep, fg) -> tuple[tuple, dict]:
    """Phase 16(b): the order-only corpus (48 + 16 videos per class) by the
    memory route on the card, four videos held to the same route on the
    CPU."""
    import numpy as np

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    items = sweep.corpus_items(seed, device="cuda", rgb_half_precision=False, **fg.CORPUS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    per_class = fg.CORPUS["videos_per_class"], fg.CORPUS["val_videos_per_class"]
    check((len(items[0]), len(items[1])) == tuple(6 * n for n in per_class),
          f"corpus of {len(items[0])} train, {len(items[1])} val clips")
    frames_done = sum(len(it["embeddings"]) + len(it["motion_embeddings"])
                      for it in items[0] + items[1])
    frames, names, _ = sweep.corpus_frames(
        seed, *per_class, order_only=fg.CORPUS["order_only"])
    n = len(frames)
    pick = [0, 1, n - 2, n - 1][:CORPUS_CHECK_VIDEOS]
    vcfg, state = sweep.tiny_teacher(fg.CORPUS["projection_dim"], seed)
    clips = [frames[i] for i in pick]
    rgb, motion = sweep.embed_clips(clips, sweep.motion_frames_of(clips, "cpu"), vcfg,
                                    state, "cpu", rgb_half_precision=False)
    by_id = {it["video_id"]: it for it in items[0] + items[1]}
    errs = []
    for i, r, m in zip(pick, rgb, motion):
        got = by_id[names[i]]
        check(got["embeddings"].shape == r.shape and got["motion_embeddings"].shape == m.shape,
              f"{names[i]}: shapes {got['embeddings'].shape}, {got['motion_embeddings'].shape}")
        for a, b in ((got["embeddings"], r), (got["motion_embeddings"], m)):
            check(bool(np.isfinite(a).all()), f"{names[i]}: non-finite embeddings")
            errs.append(float(np.linalg.norm(a - b) / np.linalg.norm(b)))
    check(max(errs) <= CORPUS_TOL, f"corpus on the card vs the CPU: rel. L2 {errs}")
    return items, {"clips": [len(items[0]), len(items[1])], "seconds": secs,
                   "frames": frames_done, "frames_per_s": frames_done / secs,
                   "cpu_rel_l2": errs}


def _fullgeom_modes(torch, items: tuple, smi: str, fg) -> dict:
    """Phase 16(d): every fusion mode through ``run_mode`` at full width for
    ``FULLGEOM_EPOCHS`` epochs, its launches held to its attention sites;
    then a warm step and a profiled one on a fresh trainer."""
    import shutil
    import tempfile

    import numpy as np

    from vimoclip_tpu_torch.data.pipeline import to_device
    from vimoclip_tpu_torch.ops.kernels import flash_attention as fa

    # a fresh run dir (run_mode resumes from one), removed at the end: the
    # checkpoints take about 0.4 GB a mode
    run_dir = tempfile.mkdtemp(dir=HERE / "build")
    batch_size = fg.RECIPE["batch_size"]
    out, launches = {}, dict.fromkeys(fa.LAUNCH_KINDS, 0)
    for mode, sites in FULLGEOM_SITES.items():
        fa.reset_launch_counts()
        res = fg.run_mode(mode, items, run_dir, "cuda", epochs=FULLGEOM_EPOCHS)
        torch.cuda.synchronize()
        ran = dict(fa.flash_attention.launches)
        steps = res["train_steps"]
        per_step = sites * fg.GEOMETRY["num_layers"]
        check(steps == FULLGEOM_EPOCHS * (len(items[0]) // batch_size),
              f"{mode}: {steps} train steps")
        want = {k: steps * per_step if k in ("fwd_lse", "bwd_dqkv") else 0
                for k in fa.LAUNCH_KINDS}
        check(ran == want, f"{mode}: launched {ran} over {steps} steps, expected {want}")
        best = res["best_val_mAP"]
        check(best is not None and 0.0 <= best <= 1.0, f"{mode}: best val mAP {best}")
        for kind in fa.LAUNCH_KINDS:
            launches[kind] += ran[kind]

        trainer = fg.make_trainer(mode, items, tempfile.mkdtemp(dir=run_dir), "cuda",
                                  epochs=FULLGEOM_EPOCHS)
        batch = to_device(trainer.collate(items[0][:batch_size]), trainer.device)
        check(batch["embeddings"].shape[1] == fg.LENGTH_BUCKET,
              f"{mode}: bucket {batch['embeddings'].shape[1]}")
        for _ in range(3):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        before, times = dict(fa.flash_attention.launches), []
        for _ in range(10):
            t0 = time.perf_counter()
            loss, _ = trainer.train_step(batch)
            check(np.isfinite(float(loss)), f"{mode}: non-finite loss")
            times.append(time.perf_counter() - t0)
        step = {k: (fa.flash_attention.launches[k] - before[k]) / 10 for k in fa.LAUNCH_KINDS}
        check(step["fwd_lse"] == step["bwd_dqkv"] == per_step,
              f"{mode}: launches per step {step}, expected {per_step} K1' and K2")
        step_ms = float(np.mean(times)) * 1e3
        prof = profile_request(torch, lambda: trainer.train_step(batch), smi,
                               label=f"fullgeom-{mode}-profile")
        hist = res["history"]
        out[mode] = {"train_steps": steps, "best_val_mAP": best, "wall_s": res["wall_s"],
                     "warm_step_ms": step_ms, "clips_per_s": batch_size / (step_ms / 1e3),
                     "launches_per_step": {"fwd_lse": per_step, "bwd_dqkv": per_step},
                     "device_idle_share": prof["device_idle_share"],
                     "device_busy_ms": prof["device_busy_ms"],
                     "train_loss": [h["train_loss"] for h in hist],
                     "val_map": [h["val_map"] for h in hist]}
        del trainer
    shutil.rmtree(run_dir)
    loss = out["cross"]["train_loss"]
    check(loss[-1] < loss[0], f"cross: epoch {FULLGEOM_EPOCHS} mean train loss {loss[-1]} not "
                              f"below epoch 1's {loss[0]}")
    out["launches"] = launches
    return out


def phase_table2(torch, seed: int, smi: str, setup: dict) -> dict:
    """Phase 16: the head-dim route, the memory-route corpus, the float32
    K1' and K2 at the contrast's shape, the four fusion modes at full width,
    and the 32:1 and 32:4 memory arms."""
    sweep, fg, membench = _tools()
    out = {"head_dim": _head_dim_route(torch, setup)}
    print("[table2-head-dim] " + json.dumps(out["head_dim"]) + f" [{smi}]")
    items, out["corpus"] = _memory_corpus(torch, seed, sweep, fg)
    print("[table2-corpus] " + json.dumps(out["corpus"]) + f" [{smi}]")
    shape = FULLGEOM_KERNEL_SHAPE
    rows = phase_training_kernels(torch, seed, smi, {"fwd_lse": shape, "bwd_dqkv": shape},
                                  shapes=[shape], dtypes=("float32",))
    out["kernels"] = {kind: {k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                 "bound_by", "max_abs_err")}
                      for kind, row in rows.items()}
    out["modes"] = _fullgeom_modes(torch, items, smi, fg)
    del items
    torch.cuda.empty_cache()
    arms = [membench.run_arm(32, n, "cuda") for n in (1, 4)]
    for a in arms:
        check(a["status"] == "ok", f"memory arm 32:{a['grad_accum']}: {a}")
    dense, accum = (a["peak_allocated_bytes"] for a in arms)
    check(accum < dense, f"grad_accum 4 peak {accum} not below the dense peak {dense}")
    out["memory"] = {f"32:{a['grad_accum']}": a["peak_allocated_gib"] for a in arms}
    out["launches"] = out["modes"].pop("launches")
    print("[table2] " + json.dumps(out) + f" [{smi}]")
    return out


def _run(cmd: list, **kw) -> tuple[int, str, str]:
    """(exit code, stdout, stderr) of ``cmd``; 127 when it is not there."""
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=DECODE_TIMEOUT_S,
                             **kw)
    except FileNotFoundError as e:
        return 127, "", str(e)
    return res.returncode, res.stdout.strip(), res.stderr.strip()


def _last_line(text: str) -> str:
    return text.splitlines()[-1] if text else ""


def phase_decode(smi: str) -> dict:
    """Phase 18: the card machine's decoders, probed without installing
    anything; ``tools/bench_decode_torch.py`` at its defaults where OpenCV
    can write its corpus. A missing library is reported; a tool that runs
    and fails, or gives a rate <= 0, fails the run."""
    t0 = time.perf_counter()
    probe = {}
    for module in ("cv2", "av"):
        rc, out, err = _run([sys.executable, "-c",
                             f"import {module}; print({module}.__version__)"])
        probe[module] = out if rc == 0 else f"missing: {_last_line(err)}"
    for lib in DECODE_LIBS:
        rc, out, err = _run(["pkg-config", "--modversion", lib])
        probe[lib] = out if rc == 0 else f"missing: {_last_line(err) or f'exit {rc}'}"
    rc, out, err = _run(["make", "-C", str(HERE / "native")])
    lib_path = HERE / "native" / "libvimo_dataplane.so"
    probe["make_native"] = ("built" if rc == 0 and lib_path.is_file()
                            else f"not built (exit {rc}): {_last_line(err) or _last_line(out)}")
    rc, out, err = _run([sys.executable, "-c", "from vimoclip_tpu_torch.data import native; "
                         "print(native.available())"], cwd=HERE)
    check(rc == 0, f"importing data/native.py failed: {_last_line(err)}")
    probe["native_available"] = out == "True"
    print("[decode-probe] " + json.dumps(probe))
    result = {"probe": probe}
    if probe["cv2"].startswith("missing"):
        result["tool"] = "not measured: no cv2 to write the corpus"
        print("[decode-tool] " + result["tool"])
    else:
        rc, out, err = _run([sys.executable, str(HERE / "tools" / "bench_decode_torch.py")],
                            cwd=HERE)
        check(rc == 0, f"tools/bench_decode_torch.py failed (exit {rc}): {err[-2000:]}")
        line = json.loads(_last_line(out))
        check(line["opencv_frames_per_s"] > 0, f"OpenCV rate {line['opencv_frames_per_s']}")
        native = line["native_pool_frames_per_s"]
        if probe["native_available"]:
            check(isinstance(native, (int, float)) and native > 0, f"native pool rate {native}")
        else:
            check(str(native).startswith("unavailable: "), f"native pool rate {native}")
        result["tool"] = line
        print("[decode-tool] " + json.dumps(line) + f" [{smi}]")
    result["seconds"] = round(time.perf_counter() - t0, 1)
    print(f"[decode] phase 18 took {result['seconds']} s")
    return result


def phase_bench(torch, smi: str) -> dict:
    """Phase 19: ``bench_torch.py`` in a subprocess, as a user runs it, and
    its line checked. Returns its kernel launches, by kind."""
    import gc
    import math

    gc.collect()
    torch.cuda.empty_cache()  # the bench's process needs the card's memory
    t0 = time.perf_counter()
    try:
        res = subprocess.run([sys.executable, str(HERE / "bench_torch.py")], cwd=HERE,
                             capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        check(False, f"bench_torch.py ran past {BENCH_TIMEOUT_S} s")
    seconds = round(time.perf_counter() - t0, 1)
    check(res.returncode == 0, f"bench_torch.py failed (exit {res.returncode}): "
                               f"{res.stderr[-3000:]}")
    line = json.loads(_last_line(res.stdout.strip()))
    print("[bench] " + json.dumps(line) + f" [{smi}]")
    d = line["detail"]
    tfam, student, serving = d["tfam_train_step"], d["student_train_step"], d["serving"]
    rates = {
        "value": line["value"], "vs_baseline": line["vs_baseline"],
        "baseline": d["baseline_ref_style_fps_same_host"],
        "turbo": d["extraction_turbo_fps"], "ceiling": d["measured_ceiling_tflops"],
        "tfam clips/s": tfam.get("clips_per_sec"),
        "student segments/s": student.get("segments_per_sec"),
        "serving latency frames/s": serving.get("video_latency_fps"),
        "serving serial videos/s": serving.get("serial_videos_per_s"),
        "serving pooled videos/s": serving.get("pooled_videos_per_s"),
    }
    for name, rate in rates.items():
        check(isinstance(rate, (int, float)) and math.isfinite(rate) and rate > 0,
              f"bench_torch.py: {name} is {rate}")
    check(d["device"] == smi, f"bench_torch.py names {d['device']!r}, not {smi!r}")
    check(tfam["launches_per_step"] == BENCH_TFAM_STEP_LAUNCHES,
          f"the bench's TFAM step launched {tfam['launches_per_step']} a step, "
          f"expected {BENCH_TFAM_STEP_LAUNCHES}")
    for where in ("launches_per_request", "launches_per_pooled_call"):
        check(serving[where] == BENCH_REQUEST_LAUNCHES,
              f"the bench's serving {where} {serving[where]}, expected {BENCH_REQUEST_LAUNCHES}")
    delta = serving["pooled_vs_serial_max_prob_delta"]
    check(delta <= 1e-5, f"the bench's pooled vs serial probabilities differ by {delta}")
    tests = d["cuda_test"]
    check(tests["status"] == "passed" and tests.get("passed", 0) >= BENCH_MIN_CARD_TESTS,
          f"the bench's card tests: {tests}")
    print(f"[bench] phase 19 took {seconds} s; card tests {tests['summary']!r} "
          f"in {tests['duration_s']} s")
    return {"launches": d["kernel_launches"], "seconds": seconds}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (HERE / "vimoclip_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no vimoclip_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import vimoclip_tpu_torch

    check(Path(vimoclip_tpu_torch.__file__).resolve().parent.parent == HERE,
          f"imported {vimoclip_tpu_torch.__file__}, not the package beside the script")
    # state both precisions: float32 products in full float32 everywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name, count, smi = phase_device(torch)
    phase_build()
    k1 = phase_kernels(torch, args.seed, smi)
    tower_k1 = phase_tower_k1(torch, args.seed, smi)
    stats = phase_main_path(torch, args.seed, smi)
    siglip = phase_siglip_tower(torch, args.seed, smi)
    ln = phase_add_layer_norm(torch, args.seed, smi)
    setup = training_setup(torch, args.seed)
    train_rows = phase_training_kernels(torch, args.seed, smi, setup["main_shapes"])
    train = phase_training(torch, setup, smi)
    setup = {"cfg": setup["cfg"], "batches": setup["batches"], "steps": setup["steps"],
             "train_items": setup["trainer"].train_loader.dataset,
             "val_items": setup["trainer"].val_loader.dataset, "rng": setup["rng"]}
    k5 = phase_normalize_kernel(torch, args.seed, smi)
    student, student_trainer = phase_student(torch, args.seed, smi)
    export = phase_export(torch, student_trainer, args.seed, smi)
    del student_trainer
    extraction = phase_extraction(torch, args.seed, smi)
    served = phase_serving(torch, args.seed, smi)
    phase_benchmark(torch, args.seed, smi)
    accel = phase_accelerators(torch, args.seed, smi)
    par = phase_parallel(torch, args.seed, smi, setup, train, student, stats)
    seq_pipe = phase_seq_pipe(torch, args.seed, smi, setup)
    table2 = phase_table2(torch, args.seed, smi, setup)
    wide = phase_wide(torch, args.seed, smi, setup, train["warm_step_ms"])
    phase_decode(smi)
    bench = phase_bench(torch, smi)["launches"]
    fwd_src = "vimoclip_tpu_torch/csrc/flash_attention_fwd.cu"
    bwd_src = "vimoclip_tpu_torch/csrc/flash_attention_bwd.cu"
    tpu = "vimoclip_tpu/ops/pallas/flash_attention.py"
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda", "source": fwd_src,
        "replaces": f"{tpu}:113",
        "launches": (stats["flash_launches"] + served["k1_launches"]
                     + accel["cli_k1_launches"] + par["k1_launches"]
                     + seq_pipe["launches"]["fwd"] + bench.get("fwd", 0)),
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
    }]
    for kind, name_, source, line in (
            ("fwd_lse", "flash_attention_fwd_lse", fwd_src, 113),
            ("bwd_dqkv", "flash_attention_bwd_dqkv", bwd_src, 282),
            ("bwd_dq", "flash_attention_bwd_dq", bwd_src, 214),
            ("bwd_dkv", "flash_attention_bwd_dkv", bwd_src, 244)):
        row = train_rows[kind]
        check(train["launches"][kind] > 0, f"{kind} never launched on the training path")
        kernels.append({
            "name": name_, "route": "cuda", "source": source, "replaces": f"{tpu}:{line}",
            "launches": (train["launches"][kind] + par["launches"][kind]
                         + seq_pipe["launches"][kind] + table2["launches"][kind]
                         + bench.get(kind, 0)),
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    # above head dim 128: the wide kernels, their launches from phases 16(a)
    # and 17
    head_dim = table2["head_dim"]
    wide_rows = {"fwd": wide["k1"], **wide["train_kernels"]}
    for kind, line in (("fwd", 113), ("fwd_lse", 113), ("bwd_dqkv", 282), ("bwd_dq", 214),
                       ("bwd_dkv", 244)):
        wkind = f"{kind}_wide"
        n = (wide["launches"][wkind] + head_dim["flash_launches"][wkind]
             + head_dim["auto_launches"][wkind])
        check(n > 0, f"{wkind} never launched on the wide paths")
        row = wide_rows[kind]
        kernels.append({
            "name": f"flash_attention_{wkind}", "route": "cuda",
            "source": fwd_src if kind.startswith("fwd") else bwd_src,
            "replaces": f"{tpu}:{line}", "launches": n, "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    # float32 K1, K1', K2, K3 and K4 (three-pass TF32: fwd_tf32_kernel,
    # dkv_tf32_kernel, dq_tf32_kernel, dq_tf32_wide_kernel), with their
    # launches on the float32 paths: phase 6's float32 recipe and phase 16's
    # contrast at head dim 64, phase 17's training above 128
    f32_launches = train["float32_auto"]["auto"]["launches"]
    wide_f32_launches = {k: sum(wide["training"][h]["launches"][k] for h in WIDE_HEADS)
                         for k in wide["launches"]}
    for kind, line in (("fwd", 113), ("fwd_lse", 113), ("bwd_dqkv", 282), ("bwd_dq", 214),
                       ("bwd_dkv", 244)):
        for wkind, row, n in (
                (kind, k1["float32"] if kind == "fwd" else train_rows[f"{kind}@float32"],
                 f32_launches[kind] + table2["launches"][kind]),
                (f"{kind}_wide", wide["k1"]["float32"] if kind == "fwd"
                 else wide["train_kernels"][f"{kind}@float32"], wide_f32_launches[f"{kind}_wide"])):
            check(n > 0, f"float32 {wkind} never launched on the float32 paths")
            kernels.append({
                "name": f"flash_attention_{wkind}_f32", "route": "cuda",
                "source": fwd_src if kind.startswith("fwd") else bwd_src,
                "replaces": f"{tpu}:{line}", "launches": n, "max_abs_err": row["max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            })
    # bf16 K1 at head dims 65-128 (fwd_pp_wgmma_kernel): its time at the
    # teacher's shape, its launches on the SigLIP towers' path
    row = tower_k1[0]
    kernels.append({
        "name": "flash_attention_fwd_pp", "route": "cuda", "source": fwd_src,
        "replaces": f"{tpu}:113", "launches": siglip["launches"],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row["library_ms"],
    })
    k5_launches = (student["mn_k5_launches"] + export["k5_launches"]
                   + extraction["stats"]["k5_launches"] + served["k5_launches"]
                   + par["k5_launches"])
    check(k5_launches > 0, "fused_normalize never launched on the stage-1 path")
    kernels.append({
        "name": "fused_normalize", "route": "cuda",
        "source": "vimoclip_tpu_torch/csrc/normalize.cu",
        "replaces": "vimoclip_tpu/ops/pallas/preprocess_kernel.py:28",
        "launches": k5_launches, "max_abs_err": k5["max_abs_err"], "ms": k5["ms"],
        "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
        "library_ms": None,
    })
    # the fused residual add + LayerNorm + cast replaces no TPU kernel (XLA
    # fuses it there); its launches on the CLIP cascade's request, the SigLIP
    # towers and the student's MN epoch
    kernels.append({
        "name": "add_layer_norm", "route": "cuda",
        "source": "vimoclip_tpu_torch/csrc/layer_norm.cu", "replaces": None,
        "launches": (stats["add_layer_norm_launches"] + siglip["add_layer_norm_launches"]
                     + student["mn_add_layer_norm_launches"]),
        "max_abs_err": ln["max_abs_err"],
        "ms": ln["ms"], "plain_ms": ln["plain_ms"], "bound_ms": ln["bound_ms"],
        "bound_by": ln["bound_by"], "library_ms": None,
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
