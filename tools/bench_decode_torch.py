#!/usr/bin/env python
"""Measure video-decode throughput per CPU core with the port's data plane
(the port's twin of ``tools/bench_decode.py``, function for function).

Both backends decode one synthetic corpus, noise over a moving gradient
written by the port's ``data/video_reader.py::write_video`` (OpenCV, fourcc
``mp4v``: MPEG-4 Part 2, which the line names as the codec it wrote):

- the native ``DecodePool`` (C++ libav, ``data/native.py``; ``make native``
  builds it) with ``--workers`` threads, 1 being the per-core number;
- OpenCV through the port's ``data/video_reader.py::read_video``, with the
  native backend held off for it (``VIMO_NATIVE_DECODE=0``).

Usage: python tools/bench_decode_torch.py [--height 360 --width 640
--frames 300 --videos 4 --workers 1]

One warm-up pass, then the best of two, per backend. Prints one JSON line:
``geometry``, ``host_cores``, ``pool_workers``, ``native_pool_frames_per_s``
and ``opencv_frames_per_s`` as the JAX tool prints them, plus ``codec`` (the
written files' fourcc), ``host`` and ``cpu_model``, and ``usable_cores`` (the
cores this process may run on, which a container may cut below
``host_cores``). The native rate is ``"unavailable: <reason>"`` when the
library is not built. Without OpenCV the corpus cannot be written: the tool
says so on stderr and exits 1, printing no line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import platform
import socket
import struct
import sys
import tempfile
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

# fourcc -> codec, for the line's label
CODECS = {"mp4v": "MPEG-4 Part 2", "avc1": "H.264", "avc3": "H.264", "hvc1": "H.265",
          "hev1": "H.265"}


def make_corpus(root: str, n_videos: int, frames: int, h: int, w: int) -> list[str]:
    """Noise-over-moving-gradient clips: incompressible enough that the
    decoder does real work (pure noise inflates bitrate; pure gradient
    decodes trivially)."""
    from vimoclip_tpu_torch.data.video_reader import write_video

    rng = np.random.default_rng(0)
    paths = []
    yy = np.linspace(0, 255, h, dtype=np.float32)[:, None, None]
    for i in range(n_videos):
        base = rng.integers(0, 64, (frames, h, w, 3)).astype(np.float32)
        phase = (np.arange(frames, dtype=np.float32) * 3)[:, None, None, None]
        vid = np.clip(base + (yy + phase) % 192, 0, 255).astype(np.uint8)
        p = os.path.join(root, f"v{i}.mp4")
        write_video(p, vid)
        paths.append(p)
    return paths


def _boxes(data: bytes, start: int, end: int):
    """(type, payload start, end) of the ISO-BMFF boxes in data[start:end]."""
    while start + 8 <= end:
        size, kind = struct.unpack(">I4s", data[start:start + 8])
        header = 8
        if size == 1:
            (size,), header = struct.unpack(">Q", data[start + 8:start + 16]), 16
        elif size == 0:
            size = end - start
        if size < header:
            return
        yield kind.decode("latin-1"), start + header, start + size
        start += size


def fourcc(path: str) -> str:
    """The fourcc of the first video sample entry of an mp4 file
    (moov/trak/mdia/minf/stbl/stsd): what the writer stored."""
    with open(path, "rb") as f:
        data = f.read()
    for kind, lo, hi in _boxes(data, 0, len(data)):
        if kind != "moov":
            continue
        for trak, tlo, thi in _boxes(data, lo, hi):
            spans = [(tlo, thi)] if trak == "trak" else []
            for name in ("mdia", "minf", "stbl", "stsd"):
                spans = [(a, b) for s, e in spans for k, a, b in _boxes(data, s, e) if k == name]
            for a, _ in spans:
                # version and flags, entry count, the first entry's size, its type
                return data[a + 12:a + 16].decode("latin-1")
    raise ValueError(f"{path}: no mp4 sample description (moov/.../stsd)")


def codec_label(path: str) -> str:
    """``"<fourcc> (<codec>)"`` of the file, e.g. ``"mp4v (MPEG-4 Part 2)"``."""
    code = fourcc(path)
    return f"{code} ({CODECS.get(code, 'unknown codec')})"


def cpu_model() -> str:
    """The first CPU's model name from ``/proc/cpuinfo``; where that reads
    "unknown" (gVisor's does), its vendor, family, model and
    stepping."""
    fields = {}
    with contextlib.suppress(OSError), open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break
            key, _, value = line.partition(":")
            fields[key.strip()] = value.strip()
    name = fields.get("model name", "")
    if name and name != "unknown":
        return name
    if "vendor_id" in fields:
        return (f"{fields['vendor_id']} family {fields.get('cpu family', '?')} model "
                f"{fields.get('model', '?')} stepping {fields.get('stepping', '?')}")
    return platform.processor() or "unknown"


def host_info() -> dict:
    """The host's name and CPU model, its cores and the cores this process
    may use."""
    model = cpu_model()
    usable = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
              else os.cpu_count())
    return {"host": socket.gethostname(), "cpu_model": model, "host_cores": os.cpu_count(),
            "usable_cores": usable}


def native_unavailable() -> str | None:
    """Why the native pool cannot run here (the JAX tool's string), or None."""
    from vimoclip_tpu_torch.data import native

    try:
        return None if native.available() else "unavailable: native data plane not built"
    except OSError as e:  # built, but its libav libraries do not load
        return f"unavailable: {e}"


def bench_native_pool(paths: list[str], workers: int) -> float:
    from vimoclip_tpu_torch.data.native import DecodePool

    t0 = time.perf_counter()
    n = 0
    with DecodePool(workers=workers, chunk_frames=128) as pool:
        for i, p in enumerate(paths):
            pool.submit(f"v{i}", p)
        pool.seal()
        for _, frames, _, err in pool:
            if err is not None:
                raise RuntimeError(f"native decode pool: {err}")
            n += len(frames)
    return n / (time.perf_counter() - t0)


@contextlib.contextmanager
def _opencv_only():
    """``read_video`` on OpenCV even where the native backend is opted in."""
    old = os.environ.get("VIMO_NATIVE_DECODE")
    os.environ["VIMO_NATIVE_DECODE"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["VIMO_NATIVE_DECODE"]
        else:
            os.environ["VIMO_NATIVE_DECODE"] = old


def bench_opencv(paths: list[str]) -> float:
    from vimoclip_tpu_torch.data.video_reader import read_video

    with _opencv_only():
        t0 = time.perf_counter()
        n = sum(len(read_video(p)) for p in paths)
        return n / (time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--videos", type=int, default=4)
    ap.add_argument("--workers", type=int, default=1,
                    help="pool workers (1 == the per-core number)")
    args = ap.parse_args(argv)

    try:
        import cv2  # noqa: F401
    except ImportError as e:
        print(f"bench_decode_torch: cannot write the corpus without OpenCV ({e})",
              file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as td:
        paths = make_corpus(td, args.videos, args.frames, args.height, args.width)
        codec = codec_label(paths[0])
        native = native_unavailable()
        if native is None:
            # warm + best-of-2 (page cache, codec init)
            bench_native_pool(paths, args.workers)
            native = max(bench_native_pool(paths, args.workers) for _ in range(2))
        bench_opencv(paths)
        opencv = max(bench_opencv(paths) for _ in range(2))

    host = host_info()
    out = {
        "geometry": f"{args.videos}x{args.frames}f @ {args.height}x{args.width} "
                    f"{codec.split()[0]}",
        "codec": codec,
        "host": host["host"],
        "cpu_model": host["cpu_model"],
        "host_cores": host["host_cores"],
        "usable_cores": host["usable_cores"],
        "pool_workers": args.workers,
        "native_pool_frames_per_s": round(native, 1) if isinstance(native, float) else native,
        "opencv_frames_per_s": round(opencv, 1),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
