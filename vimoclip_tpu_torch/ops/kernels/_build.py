"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<name>-<hash>.so`` at the repository root, the hash taken
over the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source builds anew and an unchanged one is reused. The libraries
expose plain C functions and are bound with ``ctypes``: no PyTorch headers,
so a build takes seconds.

Nothing here runs when the module is imported. A missing ``nvcc`` or a
failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "normalize", "layer_norm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Built:
    name: str
    path: Path
    seconds: float  # 0.0 when an earlier build of the same source was reused
    log: str  # nvcc's output, with -Xptxas -v's register and spill report


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "cannot be built on this machine"
        )
    return found


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> dict[str, Built]:
    """Build every named source that has no current library, one ``nvcc``
    per source, all started together. Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, Built] = {}
    running = []
    for name in names:
        src, lib = _target(name)
        if lib.exists():
            out[name] = Built(name, lib, 0.0, "reused")
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, lib, tmp, proc, time.perf_counter()))
    failures = []
    for name, lib, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
        out[name] = Built(name, lib, seconds, log)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return out


_loaded: dict[str, ctypes.CDLL] = {}


def load_library(name: str) -> ctypes.CDLL:
    """The ``ctypes`` handle of ``lib<name>``, built on first use."""
    if name not in _loaded:
        built = build_all((name,))[name]
        _loaded[name] = ctypes.CDLL(str(built.path))
    return _loaded[name]
