"""Fused uint8 -> CLIP-normalised float conversion: the CUDA kernel and its
plain PyTorch version.

The counterpart of ``vimoclip_tpu/ops/pallas/preprocess_kernel.py::
fused_normalize`` (kernel ``_normalize_kernel`` :28), K5:
``csrc/normalize.cu``, whose header says what bounds it on the H100 and what
its design does about it.

- ``out = (float(x) - sub_c) * mul_c`` per channel c, with ``sub = f32(mean)
  * 255`` and ``mul = 1 / (f32(std) * 255)`` taken in float32 on the host as
  JAX takes them, then one rounding to float32 or bfloat16. Kernel and plain
  version do the same two roundings, so they agree bit for bit.
- On a CUDA tensor ``fused_normalize`` launches the kernel or raises; on a
  CPU tensor it runs ``fused_normalize_reference``. Nothing falls back.
- ``fused_normalize.launches`` counts kernel launches, never CPU calls.

``clip_preprocess`` runs it whenever the frames already have the encoder's
size (no resize, no crop): stage-1 training at 224x224 and motion export
with ``--resize 224 224``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vimoclip_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def normalize_constants(mean=CLIP_MEAN, std=CLIP_STD) -> tuple[np.ndarray, np.ndarray]:
    """(sub, mul), three float32 each, as JAX computes them
    (preprocess_kernel.py:60-61): f32(mean) * 255 and 1 / (f32(std) * 255)."""
    f32 = np.float32
    sub = np.asarray(mean, f32) * f32(255.0)
    mul = f32(1.0) / (np.asarray(std, f32) * f32(255.0))
    return sub.astype(f32), mul.astype(f32)


def _check(images: torch.Tensor, dtype: torch.dtype) -> None:
    if images.ndim < 1 or images.shape[-1] != 3:
        raise ValueError(f"expected trailing channel dim 3, got {tuple(images.shape)}")
    if images.dtype != torch.uint8:
        raise TypeError(f"fused_normalize takes uint8 images, not {images.dtype}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_normalize writes float32 or bfloat16, not {dtype}")


def fused_normalize_reference(images: torch.Tensor, mean=CLIP_MEAN, std=CLIP_STD,
                              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K5: (float32(x) - sub) * mul, then ``dtype``."""
    _check(images, dtype)
    sub, mul = (torch.from_numpy(c).to(images.device) for c in normalize_constants(mean, std))
    return ((images.to(torch.float32) - sub) * mul).to(dtype)


def _bind():
    from vimoclip_tpu_torch.ops.kernels._build import load_library

    lib = load_library("normalize")
    fn = lib.vimo_fused_normalize
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.vimo_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vimo_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(images: torch.Tensor, mean, std, dtype: torch.dtype) -> torch.Tensor:
    x = images.contiguous()  # a contiguous view keeps its offset: any alignment works
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    sub, mul = normalize_constants(mean, std)
    lib, fn = _bind()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), x.numel(), _DTYPE_CODES[dtype],
                *map(float, sub), *map(float, mul), stream)
    if rc != 0:
        reason = (lib.vimo_cuda_error_string(rc).decode() if rc > 0
                  else f"unsupported arguments (code {rc})")
        raise RuntimeError(f"fused_normalize kernel launch failed: {reason}")
    fused_normalize.launches += 1
    return out


def fused_normalize(images: torch.Tensor, mean=CLIP_MEAN, std=CLIP_STD,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., H, W, 3) uint8 -> CLIP-normalised ``dtype`` (float32 or
    bfloat16) of the same shape: the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    _check(images, dtype)
    if images.device.type == "cpu":
        return fused_normalize_reference(images, mean, std, dtype)
    if images.device.type != "cuda":
        raise ValueError(f"fused_normalize runs on cuda or cpu, not {images.device}")
    return _launch(images, mean, std, dtype)


fused_normalize.launches = 0
