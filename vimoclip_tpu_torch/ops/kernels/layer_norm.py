"""Fused residual add + LayerNorm + cast between the vision towers' GEMMs:
the CUDA kernel and its plain PyTorch version.

It replaces no TPU kernel: the JAX package leaves the residual add and the
LayerNorm to XLA. ``csrc/layer_norm.cu``'s header says what bounds it on the
H100 and what its design does about it.

- ``x_out = x + delta`` in float32 (``delta`` float32 or bfloat16, or None),
  then ``h = LayerNorm(x_out)`` in float32 with the module's weight, bias and
  eps, written in ``out_dtype`` (float32 or bfloat16). Returns ``(x_out,
  h)``; ``x_out`` is a new tensor, or ``x`` itself without ``delta``.
- ``x_out`` is bit-equal between kernel and plain version; ``h`` differs by
  the order of the mean's and the variance's sums alone.
- ``add_layer_norm`` launches the kernel on a CUDA tensor and runs
  ``add_layer_norm_reference`` on a CPU tensor; on any other device, or a
  CUDA tensor the kernel does not take, it raises. Where autograd records
  (student training), the kernel runs inside ``_AddLayerNorm``: it also
  writes each row's mean and rstd, and the backward is PyTorch's LayerNorm
  backward on them plus the add's identity gradient.
- ``add_layer_norm.launches`` counts kernel launches, never plain calls.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import nn

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HIDDEN = 2048  # the kernel's 16 four-element chunks a lane


def add_layer_norm_reference(x: torch.Tensor, delta: torch.Tensor | None, ln: nn.LayerNorm,
                             out_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """``x + delta``, then ``F.layer_norm`` in float32, then ``out_dtype``."""
    if delta is not None:
        x = x + delta
    h = F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)
    return x, h.to(out_dtype)


def _check(x: torch.Tensor, delta: torch.Tensor | None, weight: torch.Tensor,
           bias: torch.Tensor, out_dtype: torch.dtype) -> None:
    hidden = x.shape[-1] if x.ndim else 0
    if tuple(weight.shape) != (hidden,) or tuple(bias.shape) != (hidden,):
        raise ValueError(f"add_layer_norm normalises the last dim: {tuple(x.shape)} against "
                         f"normalized_shape {tuple(weight.shape)}")
    if hidden % 4 or not 0 < hidden <= MAX_HIDDEN:
        raise ValueError(f"the add_layer_norm kernel takes a hidden size that is a multiple "
                         f"of 4 up to {MAX_HIDDEN}, not {hidden}")
    if x.dtype != torch.float32:
        raise TypeError(f"the add_layer_norm kernel takes a float32 residual stream, not "
                        f"{x.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"add_layer_norm writes float32 or bfloat16, not {out_dtype}")
    tensors = {"x": x, "weight": weight, "bias": bias}
    if delta is not None:
        if delta.shape != x.shape or delta.dtype not in _DTYPE_CODES:
            raise ValueError(f"delta {tuple(delta.shape)} {delta.dtype} against x "
                             f"{tuple(x.shape)}: the same shape, float32 or bfloat16")
        tensors["delta"] = delta
    for name, t in tensors.items():
        if t is None or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"add_layer_norm kernel: {name} must be a contiguous tensor on "
                             f"{x.device}")
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("the add_layer_norm kernel takes a float32 weight and bias")


def _bind():
    from vimoclip_tpu_torch.ops.kernels._build import load_library

    lib = load_library("layer_norm")
    fn = lib.vimo_add_layer_norm
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_int, p, p, p, p, ctypes.c_int, p, p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.vimo_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vimo_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(x: torch.Tensor, delta: torch.Tensor | None, weight: torch.Tensor,
            bias: torch.Tensor, eps: float, out_dtype: torch.dtype, stats: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """One kernel launch: ``(x_out, h, mean, rstd)``, the last two (shape
    ``x.shape[:-1] + (1,)``, float32) only with ``stats``."""
    _check(x, delta, weight, bias, out_dtype)
    hidden = x.shape[-1]
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    x_out = x if delta is None else torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean, rstd = torch.empty((2, *x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    lib, fn = _bind()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), None if delta is None else delta.data_ptr(),
                0 if delta is None else _DTYPE_CODES[delta.dtype],
                weight.data_ptr(), bias.data_ptr(),
                None if delta is None else x_out.data_ptr(), out.data_ptr(),
                _DTYPE_CODES[out_dtype], None if mean is None else mean.data_ptr(),
                None if rstd is None else rstd.data_ptr(), x.numel() // hidden, hidden,
                float(eps), stream)
    if rc != 0:
        reason = (lib.vimo_cuda_error_string(rc).decode() if rc > 0
                  else {-1: "unsupported hidden size or dtype",
                        -2: "a tensor not aligned to 16 bytes"}.get(rc, f"code {rc}"))
        raise RuntimeError(f"add_layer_norm kernel launch failed: {reason}")
    if x.numel():
        add_layer_norm.launches += 1
    return x_out, out, mean, rstd


class _AddLayerNorm(torch.autograd.Function):
    """The kernel where autograd records: forward ``(x_out, h)`` with a
    delta, ``h`` alone without (``x_out`` is then ``x``); backward PyTorch's
    LayerNorm backward on the kernel's mean and rstd, plus the add's
    identity gradient to ``x`` and ``delta``."""

    @staticmethod
    def forward(ctx, x, delta, weight, bias, eps, out_dtype):
        x_out, h, mean, rstd = _launch(x, delta, weight, bias, eps, out_dtype,
                                       stats=any(ctx.needs_input_grad))
        ctx.save_for_backward(x_out, weight, bias, mean, rstd)
        ctx.delta_dtype = None if delta is None else delta.dtype
        return h if delta is None else (x_out, h)

    @staticmethod
    def backward(ctx, *grads):
        x_out, weight, bias, mean, rstd = ctx.saved_tensors
        grad_x_out, grad_h = (None, *grads) if ctx.delta_dtype is None else grads
        need_x, need_delta, need_w, need_b = ctx.needs_input_grad[:4]
        dx, dw, db = torch.ops.aten.native_layer_norm_backward(
            grad_h.float().contiguous(), x_out, [x_out.shape[-1]], mean, rstd, weight, bias,
            [need_x or need_delta, need_w, need_b])
        if dx is not None and grad_x_out is not None:
            dx = dx + grad_x_out
        return (dx if need_x else None,
                dx.to(ctx.delta_dtype) if need_delta else None, dw, db, None, None)


def add_layer_norm(x: torch.Tensor, delta: torch.Tensor | None, ln: nn.LayerNorm,
                   out_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """``(x + delta, LayerNorm(x + delta) in out_dtype)`` over the last dim:
    the kernel on a CUDA tensor, under autograd too; the plain version on a
    CPU tensor."""
    if x.device.type == "cpu":
        return add_layer_norm_reference(x, delta, ln, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"add_layer_norm runs on cuda or cpu, not {x.device}")
    return _kernel(x, delta, ln, out_dtype)


def _kernel(x: torch.Tensor, delta: torch.Tensor | None, ln: nn.LayerNorm,
            out_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's route, through ``_AddLayerNorm`` where autograd records."""
    tensors = (x, delta, ln.weight, ln.bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        out = _AddLayerNorm.apply(x, delta, ln.weight, ln.bias, float(ln.eps), out_dtype)
        return (x, out) if delta is None else out
    x_out, h, _, _ = _launch(x, delta, ln.weight, ln.bias, ln.eps, out_dtype)
    return x_out, h


add_layer_norm.launches = 0
