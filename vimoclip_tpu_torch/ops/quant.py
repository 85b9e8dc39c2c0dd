"""Dynamic int8 matmuls for the inference-only encoder forwards (the port's
copy of ``vimoclip_tpu/ops/quant.py``).

- **per-token activation scales**: each row of the activations is scaled
  symmetrically to int8 by its own absmax, computed at every call (no
  calibration);
- **per-output-channel weight scales**: each row of an ``nn.Linear`` weight
  (N, K), i.e. each column of the JAX kernel (K, N), gets its own absmax
  scale; the weights are quantised from their float32 values at every call,
  as in JAX;
- the product is int8 x int8 with an int32 sum (``int_mm``), then a float32
  rescale by the outer product of the two scale vectors and the bias in
  float32.

The rounding points are JAX's: ``scale = max(amax, 1e-12) / 127``,
``q = clip(round(x / scale), -127, 127)`` (round half to even in both), the
scale product before the rescale, the bias added in float32 after it, then
the cast. The int32 sum is exact, so the result does not depend on the
order of the sum or on how the projections are packed.

An approximation, so strictly opt-in (``ClipVisionConfig.matmul_quant=
"int8"``, the CLIs' ``--quantize int8``); ``fidelity.py`` measures what it
costs on the user's own weights. Training never uses it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_EPS = 1e-12
# torch._int_mm (cuBLASLt) takes more than 16 rows, and K and N multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


def quantize_absmax(
    x: torch.Tensor, dims: int | tuple[int, ...] = -1
) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation with one scale per slice along ``dims``.

    Returns ``(q, scale)``: ``q`` int8, ``scale`` float32 shaped like ``x``
    with ``dims`` reduced (keepdim); ``x`` is ``q.float() * scale`` up to
    rounding. The arithmetic is float32 whatever ``x``'s dtype."""
    xf = x.float()
    amax = xf.abs().amax(dim=dims, keepdim=True)
    scale = amax.clamp_min(_EPS) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def quantize_rowwise(x: torch.Tensor, dim: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_absmax`` over one dimension (the common case)."""
    return quantize_absmax(x, dim)


def _pad2(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if tuple(t.shape) == (rows, cols):
        return t
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """Exact int32 product ``a @ b_t.T`` of int8 ``a`` (M, K) and int8
    ``b_t`` (N, K).

    On a card it is ``torch._int_mm`` (cuBLASLt's int8 GEMM: the JAX package
    leaves this product to XLA's ``dot_general``, outside any Pallas
    kernel), with ``a`` row-major and the weight column-major. Rows are
    zero-padded to more than 16, and K and N to multiples of 8, then sliced
    off: a zero row or column adds nothing to the sums. On the CPU it is an
    int32 matmul, exact as well."""
    if a.dtype != torch.int8 or b_t.dtype != torch.int8:
        raise TypeError(f"int_mm takes int8 operands, got {a.dtype} and {b_t.dtype}")
    if a.ndim != 2 or b_t.ndim != 2 or a.shape[1] != b_t.shape[1]:
        raise ValueError(f"shape mismatch: a {tuple(a.shape)} @ b_t.T {tuple(b_t.shape)}")
    if not a.is_cuda:
        return a.to(torch.int32) @ b_t.to(torch.int32).t()
    m, k = a.shape
    n = b_t.shape[0]
    up = lambda v: -(-v // _INT_MM_ALIGN) * _INT_MM_ALIGN
    kp, np_ = up(k), up(n)
    ap = _pad2(a, max(m, _INT_MM_MIN_ROWS), kp).contiguous()
    bp = _pad2(b_t, np_, kp).contiguous()
    return torch._int_mm(ap, bp.t())[:m, :n]


def int8_linear(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``F.linear(x, weight, bias)`` through dynamic int8 (JAX's
    ``Int8Dense``): x (..., K) in any float dtype, weight (N, K) and bias (N,)
    float. Per-row activation scales times per-output-channel weight scales,
    int32 sum, float32 rescale and bias, then ``out_dtype`` (default
    ``x.dtype``)."""
    if weight.ndim != 2 or x.shape[-1] != weight.shape[1]:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)} @ weight.T {tuple(weight.shape)}"
        )
    lead = x.shape[:-1]
    xq, xs = quantize_rowwise(x.reshape(-1, x.shape[-1]), dim=-1)  # (M, K), (M, 1)
    wq, ws = quantize_rowwise(weight, dim=1)  # (N, K), (N, 1)
    y = int_mm(xq, wq).float() * (xs * ws.t())
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype or x.dtype).reshape(*lead, weight.shape[0])


def int8_dynamic_matmul(
    x: torch.Tensor, kernel: torch.Tensor, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """``x @ kernel`` through dynamic int8, with the JAX function's kernel
    layout (K, N)."""
    if kernel.ndim != 2 or x.shape[-1] != kernel.shape[0]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} @ kernel {tuple(kernel.shape)}")
    return int8_linear(x, kernel.t(), out_dtype=out_dtype)


class Int8Linear(nn.Linear):
    """``nn.Linear`` whose product runs in dynamic int8 (JAX's
    ``Int8Dense``). Its parameters are ``nn.Linear``'s (float32 ``weight``
    (N, K), ``bias`` (N,)), so state dicts load unchanged with
    ``strict=True``; only the forward is quantised. The output has the
    input's dtype; the port's encoders call it through
    ``ops/attention.py::dense`` with their compute dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_linear(x, self.weight, self.bias)


def make_dense(quant: str | None) -> type[nn.Linear]:
    """Linear-layer factory: ``None`` -> ``nn.Linear``, ``"int8"`` ->
    ``Int8Linear``; anything else raises when the module is built."""
    if quant is None or quant == "none":
        return nn.Linear
    if quant == "int8":
        return Int8Linear
    raise ValueError(f"unknown matmul_quant {quant!r} (None | 'int8')")
