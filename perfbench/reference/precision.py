"""Every product of the references goes through ``linear`` / ``matmul``
here, at one of two precisions:

- ``fp32``: float32 with TF32 off (what decides ``correct``);
- ``tf32``: every operand, the backward's too, rounded to TF32 (10
  explicit mantissa bits, round to nearest even), products and sums in
  float32: the control of a float32 configuration, the reference standing
  in for the program.

The rounding is done on the operands, so a mode gives the same numbers on
the CPU and on a card. (The bfloat16 cells' control is the program's own
int8 path.)"""

from __future__ import annotations

import torch

MODES = ("fp32", "tf32")


def no_tf32() -> None:
    """Keep float32 products in float32 on a card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), still float32."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with every operand rounded to TF32, the backward's too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(round_tf32(a), round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        ga = torch.matmul(g, round_tf32(b).transpose(-1, -2))
        gb = torch.matmul(round_tf32(a).transpose(-1, -2), g)
        # sum over the axes the product broadcast
        return ga.sum_to_size(a.shape), gb.sum_to_size(b.shape)


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
    """a @ b over a's last and b's second-to-last axis, in float32."""
    a, b = a.float(), b.float()
    if mode == "tf32":
        return _TF32MatMul.apply(a, b)
    if mode != "fp32":
        raise ValueError(f"unknown precision {mode!r}; known: {MODES}")
    return torch.matmul(a, b)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           mode: str = "fp32") -> torch.Tensor:
    """x @ w.T + b (``nn.Linear``'s layout)."""
    y = matmul(x, w.t(), mode)
    return y if b is None else y + b.float()
