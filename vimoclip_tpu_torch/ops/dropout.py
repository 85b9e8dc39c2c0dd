"""8-bit-mask dropout (the port's copy of ``vimoclip_tpu/ops/dropout.py``).

``thin_dropout`` draws one uint8 per element from an explicit generator and
keeps where bits < thr, thr = round((1 - p) * 256): the keep probability is
quantised to thr / 256 (at most 1/512 from 1 - p) and the kept values are
divided by exactly that, so E[dropout(x)] == x. The bit stream differs from
JAX's, as any two frameworks' do; the quantisation and rescale are the same.
"""

from __future__ import annotations

import torch
from torch import nn


def thin_dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Functional 8-bit-mask dropout; unbiased (exact quantised rescale).
    Rates below ~1/512 are no-ops, rates within 1/512 of 1 drop
    everything."""
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"dropout rate must be in [0, 1]; got {rate}")
    if rate <= 0.0:
        return x
    thr = int(round((1.0 - rate) * 256.0))
    if thr >= 256:
        return x
    if thr <= 0:
        return torch.zeros_like(x)
    keep_prob = thr / 256.0
    bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, generator=generator,
                         device=generator.device).to(x.device)
    scaled = x / torch.tensor(keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(bits < thr, scaled, torch.zeros_like(x))


def bernoulli_dropout(x: torch.Tensor, rate: float,
                      generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate from uniform
    draws, kept values divided by 1 - rate."""
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"dropout rate must be in [0, 1]; got {rate}")
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    u = torch.rand(x.shape, generator=generator, device=generator.device).to(x.device)
    return torch.where(u < 1.0 - rate, x / (1.0 - rate), torch.zeros_like(x))


class Dropout(nn.Module):
    """``thin_dropout`` as a module: active in ``train()`` mode at a rate
    above 0, where it needs the ``generator`` argument."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in train() mode needs a generator")
        return thin_dropout(x, self.rate, generator)
