"""8-bit-mask dropout (the port's copy of ``vimoclip_tpu/ops/dropout.py``).

``thin_dropout`` draws one uint8 per element from an explicit generator and
keeps where bits < thr, thr = round((1 - p) * 256): the keep probability is
quantised to thr / 256 (at most 1/512 from 1 - p) and the kept values are
divided by exactly that, so E[dropout(x)] == x. The bit stream differs from
JAX's, as any two frameworks' do; the quantisation and rescale are the same.

Under data, tensor or sequence parallelism (``shard``, ``parallel/mesh.py``)
every draw is made at the global shape and cut to this rank's block, so the
masks are the one-process run's.
"""

from __future__ import annotations

import torch
from torch import nn

from vimoclip_tpu_torch.parallel.mesh import Shard, draw


def thin_dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
                 shard: Shard | None = None, split_last: bool = False,
                 split_time: bool = False) -> torch.Tensor:
    """Functional 8-bit-mask dropout; unbiased (exact quantised rescale).
    Rates below ~1/512 are no-ops, rates within 1/512 of 1 drop
    everything. ``x`` is this rank's block under ``shard``: rows over
    ``data``, with ``split_time`` dim 1 over ``seq``, and with
    ``split_last`` its last dim over ``model``."""
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
    bits = draw(lambda s: torch.randint(0, 256, s, dtype=torch.uint8, generator=generator,
                                         device=generator.device),
                 x.shape, shard, split_last, split_time).to(x.device)
    scaled = x / torch.tensor(keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(bits < thr, scaled, torch.zeros_like(x))


def bernoulli_dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
                      shard: Shard | None = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate from uniform
    draws, kept values divided by 1 - rate; rows of ``x`` split over
    ``shard``'s data ranks."""
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"dropout rate must be in [0, 1]; got {rate}")
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    u = draw(lambda s: torch.rand(s, generator=generator, device=generator.device),
              x.shape, shard).to(x.device)
    return torch.where(u < 1.0 - rate, x / (1.0 - rate), torch.zeros_like(x))


class Dropout(nn.Module):
    """``thin_dropout`` as a module: active in ``train()`` mode at a rate
    above 0, where it needs the ``generator`` argument. ``model_split``:
    under tensor parallelism its input is a column-parallel layer's block
    of features; ``time_split``: its input is (B, T, ...), whose time a
    ``seq`` axis cuts."""

    shard: Shard | None = None  # set by parallel.partition.parallelize_

    def __init__(self, rate: float, model_split: bool = False, time_split: bool = False):
        super().__init__()
        self.rate = rate
        self.model_split = model_split
        self.time_split = time_split

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in train() mode needs a generator")
        return thin_dropout(x, self.rate, generator, self.shard, self.model_split,
                            self.time_split)
