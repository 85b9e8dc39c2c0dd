"""Models of the serving cascade: the CLIP ViT towers and TFAM."""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def init_parameters_(module: nn.Module, generator: torch.Generator,
                     std: float = 0.02) -> nn.Module:
    """Seeded random init of every parameter, drawn from ``generator`` in
    ``named_parameters`` order: LayerNorm weights 1, biases 0, everything
    else normal(0, std). For runs on random weights (no checkpoint in the
    repository); the draw happens on the generator's device."""
    norms = {id(m.weight) for m in module.modules() if isinstance(m, nn.LayerNorm)}
    for name, p in module.named_parameters():
        if id(p) in norms:
            p.fill_(1.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.copy_(torch.empty(p.shape, device=generator.device)
                    .normal_(0.0, std, generator=generator))
    return module
