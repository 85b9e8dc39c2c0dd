"""Token merging (ToMe) for the ViT encoder (the port's copy of
``vimoclip_tpu/ops/tome.py``): an opt-in approximation that merges ``r``
patch tokens after every encoder block by bipartite soft matching (Bolya et
al., "Token Merging: Your ViT But Faster", ICLR 2023).

As in the JAX package: the matching metric is the block's output hidden
state, merges happen at block boundaries, there is no proportional
attention, and the token count after each block is fixed by ``r`` alone,
so every block runs at a shape known before the call.

- The scores are cosines in float32 whatever the tower's dtype.
- Ties: ``argmax`` takes the first maximum and the ranking is a stable
  sort, as ``jnp.argmax`` / ``jnp.argsort`` do.
- The merged tokens are folded into their targets by one-hot products in
  float32, as in JAX, not by ``index_add_``: the sum over the tokens
  merged into one target is a dense product, in the same order at every
  call on every device (``index_add_`` sums with atomics on a card, in an
  order that changes from run to run).

Strictly opt-in (``ClipVisionConfig.token_merge_r``, the CLIs'
``--token-merge R``); ``fidelity.py`` measures what it costs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def merge_plan(x: torch.Tensor, r: int,
               protect_first: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """ToMe's matching for one step of ``bipartite_merge``: each A token's
    most cosine-similar B token ``dst`` (B, Na) and the A tokens ranked by
    that similarity, best first, ``order`` (B, Na); the first ``r`` of the
    ranking merge."""
    start = 1 if protect_first else 0
    body = x[:, start:]
    xb, xa = body[:, 0::2], body[:, 1::2]  # (B, Nb, C), (B, Na, C)

    def unit(t):
        return t / torch.linalg.vector_norm(t.float(), dim=-1, keepdim=True).clamp_min(1e-6)

    scores = torch.matmul(unit(xa), unit(xb).transpose(1, 2))  # (B, Na, Nb) cosine
    best, dst = scores.amax(dim=-1), scores.argmax(dim=-1)  # the first maximum on ties
    return dst, torch.argsort(-best, dim=-1, stable=True)


def bipartite_merge(
    x: torch.Tensor, sizes: torch.Tensor, r: int, protect_first: bool = True,
    plan: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One ToMe step: (B, N, C) -> (B, N - r, C) by merging ``r`` tokens.

    The tokens after the protected CLS split alternately into B (even
    offsets, the targets) and A (odd offsets, the candidates); each A token
    is scored against its most cosine-similar B token, the ``r`` best
    matched A tokens are folded into their targets by size-weighted mean,
    and the rest are kept. ``sizes`` (B, N) float32 counts the original
    tokens each token stands for. ``plan`` is a ``merge_plan`` to apply in
    place of the one ``x`` gives (to hold two runs to the same merges).

    Output order: [CLS] + the B set with merges applied + the kept A
    tokens, in their ranking order."""
    n = x.shape[1]
    start = 1 if protect_first else 0
    na = (n - start) // 2
    nb = (n - start) - na
    if r <= 0:
        return x, sizes
    if r > na:
        raise ValueError(f"r={r} exceeds the {na} merge candidates of n={n}")

    cls_x, cls_s = x[:, :start], sizes[:, :start]
    body_x, body_s = x[:, start:], sizes[:, start:]
    xb, xa = body_x[:, 0::2], body_x[:, 1::2]  # (B, Nb, C), (B, Na, C)
    sb, sa = body_s[:, 0::2], body_s[:, 1::2]
    dst, order = merge_plan(x, r, protect_first) if plan is None else plan
    merged_idx, kept_idx = order[:, :r], order[:, r:]

    def take(t, idx):
        if t.ndim == 3:
            return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))
        return torch.gather(t, 1, idx)

    xa_m, sa_m, dst_m = take(xa, merged_idx), take(sa, merged_idx), take(dst, merged_idx)
    onehot = F.one_hot(dst_m, nb).float()  # (B, r, Nb)
    w_m = sa_m.float()
    num = (xb.float() * sb.float()[..., None]
           + torch.matmul(onehot.transpose(1, 2), xa_m.float() * w_m[..., None]))
    den = sb.float() + torch.matmul(onehot.transpose(1, 2), w_m[..., None])[..., 0]
    xb_new = (num / den[..., None]).to(x.dtype)

    out_x = torch.cat([cls_x, xb_new, take(xa, kept_idx)], dim=1)
    out_s = torch.cat([cls_s, den.to(sizes.dtype), take(sa, kept_idx)], dim=1)
    return out_x, out_s


def merge_schedule(n_tokens: int, n_layers: int, r: int,
                   protect_first: bool = True, min_tokens: int = 8) -> list[int]:
    """The ``r`` of each block boundary (ToMe's constant schedule): ``r``
    clamped to the merge candidates left and so that the token count never
    drops below ``min_tokens``; none after the last block."""
    out = []
    n = n_tokens
    start = 1 if protect_first else 0
    for _ in range(n_layers - 1):
        na = (n - start) // 2
        step = max(0, min(r, na, n - min_tokens))
        out.append(step)
        n -= step
    return out
