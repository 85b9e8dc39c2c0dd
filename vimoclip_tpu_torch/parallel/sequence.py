"""Sequence (context) parallelism: ring and all-gather attention with the
time axis cut over a ``seq`` ring (the port's counterpart of
``vimoclip_tpu/parallel/sequence.py``).

Each shard holds a contiguous block of the queries and of the keys, values
and key-padding mask. The ring (``ring_attention``) runs n steps: at step s
the shard with seq coordinate qi holds the key block that started on shard
(qi - s) mod n, so every query block meets every key block once and nothing
(T, T)-shaped ever exists. Each step is one call of the attention forward
with its log-sum-exp (K1' on CUDA tensors, ``forward_lse``; its plain
version on CPU tensors), and the blocks merge by their lse in float32:
o = sum_b exp(lse_b - lse) o_b / sum_b exp(lse_b - lse), lse = logsumexp_b
lse_b, the online softmax of JAX's ring step (``sequence.py:159-187``) lifted
from keys to blocks. A padding-only block has lse ~ -1e9 and weight 0. The
division by the summed weights (1 up to rounding) keeps a fully masked row
uniform over all keys, as the one-call kernel leaves it: its block lse all
round to -1e9.

A fully masked row in the backward: its lse rounds to -1e9, so the backward
kernels recompute P = 1 for each of its Tk keys where the softmax gives
1/Tk (the one-call ``flash_attention`` keeps that rule, as JAX's flash
kernels do). JAX's ring and all-gather are differentiated by autodiff and
are exact there. The kernels' backward is linear in dO for a fixed P (with
dropout too), so both strategies scale dO (and with it delta) by 1/Tk on
such rows before it, Tk the global key count, and get JAX's gradients; the
other rows are left as they are, bit for bit (``_exact_on_masked_rows``).

Dropout: the kernels' Philox bits are keyed on global (query row, key)
coordinates and one seed per (batch row, head) (``ops/kernels/
flash_attention.py``); each block call passes its global offsets (row0 =
qi * Tq/n, col0 = ki * Tk/n), so the ring drops exactly what one call on
the whole sequence drops with the same seeds, at any n and any placement.
(JAX's ring keys its bits on the block grid, so they change with n.) The
seeds are MHA's, one per (global batch row, head), drawn as every other
draw is (``parallel/mesh.py::draw``).

The backward (one ``torch.autograd.Function``; point-to-point sends carry
no gradient) saves only q, the shard's own key/value/mask block, the merged
output and the global lse, never the n blocks: the memory trade JAX makes
with ``jax.checkpoint``. It computes delta = rowsum(dO * O) once, then runs
the ring again: per block the backward kernels (K2 for blocks of at most
512 keys, else K3 + K4; plain versions on the CPU) with the global lse and
delta give the block's dq, dk and dv; dq adds up locally in float32, the
dk/dv partial sums (float32) travel with their block, and one more hop
brings them home to the block's owner.

The exchange is a small object with two forms, which the caller picks:

- ``P2PRing(group)``: one shard per rank, hops by ``batch_isend_irecv``
  over the seq group, the next block in flight while the current one
  computes. Under gloo a hop of CUDA tensors goes through pinned host
  memory (``parallel/mesh.py::wire``; the kernels still run on the card);
  NCCL hops stay on the card.
- ``LocalRing(n)``: the n shards of one process held as a list, a hop a
  rotation of the list: the numerics tests and ``chip_smoke.py`` run n
  virtual shards without spawning ranks.

``allgather_attention`` gathers the keys and values over the ring and runs
the port's flash attention on (local queries, all keys) with row0; its
backward sums dk/dv over the ring and keeps the shard's block. It is the
dense oracle for ``ring``, as in JAX. ``sequence_parallel_attention`` is the
entry with JAX's argument checks, on the whole (B, H, T, D) tensors over a
``LocalRing``.

The TFAM path (``models/tfam.py``, ``ops/attention.py`` ``"ring"``) cuts time
after each fusion mode's prologue and pools with ``seq_sum``, an all-reduce
whose backward is an all-reduce.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vimoclip_tpu_torch.ops.kernels import flash_attention as fa
from vimoclip_tpu_torch.parallel.mesh import SEQ_AXIS, unwire, wire, wire_buffer


class LocalRing:
    """n shards held by this process, as a list in seq order."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a ring needs at least one shard, got {n}")
        self.n = n
        self.ranks = tuple(range(n))

    def shift(self, payloads: list):
        """Each shard's payload to the next shard: returns a callable giving
        what each shard received (its predecessor's payload)."""
        out = [payloads[(i - 1) % self.n] for i in range(self.n)]
        return lambda: out

    def gather(self, shards: list, dim: int) -> torch.Tensor:
        return torch.cat(list(shards), dim=dim)


class P2PRing:
    """One shard per rank of ``group``, in group-rank order."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        me = dist.get_rank(group)
        self.ranks = (me,)
        self.next = dist.get_global_rank(group, (me + 1) % self.n)
        self.prev = dist.get_global_rank(group, (me - 1) % self.n)

    def shift(self, payloads: list):
        (tensors,) = payloads
        if self.n == 1:
            return lambda: [list(tensors)]
        sends = [wire(t, self.group) for t in tensors]
        recvs = [wire_buffer(t, self.group) for t in tensors]
        reqs = dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, t, self.next, self.group) for t in sends]
            + [dist.P2POp(dist.irecv, t, self.prev, self.group) for t in recvs])

        def wait():
            for r in reqs:
                r.wait()
            return [[unwire(b, t) for b, t in zip(recvs, tensors)]]

        return wait

    def gather(self, shards: list, dim: int) -> torch.Tensor:
        (t,) = shards
        return _Gather.apply(t, dim, self.group)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over the group; the backward sums the
    gradient over the group and keeps this rank's block (a reduce-scatter,
    as an all-reduce: gloo's reduce-scatter is not in every version)."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, t.shape[dim]
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        me = dist.get_rank(ctx.group)
        return grad.narrow(ctx.dim, me * ctx.size, ctx.size), None, None


class _SeqSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def seq_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the ``seq`` group forward, and the gradient summed over it
    backward: every seq rank runs the head on the same pooled features, and
    with each rank's loss divided by the group size the summed gradient is
    the one-process gradient (``train/tfam_trainer.py``)."""
    return _SeqSum.apply(x, group)


def _exact_on_masked_rows(grad: torch.Tensor, masked: torch.Tensor, keys: int) -> torch.Tensor:
    """``grad`` (the attention output's gradient) times 1/``keys`` where
    ``masked`` (broadcast over it) is True, and unchanged elsewhere: the
    backward kernels then give the softmax's exact gradients on a fully
    masked row (module docstring)."""
    return torch.where(masked, grad * (1.0 / keys), grad)


def _merge(acc, o_b: torch.Tensor, lse_b: torch.Tensor):
    """(float32 output, lse, summed weight) after one more block."""
    o_b = o_b.float()
    if acc is None:
        return o_b, lse_b, torch.ones_like(lse_b)
    o, lse, w = acc
    new = torch.logaddexp(lse, lse_b)
    a, b = torch.exp(lse - new), torch.exp(lse_b - new)
    return o * a[..., None] + o_b * b[..., None], new, w * a + b


def _offsets(qi: int, ki: int, tq: int, tk: int, rate: float) -> tuple[int, int]:
    return (qi * tq, ki * tk) if rate > 0.0 else (0, 0)


def ring_forward(ring, seed, rate: float, qs, ks, vs, masks) -> tuple[list, list]:
    """The ring's forward on lists of local shards (``masks`` as uint8):
    each shard's output in q's dtype and its global lse (B, H, Tq/n)
    float32."""
    n, tq, tk = ring.n, qs[0].shape[2], ks[0].shape[2]
    blocks = [list(b) for b in zip(ks, vs, masks)]
    acc = [None] * len(qs)
    for s in range(n):
        pending = ring.shift(blocks) if s < n - 1 else None
        for i, qi in enumerate(ring.ranks):
            ki = (qi - s) % n
            kb, vb, mb = blocks[i]
            o_b, lse_b = fa.forward_lse(qs[i], kb, vb, mb.view(torch.bool), seed, rate,
                                        *_offsets(qi, ki, tq, tk, rate))
            acc[i] = _merge(acc[i], o_b, lse_b)
        if pending is not None:
            blocks = pending()
    outs = [(o / w[..., None]).to(q.dtype) for (o, _, w), q in zip(acc, qs)]
    return outs, [lse for _, lse, _ in acc]


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, seed, rate, m, *tensors):
        qs, ks, vs, masks = (tensors[i * m:(i + 1) * m] for i in range(4))
        outs, lses = ring_forward(ring, seed, rate, qs, ks, vs, masks)
        ctx.ring, ctx.rate, ctx.m = ring, rate, m
        ctx.save_for_backward(seed, *qs, *ks, *vs, *masks, *outs, *lses)
        return tuple(outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grad_outs):
        ring, rate, m = ctx.ring, ctx.rate, ctx.m
        seed, *saved = ctx.saved_tensors
        qs, ks, vs, masks, outs, lses = (saved[i * m:(i + 1) * m] for i in range(6))
        n, tq, tk = ring.n, qs[0].shape[2], ks[0].shape[2]
        # a row whose keys are all masked has a global lse of -1e9 (the mask
        # value); any other, at least its largest real score
        douts = [_exact_on_masked_rows(g.contiguous(), (lse < fa._MASK_VALUE / 2)[..., None],
                                       n * tk) for g, lse in zip(grad_outs, lses)]
        deltas = [(g.float() * o.float()).sum(dim=-1) for g, o in zip(douts, outs)]
        dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
        blocks = [list(b) for b in zip(ks, vs, masks)]
        sums = [[torch.zeros(k.shape, dtype=torch.float32, device=k.device),
                 torch.zeros(v.shape, dtype=torch.float32, device=v.device)]
                for k, v in zip(ks, vs)]
        for s in range(n):
            pending = ring.shift(blocks) if s < n - 1 else None
            for i, qi in enumerate(ring.ranks):
                ki = (qi - s) % n
                kb, vb, mb = blocks[i]
                dq, dk, dv = fa.backward(qs[i], kb, vb, mb.view(torch.bool), seed, rate, None,
                                         lses[i], douts[i], *_offsets(qi, ki, tq, tk, rate),
                                         delta=deltas[i])
                dqs[i] += dq.float()
                sums[i][0] += dk.float()
                sums[i][1] += dv.float()
            # the block's sums move on with it; after the last step this hop
            # brings each block's sums home to its owner
            sums = ring.shift(sums)()
            if pending is not None:
                blocks = pending()
        return (None, None, None, None,
                *(dq.to(q.dtype) for dq, q in zip(dqs, qs)),
                *(dk.to(k.dtype) for (dk, _), k in zip(sums, ks)),
                *(dv.to(v.dtype) for (_, dv), v in zip(sums, vs)),
                *([None] * m))


def _as_lists(ring, q, k, v, key_padding_mask):
    single = not isinstance(q, (list, tuple))
    qs, ks, vs = ([x] if single else list(x) for x in (q, k, v))
    if len(qs) != len(ring.ranks):
        raise ValueError(f"{len(qs)} query shards for a ring that holds {len(ring.ranks)} here")
    if key_padding_mask is None:
        masks = [torch.zeros(t.shape[0], t.shape[2], dtype=torch.bool, device=t.device)
                 for t in ks]
    else:
        masks = [key_padding_mask] if single else list(key_padding_mask)
    return single, qs, ks, vs, masks


def _seeds(dropout_rate, dropout_seed, q):
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        return fa.expand_seed(dropout_seed, q.shape[0], q.shape[1], device=q.device)
    return None


def ring_attention(q, k, v, key_padding_mask, ring, dropout_rate: float = 0.0,
                   dropout_seed=None):
    """Per-shard ring attention (JAX's ``ring_attention`` body).

    Args:
        q: (B, H, Tq/n, D) this shard's queries; k, v: (B, H, Tk/n, D) its
            keys and values; key_padding_mask: (B, Tk/n) bool, True = ignore
            the key (travels with its block), or None. With a ``LocalRing``,
            lists of the n shards' tensors instead.
        ring: ``P2PRing`` or ``LocalRing``.
        dropout_rate / dropout_seed: attention-weight dropout from the
            kernels' bits at global coordinates (module docstring); the seed
            as ``flash_attention`` takes it ((B, H) per-row-and-head seeds).
            The key block length must be a multiple of 4 then.
    Returns:
        (B, H, Tq/n, D) in q's dtype (a list with a ``LocalRing``).
    """
    single, qs, ks, vs, masks = _as_lists(ring, q, k, v, key_padding_mask)
    seed = _seeds(dropout_rate, dropout_seed, qs[0])
    tk = ks[0].shape[2]
    if dropout_rate > 0.0 and tk % 4:
        raise ValueError(
            f"ring attention with dropout needs key blocks of a multiple of 4 keys (each "
            f"block's first key sits at a Philox counter boundary); got {tk}: pad to a "
            "bucket first")
    masks = [mk.to(torch.bool).contiguous().view(torch.uint8) for mk in masks]
    outs = _RingAttention.apply(ring, seed, float(dropout_rate), len(qs),
                                *qs, *ks, *vs, *masks)
    return outs[0] if single else list(outs)


def allgather_attention(q, k, v, key_padding_mask, ring, dropout_rate: float = 0.0,
                        dropout_seed=None):
    """Per-shard all-gather attention (JAX's ``allgather_attention``): the
    keys, values and mask gathered over the ring, then the port's flash
    attention on (local queries, all keys) with the shard's row offset, so
    its dropout bits are the one call's (and the ring's); on a fully masked
    row the gradient is the softmax's, as JAX's (module docstring). Same
    arguments and return as ``ring_attention``."""
    single, qs, ks, vs, masks = _as_lists(ring, q, k, v, key_padding_mask)
    seed = _seeds(dropout_rate, dropout_seed, qs[0])
    k_all, v_all = ring.gather(ks, 2), ring.gather(vs, 2)
    with torch.no_grad():
        mask_all = ring.gather([mk.to(torch.uint8) for mk in masks], 1).to(torch.bool)
    tq = qs[0].shape[2]
    masked, keys = mask_all.all(dim=1)[:, None, None, None], k_all.shape[2]
    outs = [fa.flash_attention(q_, k_all, v_all, mask_all, dropout_rate, seed,
                               row0=qi * tq if dropout_rate > 0.0 else 0)
            for q_, qi in zip(qs, ring.ranks)]
    for o in outs:
        if o.requires_grad:
            o.register_hook(lambda g: _exact_on_masked_rows(g, masked, keys))
    return outs[0] if single else outs


_STRATEGIES = {"ring": ring_attention, "allgather": allgather_attention}


def sequence_parallel_attention(q, k, v, ring, key_padding_mask=None, *,
                                strategy: str = "ring", dropout_rate: float = 0.0,
                                dropout_seed=None):
    """Attention with the time axis cut over ``ring`` (JAX's
    ``sequence_parallel_attention``, with its checks and messages).

    JAX's global view: q, k, v are the whole (B, H, Tq, D) / (B, H, Tk, D)
    tensors and the mask (B, Tk), cut here into the ``n`` shards of
    ``ring``, a ``LocalRing`` (None: no seq axis), and the output joined
    again. ``strategy``: "ring" or "allgather". A rank of a process group
    calls ``ring_attention`` on its shards itself (``ops/attention.py``).
    """
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1); got {dropout_rate}")
    if dropout_rate and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}, want {sorted(_STRATEGIES)}")
    if ring is None:
        raise ValueError(f"the mesh has no {SEQ_AXIS!r} axis: no ring to run on")
    body = _STRATEGIES[strategy]
    n = ring.n
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(
            f"Tq={q.shape[2]}, Tk={k.shape[2]} must be divisible by the {SEQ_AXIS!r} "
            f"axis size {n} — pad to a bucket first (data.pipeline length buckets "
            "already produce such shapes)")
    cut = lambda t, dim: list(t.chunk(n, dim=dim))
    masks = None if key_padding_mask is None else cut(key_padding_mask, 1)
    if dropout_rate:
        dropout_seed = fa.expand_seed(dropout_seed, q.shape[0], q.shape[1], device=q.device)
    outs = body(cut(q, 2), cut(k, 2), cut(v, 2), masks, ring, dropout_rate, dropout_seed)
    return torch.cat(outs, dim=2)
