"""Pipeline parallelism: a GPipe schedule over the ``pipe`` group (the
port's counterpart of ``vimoclip_tpu/parallel/pipelining.py``).

TFAM's layers split into contiguous stages, one per rank of the ``pipe``
group (``keep_stage_layers_``: each rank holds only its stage's layers, the
memory the axis exists for); microbatches stream through the stages.

``pipeline_apply`` is the schedule, written by hand over point-to-point
sends rather than with ``torch.distributed.pipelining``: the payload is
JAX's tuple of tensors (x, motion, masks), every rank runs the head, and
the tests hold each stage against JAX's. Stage s runs microbatch m after
receiving it from stage s - 1 and sends its output on, so it runs m at tick
m + s, JAX's GPipe order; ranks in the bubble post nothing. The forward runs
without autograd and keeps only each (stage, microbatch) input; the
backward recomputes that stage's forward from it and differentiates it, in
reverse microbatch order, receiving the output gradient from stage s + 1
and sending the input gradient to stage s - 1 (JAX's per-tick
``jax.checkpoint``). The last stage's outputs are broadcast over the group,
so every rank runs the head and the loss, as JAX's psum does; in the
backward only the last stage's copy of their gradient is used.

Sends go as they are under NCCL; under gloo a CUDA payload is staged
through pinned host memory (``parallel/mesh.py::wire``; the stages still
compute on the card).

Dropout: each (stage, microbatch) draws from its own generator, seeded from
one draw of the step's generator, the stage and the microbatch (JAX keys
it per (stage, tick)); inside a stage every draw is made at the global
microbatch's shape and cut to the rank's rows, heads and time block
(``parallel/mesh.py::draw``), so the masks do not depend on the data,
model or seq layout, but do on the number of stages and microbatches, like
JAX's. They are not the one-process step's masks: the tests hold the
pipelined step to the one-process step with dropout off, and check
statistics with it on. The head's dropout draws from the step's generator
as in one process.

``tfam_cross_pipeline_logits`` is the TFAM forward (cross-attention mode)
with its layers pipelined; with a ``seq`` axis too, the stages run the ring
(``attention_impl="ring_inner"``) on their time blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch import nn

from vimoclip_tpu_torch.parallel.mesh import PIPE_AXIS, SEQ_AXIS, unwire, wire, wire_buffer


def split_microbatches(tree, n_micro: int):
    """(B, ...) tensors -> (n_micro, B/n_micro, ...) microbatch tensors; a
    tensor, or a tuple or list of them."""

    def split(x):
        if x.shape[0] % n_micro:
            raise ValueError(f"batch {x.shape[0]} not divisible by n_micro={n_micro}")
        return x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))

    return split(tree) if torch.is_tensor(tree) else type(tree)(split(x) for x in tree)


def merge_microbatches(tree):
    """Inverse of ``split_microbatches``."""
    merge = lambda x: x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))
    return merge(tree) if torch.is_tensor(tree) else type(tree)(merge(x) for x in tree)


def stage_layers(n_layers: int, n_stages: int, stage: int) -> range:
    """The layers stage ``stage`` of ``n_stages`` runs: consecutive ones
    (JAX's ``stack_stage_params``; the port keeps each stage's layers
    under their ``layers.N`` names instead of stacking them)."""
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} stages")
    per = n_layers // n_stages
    return range(stage * per, (stage + 1) * per)


def keep_stage_layers_(model: nn.Module, stage: int, n_stages: int) -> None:
    """Keep only ``model.layers`` of this stage, in a ``ModuleDict`` keyed
    by their layer index, so their ``state_dict`` keys stay the
    one-process model's (``layers.N.*``)."""
    keep = stage_layers(len(model.layers), n_stages, stage)
    model.layers = nn.ModuleDict({str(i): model.layers[i] for i in keep})


# ---------------------------------------------------------------------------
# point-to-point hops
# ---------------------------------------------------------------------------


def _send(tensors: Sequence[torch.Tensor], dst: int, group) -> list:
    """Non-blocking sends; keep the result until ``_wait``."""
    pending = []
    for t in tensors:
        buf = wire(t.detach(), group)
        pending.append((dist.isend(buf, dst, group=group), buf))
    return pending


def _wait(pending: list) -> None:
    for work, _ in pending:
        work.wait()


def _recv(templates: Sequence[torch.Tensor], src: int, group) -> list[torch.Tensor]:
    """Tensors shaped and typed as ``templates``, received from ``src``."""
    out = []
    for t in templates:
        buf = wire_buffer(t, group)
        dist.recv(buf, src, group=group)
        out.append(unwire(buf, t))
    return out


@dataclasses.dataclass
class _Pipe:
    group: object
    n: int
    stage: int

    @staticmethod
    def of(group) -> "_Pipe":
        return _Pipe(group, dist.get_world_size(group), dist.get_rank(group))

    def peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, pipe, n_params, *tensors):
        params, leaves = tensors[:n_params], tensors[n_params:]
        n_micro = leaves[0].shape[0]
        outs = [torch.zeros_like(t) for t in leaves]
        inputs, sends = [], []
        for m in range(n_micro):
            x = tuple(t[m] for t in leaves)
            if pipe.stage > 0:
                x = tuple(_recv(x, pipe.peer(pipe.stage - 1), pipe.group))
            inputs.append(x)
            y = _check_payload(stage_fn(x, m), x)
            if pipe.stage < pipe.n - 1:
                sends += _send(y, pipe.peer(pipe.stage + 1), pipe.group)
            else:
                for o, t in zip(outs, y):
                    o[m].copy_(t)
        _wait(sends)
        last = pipe.peer(pipe.n - 1)
        for o in outs:
            buf = wire(o, pipe.group)
            dist.broadcast(buf, last, group=pipe.group)
            if buf.data_ptr() != o.data_ptr():
                o.copy_(unwire(buf, o))
        ctx.stage_fn, ctx.pipe, ctx.n_params = stage_fn, pipe, n_params
        ctx.inputs, ctx.params = inputs, params
        ctx.templates = [t[0] for t in leaves]
        ctx.mark_non_differentiable(*[o for o in outs if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        pipe, params = ctx.pipe, ctx.params
        floats = [t.is_floating_point() for t in ctx.templates]
        n_micro = len(ctx.inputs)
        first_needs = ctx.needs_input_grad[3 + ctx.n_params:]
        param_grads = [None] * len(params)
        input_grads = [torch.zeros((n_micro,) + tuple(t.shape), dtype=t.dtype, device=t.device)
                       if need else None for t, need in zip(ctx.templates, first_needs)]
        sends = []
        for m in reversed(range(n_micro)):
            if pipe.stage == pipe.n - 1:
                g = [gr[m] for gr, f in zip(grads, floats) if f]
            else:
                g = _recv([t for t, f in zip(ctx.templates, floats) if f],
                          pipe.peer(pipe.stage + 1), pipe.group)
            wants = [f and (pipe.stage > 0 or need) for f, need in zip(floats, first_needs)]
            x = tuple(t.detach().requires_grad_(w) for t, w in zip(ctx.inputs[m], wants))
            with torch.enable_grad():
                y = ctx.stage_fn(x, m)
            pairs = [(yy, gg) for yy, gg in zip([t for t, f in zip(y, floats) if f], g)
                     if yy.requires_grad]
            wrt = list(params) + [t for t in x if t.requires_grad]
            got = torch.autograd.grad([yy for yy, _ in pairs], wrt, [gg for _, gg in pairs],
                                      allow_unused=True) if pairs else [None] * len(wrt)
            for i, gp in enumerate(got[:len(params)]):
                if gp is not None:
                    param_grads[i] = gp if param_grads[i] is None else param_grads[i] + gp
            x_grads = iter(got[len(params):])
            dx = [next(x_grads) if t.requires_grad else None for t in x]
            dx = [torch.zeros_like(t) if d is None else d for d, t in zip(dx, x)]
            if pipe.stage > 0:
                sends += _send([d for d, f in zip(dx, floats) if f],
                               pipe.peer(pipe.stage - 1), pipe.group)
            else:
                for buf, d in zip(input_grads, dx):
                    if buf is not None:
                        buf[m].copy_(d)
        _wait(sends)
        return (None, None, None, *param_grads, *input_grads)


def _check_payload(y, x) -> tuple:
    y = tuple(y)
    if len(y) != len(x) or any(a.shape != b.shape or a.dtype != b.dtype
                               for a, b in zip(y, x)):
        raise ValueError("a pipeline stage must return tensors of its input's shapes and "
                         f"dtypes; got {[(tuple(t.shape), t.dtype) for t in y]} for "
                         f"{[(tuple(t.shape), t.dtype) for t in x]}")
    return y


def pipeline_apply(stage_fn: Callable, microbatches: Sequence[torch.Tensor], group,
                   params: Sequence[torch.Tensor] = ()) -> tuple[torch.Tensor, ...]:
    """Run ``stage_fn`` as a GPipe pipeline over ``group`` (JAX's
    ``pipeline_apply``, one stage per rank).

    Args:
        stage_fn: ``(x, m) -> y``, this rank's stage on microbatch ``m``;
            ``x`` and ``y`` are tuples of tensors of the same shapes and
            dtypes (the payload that travels, e.g. ``(x, motion, masks)``
            with pass-through leaves). It must compute the same function
            when called again (the backward recomputes it).
        microbatches: the payload's tensors with a leading ``(M, ...)``
            microbatch dim (``split_microbatches``); every rank holds them,
            stage 0 reads them.
        group: the ``pipe`` process group, stage = rank in it.
        params: this stage's parameters; their gradients come back through
            autograd.
    Returns:
        The last stage's outputs, same layout, on every rank of the group.
    """
    if group is None:
        raise ValueError(f"the mesh has no {PIPE_AXIS!r} axis: no pipe group to run on")
    params = [p for p in params if p.requires_grad]
    return _GPipe.apply(stage_fn, _Pipe.of(group), len(params), *params, *microbatches)


def _stage_seed(base: int, stage: int, micro: int) -> int:
    return (base * 1_000_003 + stage * 65_537 + micro) % (2**63 - 1)


def tfam_cross_pipeline_logits(model, rgb_emb, motion_emb, mask_rgb=None, mask_flow=None, *,
                               n_micro: int | None = None, generator=None) -> torch.Tensor:
    """TFAM's forward (cross-attention fusion) with its layers pipelined
    over the ``pipe`` group of ``model.shard`` (JAX's
    ``tfam_cross_pipeline_logits``).

    ``model``: a TFAM cut by ``parallel.partition.parallelize_`` under a
    mesh with a ``pipe`` axis (this rank holds its stage's layers). The
    prologue (PE, mask inversion), the pooling and the head are the model's
    own, run on every rank; with a ``seq`` axis each rank runs its time
    block and the stages' attention is the ring. ``n_micro`` defaults to
    the number of stages. ``generator``: the step's dropout stream in
    ``train()`` mode (module docstring). Returns (B, classes) logits.
    """
    cfg = model.config
    if not cfg.use_cross_attention or cfg.use_only_rgb or cfg.use_only_flow:
        raise ValueError(
            "tfam_cross_pipeline_logits pipelines the cross-attention fusion mode; other "
            "modes run single-card (or ring) paths")
    shard = model.shard
    if shard is None or shard.pipe == 1:
        raise ValueError(f"the model's mesh has no {PIPE_AXIS!r} axis")
    n_micro = n_micro or shard.pipe
    model.check_generator(generator)
    if shard.seq > 1:
        t, tm = rgb_emb.shape[1], motion_emb.shape[1]
        if t % shard.seq or tm % shard.seq:
            raise ValueError(f"T={t}, Tm={tm} must divide the {SEQ_AXIS!r} axis size "
                             f"{shard.seq} — pad to a bucket first")
        if cfg.attention_impl != "ring_inner":
            raise ValueError("pipeline stages under a seq axis run attention_impl "
                             f"'ring_inner', not {cfg.attention_impl!r}")
    trunk = model.cut_time(model.prologue(rgb_emb, motion_emb, mask_rgb, mask_flow))
    b = trunk.x.shape[0]
    no_mask = lambda t: torch.zeros(b, t.shape[1], dtype=torch.bool, device=t.device)
    attn = no_mask(trunk.x) if trunk.attn is None else trunk.attn
    cross_attn = no_mask(trunk.cross) if trunk.cross_attn is None else trunk.cross_attn
    micro = split_microbatches((trunk.x, trunk.cross, attn, cross_attn), n_micro)
    dropping = model.training and cfg.dropout > 0.0
    base = None
    if dropping:
        base = int(torch.randint(0, 2**62, (1,), generator=generator,
                                 device=generator.device).item())
    layers = list(model.layers.values())
    device = trunk.x.device

    def stage_fn(xin, m):
        x, mot, a_rgb, a_flow = xin
        g = None
        if dropping:
            g = torch.Generator(device=device).manual_seed(_stage_seed(base, shard.pipe_rank, m))
        for layer in layers:
            x = layer(x, cross_src=mot, src_key_padding_mask=a_rgb,
                      cross_key_padding_mask=a_flow, generator=g)
        return x, mot, a_rgb, a_flow

    params = [p for layer in layers for p in layer.parameters()]
    out = pipeline_apply(stage_fn, micro, shard.pipe_group, params)
    x = merge_microbatches(out[0])
    return model.head(model.pool(x, trunk), generator)
