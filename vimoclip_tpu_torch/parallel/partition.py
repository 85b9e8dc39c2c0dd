"""Parameter partitioning rules and Megatron tensor parallelism (the
port's counterpart of ``vimoclip_tpu/parallel/partition.py``).

Rules map a regex over ``state_dict`` keys to a spec: one entry per dim of
the torch tensor, ``"model"`` where that dim splits over the mesh's
``model`` dim, first match wins, default replicated. torch keeps a Linear's
weight as (out, in), so JAX's column-parallel kernel ``P(None, "model")``
is ``("model", None)`` here and its row-parallel ``P("model", None)`` is
``(None, "model")``: the JAX spec transposed.

- Column-parallel layers (the first FFN linear, the q/k/v projections)
  keep a block of output features; their input enters through
  ``copy_to_model`` (identity forward, gradient summed over ``model``).
- Row-parallel layers (the second FFN linear, the attention output) keep
  the matching block of input features; ``reduce_from_model`` sums their
  partial products over ``model`` (identity backward), then the replicated
  bias is added once.
- The packed q/k/v ``in_proj_weight`` / ``in_proj_bias`` split per part:
  each rank keeps its heads of q, of k and of v.

``parallelize_`` cuts a model built whole on every rank (same seed, same
weights) down to this rank's slices, swaps the split Linears for the two
wrappers and hands the ``Shard`` to every module that draws dropout or
pools over the batch. Under a ``pipe`` axis it first keeps only this
rank's stage of ``model.layers`` (``parallel/pipelining.py``), under their
one-process ``layers.N`` names. ``Partition`` turns local slices back into
full tensors (checkpoints in the reference layout: gathered over ``model``,
and every stage's layers with their Adam moments gathered over ``pipe``,
in the one-process order) and full tensors into local slices (resume).
"""

from __future__ import annotations

import re
from typing import Iterable, Mapping

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from vimoclip_tpu_torch.parallel.mesh import MODEL_AXIS, Shard


class PartitionRules:
    def __init__(self, rules: list[tuple[str, tuple]]):
        self._rules = [(re.compile(pat), tuple(spec)) for pat, spec in rules]

    def spec_for(self, name: str, ndim: int) -> tuple:
        for pat, spec in self._rules:
            if pat.search(name):
                if len(spec) != ndim:
                    raise ValueError(f"rule {pat.pattern!r} gives {spec} to the "
                                     f"{ndim}-d tensor {name}")
                return spec
        return (None,) * ndim

    def unused_rules(self, names: Iterable[str]) -> list[str]:
        """Rule patterns that match no key of ``names`` (a ``state_dict`` or
        its keys): a rename would otherwise replicate a layer quietly."""
        names = list(names)
        return [pat.pattern for pat, _ in self._rules
                if not any(pat.search(n) for n in names)]


# TFAM (models/tfam.py, the AMO_CLIP layout):
#   layers.N.ffn.0.weight                          (2048, 512)  column
#   layers.N.ffn.3.weight                          (512, 2048)  row
#   layers.N.{self,cross}_attn.in_proj_weight      (3*512, 512) packed q/k/v, column
#   layers.N.{self,cross}_attn.out_proj.weight     (512, 512)   row
TFAM_PARTITION_RULES = PartitionRules(
    [
        (r"ffn\.0\.weight$", (MODEL_AXIS, None)),
        (r"ffn\.0\.bias$", (MODEL_AXIS,)),
        (r"ffn\.3\.weight$", (None, MODEL_AXIS)),
        (r"(self_attn|cross_attn)\.in_proj_weight$", (MODEL_AXIS, None)),
        (r"(self_attn|cross_attn)\.in_proj_bias$", (MODEL_AXIS,)),
        (r"(self_attn|cross_attn)\.out_proj\.weight$", (None, MODEL_AXIS)),
    ]
)

# Student (models/student.py): the CLIP tower under ``visual_encoder.``,
#   transformer.resblocks.N.mlp.c_fc.weight        (3072, 768) column
#   transformer.resblocks.N.mlp.c_proj.weight      (768, 3072) row
#   transformer.resblocks.N.attn.in_proj_weight    (3*768, 768) column
#   transformer.resblocks.N.attn.out_proj.weight   (768, 768)  row
# The residual MLP and the head stay replicated: the ``visual_encoder.``
# anchor keeps the rules off them.
STUDENT_PARTITION_RULES = PartitionRules(
    [
        (r"visual_encoder\..*mlp\.c_fc\.weight$", (MODEL_AXIS, None)),
        (r"visual_encoder\..*mlp\.c_fc\.bias$", (MODEL_AXIS,)),
        (r"visual_encoder\..*mlp\.c_proj\.weight$", (None, MODEL_AXIS)),
        (r"visual_encoder\..*attn\.in_proj_weight$", (MODEL_AXIS, None)),
        (r"visual_encoder\..*attn\.in_proj_bias$", (MODEL_AXIS,)),
        (r"visual_encoder\..*attn\.out_proj\.weight$", (None, MODEL_AXIS)),
    ]
)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over the ``model`` group."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the ``model`` group forward; identity backward."""
    return _ReduceFromModel.apply(x, group)


class _ShardedLinear(nn.Linear):
    """An ``nn.Linear`` whose parameters are this rank's block; the same
    ``weight``/``bias`` keys, so ``state_dict`` keeps its layout."""

    def __init__(self, linear: nn.Linear, group):
        nn.Module.__init__(self)
        self.out_features, self.in_features = linear.weight.shape
        self.weight, self.bias = linear.weight, linear.bias
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.product(x, self.weight, self.bias)


class ColumnParallelLinear(_ShardedLinear):
    """Rows of the weight and bias: a block of the output features."""

    def product(self, x, weight, bias):
        return F.linear(copy_to_model(x, self.group), weight, bias)


class RowParallelLinear(_ShardedLinear):
    """Columns of the weight: partial products summed over ``model``, then
    the replicated bias."""

    def product(self, x, weight, bias):
        out = reduce_from_model(F.linear(x, weight), self.group)
        return out if bias is None else out + bias


def _parts(name: str) -> int:
    return 3 if ".in_proj_" in name else 1  # packed q/k/v


_LAYER = re.compile(r"^layers\.(\d+)\.(.+)$")


class Partition:
    """How ``rules`` split ``model``'s parameters over ``shard``'s model
    group: this rank's slice of a full tensor, and the full tensor of the
    slices (all ranks of the group take part); under ``pipe``, which of
    the one-process model's layers this rank holds."""

    def __init__(self, model: nn.Module, rules: PartitionRules, shard: Shard):
        self.rules, self.shard = rules, shard
        self.names = [n for n, _ in model.named_parameters()]
        self.state_keys = list(model.state_dict().keys())
        self.full_names = self._one_process_order(self.names)
        self.dims: dict[str, int] = {}
        if shard.model > 1:
            for name, p in model.named_parameters():
                spec = rules.spec_for(name, p.ndim)
                if MODEL_AXIS in spec:
                    self.dims[name] = spec.index(MODEL_AXIS)
        self.sharded_ids = {id(p) for n, p in model.named_parameters() if n in self.dims}

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        if name not in self.dims:
            return full
        dim, n, i = self.dims[name], self.shard.model, self.shard.model_rank
        out = []
        for part in full.chunk(_parts(name), dim):
            if part.shape[dim] % n:
                raise ValueError(f"{name}: dim {dim} of {tuple(full.shape)} does not "
                                 f"split over model={n}")
            size = part.shape[dim] // n
            out.append(part.narrow(dim, i * size, size))
        return torch.cat(out, dim).contiguous()

    def full(self, name: str, local: torch.Tensor) -> torch.Tensor:
        if name not in self.dims:
            return local
        dim, out = self.dims[name], []
        for part in local.chunk(_parts(name), dim):
            bufs = [torch.empty_like(part) for _ in range(self.shard.model)]
            dist.all_gather(bufs, part.contiguous(), group=self.shard.model_group)
            out.append(torch.cat(bufs, dim))
        return torch.cat(out, dim)

    # --- pipe: the stages' layers -------------------------------------------

    def _stage_names(self, name: str) -> list[str]:
        """``name`` and its counterparts on every stage, by stage, when it
        is a layer's key under ``pipe``; else ``[name]``."""
        m = _LAYER.match(name)
        if self.shard.pipe == 1 or m is None:
            return [name]
        per = len({_LAYER.match(n).group(1) for n in self.names if _LAYER.match(n)})
        i = int(m.group(1)) - self.shard.pipe_rank * per
        return [f"layers.{s * per + i}.{m.group(2)}" for s in range(self.shard.pipe)]

    def _one_process_order(self, keys: list[str]) -> list[str]:
        """The one-process model's order of ``keys`` with every stage's
        layers: the layers first, by index (TFAM registers them before its
        other modules)."""
        if self.shard.pipe == 1:
            return list(keys)
        layers = sorted((n for k in keys for n in self._stage_names(k) if _LAYER.match(n)),
                        key=lambda n: int(_LAYER.match(n).group(1)))
        return layers + [k for k in keys if not _LAYER.match(k)]

    def _over_stages(self, name: str, value) -> list:
        """``value`` of every stage's counterpart of ``name``, by stage."""
        if (self.shard.pipe == 1 or not _LAYER.match(name) or not torch.is_tensor(value)
                or not value.ndim):  # Adam's step count: one for every stage
            return [value] * len(self._stage_names(name))
        bufs = [torch.empty_like(value) for _ in range(self.shard.pipe)]
        dist.all_gather(bufs, value.contiguous(), group=self.shard.pipe_group)
        return bufs

    def full_state(self, state: Mapping) -> dict:
        out = {}
        for k, v in state.items():
            for name, part in zip(self._stage_names(k), self._over_stages(k, self.full(k, v))):
                out[name] = part
        return {k: out[k] for k in self._one_process_order(list(state))}

    def local_state(self, state: Mapping) -> dict:
        keys = self.state_keys if self.shard.pipe > 1 else state.keys()
        return {k: self.local(k, state[k]) for k in keys}

    def _map_optimizer(self, state: dict, fn) -> dict:
        """``fn(name, tensor)`` over every parameter-shaped optimizer moment;
        the optimizer's indices follow ``model.parameters()``."""
        out = dict(state, state={})
        for idx, moments in state["state"].items():
            name = self.names[idx]
            out["state"][idx] = {k: fn(name, v) if torch.is_tensor(v) and v.ndim else v
                                 for k, v in moments.items()}
        return out

    def full_optimizer(self, state: dict) -> dict:
        out = self._map_optimizer(state, self.full)
        if self.shard.pipe == 1:
            return out
        index = {n: i for i, n in enumerate(self.full_names)}
        moments = {}
        for idx, mom in out["state"].items():
            name = self.names[idx]
            per_stage = {k: self._over_stages(name, v) for k, v in mom.items()}
            for s, full_name in enumerate(self._stage_names(name)):
                moments[index[full_name]] = {k: v[s] for k, v in per_stage.items()}
        groups = [dict(g, params=sorted(index[n] for i in g["params"]
                                        for n in self._stage_names(self.names[i])))
                  for g in out["param_groups"]]
        return dict(out, state=dict(sorted(moments.items())), param_groups=groups)

    def local_optimizer(self, state: dict) -> dict:
        if self.shard.pipe > 1:
            index = {n: i for i, n in enumerate(self.full_names)}
            local = {index[n]: i for i, n in enumerate(self.names)}
            state = dict(state, state={local[g]: m for g, m in state["state"].items()
                                       if g in local},
                         param_groups=[dict(g, params=[local[i] for i in g["params"]
                                                       if i in local])
                                       for g in state["param_groups"]])
        return self._map_optimizer(state, self.local)


def parallelize_(model: nn.Module, rules: PartitionRules, mesh) -> Partition:
    """Shard ``model`` in place for this rank of ``mesh`` (see the module
    docstring); build the optimizer afterwards or before, the parameters
    stay the same objects."""
    shard = Shard.of(mesh)
    if shard.pipe > 1:
        from vimoclip_tpu_torch.parallel.pipelining import keep_stage_layers_

        keep_stage_layers_(model, shard.pipe_rank, shard.pipe)
    part = Partition(model, rules, shard)
    for m in model.modules():
        if hasattr(m, "shard"):
            m.shard = shard
        heads = getattr(m, "num_heads", None)
        if heads is not None and heads % shard.model:
            raise ValueError(f"{heads} attention heads do not split over "
                             f"model={shard.model}")
    if shard.model == 1:
        return part
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = part.local(name, p.data)
    for name, m in list(model.named_modules()):
        if type(m) is nn.Linear and f"{name}.weight" in part.dims:
            cls = ColumnParallelLinear if part.dims[f"{name}.weight"] == 0 else RowParallelLinear
            parent, _, child = name.rpartition(".")
            setattr(model.get_submodule(parent), child, cls(m, shard.model_group))
    return part
