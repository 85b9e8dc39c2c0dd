"""Process groups for data, tensor, sequence and pipeline parallelism, and
inference replicas (the port's counterpart of
``vimoclip_tpu/parallel/mesh.py``).

The JAX package drives every chip of a slice from one process through a
``jax.sharding.Mesh``. The port trains with one process per GPU, launched
by ``torchrun``::

    torchrun --nproc-per-node N -m vimoclip_tpu_torch.cli.tfam_train_eval --config cfg.yaml

over ``torch.distributed``: NCCL between cards, gloo on the CPU (the tests).
The ranks form a ``DeviceMesh`` with JAX's named dims in JAX's order,
``("data"[, "pipe"], "model"[, "seq"])``, the last varying fastest
(``pipe`` and ``seq`` only when above 1):

- ``data``: each rank takes a contiguous block of rows of the global batch
  (``shard_batch``); gradients are averaged over this dim;
- ``pipe``: GPipe stages, each rank a contiguous block of TFAM's layers
  (``parallel/pipelining.py``);
- ``model``: Megatron tensor parallelism (``parallel/partition.py``);
- ``seq``: TFAM's time axis, cut after each fusion mode's prologue, with
  ring attention over the ``seq`` group (``parallel/sequence.py``);
  gradients are summed over this dim.

A ``Shard`` is what the modules see of it: this rank's coordinates and the
groups. Random draws (dropout) happen at the global shape on every rank and
each rank keeps its block (``draw``: rows over ``data``, time over ``seq``,
heads or features over ``model``), so a sharded step draws the masks of the
one-process step.

Extraction and serving stay one process, as in JAX: ``Replicas`` holds one
copy of a tower per device and splits each fixed-shape batch into
contiguous row blocks, one per copy.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh geometry. ``data_parallel=-1`` means "all remaining ranks"."""

    data_parallel: int = -1
    model_parallel: int = 1
    seq_parallel: int = 1
    pipeline_parallel: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        sp = max(1, self.seq_parallel)
        pp = max(1, self.pipeline_parallel)
        if n_devices % (sp * pp):
            raise ValueError(
                f"{n_devices} devices not divisible by seq={sp} x pipe={pp}"
            )
        avail = n_devices // (sp * pp)
        mp = max(1, self.model_parallel)
        dp = self.data_parallel
        if dp == -1:
            if avail % mp:
                raise ValueError(f"{avail} devices not divisible by model={mp}")
            dp = avail // mp
        if dp * mp * sp * pp > n_devices:
            raise ValueError(
                f"mesh {dp}x{pp}x{mp}x{sp} exceeds available device count "
                f"{n_devices}"
            )
        return dp, mp


def initialize_distributed(device: str | torch.device = "cuda") -> bool:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``): NCCL
    for a card, with this process on ``cuda:LOCAL_RANK``, gloo for the CPU.
    A no-op without those variables or when the group exists already.
    Returns whether a process group is up."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if on_card else "gloo",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def local_device(device: str | torch.device) -> torch.device:
    """``device`` with the card ``torchrun`` gave this rank when it names no
    index (``cuda`` -> ``cuda:LOCAL_RANK``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


def create_mesh(config: MeshConfig | None = None, device_type: str = "cuda",
                entry: str = "<module>"):
    """A ``DeviceMesh`` with dims ``("data"[, "pipe"], "model"[, "seq"])``
    over every rank of the process group (JAX's ``create_mesh``: ``pipe``
    and ``seq`` only when above 1, ``seq`` innermost, so its ring's
    neighbours are adjacent ranks). Unlike JAX, which may leave devices
    idle, the mesh must use every rank: ``entry`` names the module in the
    ``torchrun`` command the error suggests."""
    from torch.distributed.device_mesh import init_device_mesh

    config = config or MeshConfig()
    sp, pp = max(1, config.seq_parallel), max(1, config.pipeline_parallel)
    world = dist.get_world_size() if dist.is_initialized() else 1
    want = ((config.data_parallel if config.data_parallel != -1 else 1)
            * max(1, config.model_parallel) * sp * pp)
    if not dist.is_initialized() or want > world:
        raise ValueError(
            f"data_parallel x model_parallel x seq x pipe asks for {want} ranks, but "
            f"the process group has {world}: launch one process per rank, e.g. "
            f"torchrun --nproc-per-node {want} -m {entry} ...")
    dp, mp = config.resolve(world)
    if dp * mp * sp * pp != world:
        raise ValueError(
            f"mesh data={dp} x pipe={pp} x model={mp} x seq={sp} uses "
            f"{dp * mp * sp * pp} of the {world} ranks: launch torchrun "
            f"--nproc-per-node {dp * mp * sp * pp} -m {entry} ..., or set "
            "data_parallel to -1")
    axes = [(DATA_AXIS, dp)] + [(PIPE_AXIS, pp)] * (pp > 1) + [(MODEL_AXIS, mp)]
    axes += [(SEQ_AXIS, sp)] * (sp > 1)
    return init_device_mesh(device_type, tuple(n for _, n in axes),
                            mesh_dim_names=tuple(name for name, _ in axes))


def training_mesh(config: MeshConfig, device: torch.device, entry: str):
    """The trainers' mesh: None for a lone process that asks for one device
    (the single-card path, untouched), a ``DeviceMesh`` over the process
    group otherwise. A lone process asking for more ranks is an error that
    names the ``torchrun`` command."""
    if (not dist.is_initialized() and config.data_parallel in (-1, 1)
            and config.model_parallel <= 1 and config.seq_parallel <= 1
            and config.pipeline_parallel <= 1):
        return None
    return create_mesh(config, device.type, entry)


def _dim(mesh, name: str) -> tuple:
    """(size, this rank's coordinate, group) of a mesh dim; (1, 0, None)
    for a dim the mesh leaves out."""
    if name not in mesh.mesh_dim_names:
        return 1, 0, None
    return (mesh.size(mesh.mesh_dim_names.index(name)), mesh.get_local_rank(name),
            mesh.get_group(name))


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's place in a (data[, pipe], model[, seq]) mesh, as the
    modules see it."""

    data: int = 1
    data_rank: int = 0
    model: int = 1
    model_rank: int = 0
    data_group: object = None
    model_group: object = None
    seq: int = 1
    seq_rank: int = 0
    seq_group: object = None
    pipe: int = 1
    pipe_rank: int = 0
    pipe_group: object = None

    @staticmethod
    def of(mesh) -> "Shard":
        (d, dr, dg), (m, mr, mg) = _dim(mesh, DATA_AXIS), _dim(mesh, MODEL_AXIS)
        return Shard(d, dr, m, mr, dg, mg, *_dim(mesh, SEQ_AXIS), *_dim(mesh, PIPE_AXIS))

    @property
    def seq_ring(self):
        """The ring over the ``seq`` group (``parallel/sequence.py``), or
        None without one."""
        from vimoclip_tpu_torch.parallel.sequence import P2PRing

        return P2PRing(self.seq_group) if self.seq > 1 else None

    def max_over_data(self, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.data_group)
        return t

    def mean_over_data(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach().clone()
        dist.all_reduce(t, group=self.data_group)
        return t / self.data

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch of a row block: every data rank's, in order."""
        parts = [torch.empty_like(t) for _ in range(self.data)]
        dist.all_gather(parts, t.detach().contiguous(), group=self.data_group)
        return torch.cat(parts)

    def average_gradients_(self, params) -> None:
        """Gradients averaged over ``data`` in place, one collective; under
        ``seq`` also summed over it (each seq rank's backward holds its time
        shard's part of every gradient, the head's included: the trainer
        divides each rank's loss by ``seq`` for the backward)."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.data_group)
        if self.seq > 1:
            dist.all_reduce(flat, group=self.seq_group)
        flat /= self.data
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as a point-to-point op or broadcast of ``group`` takes it: bool
    as uint8, and under gloo a CUDA tensor copied to pinned host memory
    (gloo sends and receives CPU tensors only; on the H100 machine a CUDA
    send fails with "writev ... Bad address"). NCCL takes ``t`` itself."""
    t = t.contiguous()
    t = t.view(torch.uint8) if t.dtype == torch.bool else t
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t


def wire_buffer(like: torch.Tensor, group) -> torch.Tensor:
    """An empty receive buffer for a tensor shaped and typed as ``like``."""
    return wire(torch.empty(like.shape, dtype=like.dtype, device=like.device), group)


def unwire(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """What ``buf`` (from ``wire``/``wire_buffer``) holds, on ``like``'s
    device and in its dtype."""
    buf = buf.to(like.device, non_blocking=True)
    return buf.view(torch.bool) if like.dtype == torch.bool else buf


def any_rank(flag: bool, device: torch.device) -> bool:
    """Whether ``flag`` is raised on any rank of the process group: every
    rank gets the same answer (a preemption signal seen by one rank stops
    them all at the same step, since one rank leaving would hang the
    others' collectives)."""
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def draw(sample: Callable[[tuple], torch.Tensor], shape: Sequence[int],
         shard: Shard | None = None, split_last: bool = False,
         split_time: bool = False) -> torch.Tensor:
    """``sample(shape)``, a random draw for a block of ``shape``. Under a
    ``shard`` the block is this rank's part of a global tensor (rows over
    ``data``; with ``split_time`` dim 1 over ``seq``: a time-sharded
    activation; with ``split_last`` its last dim over ``model``: heads, or
    a column-parallel layer's features): the global draw is made, from a
    generator every rank holds in the same state, and the block cut out of
    it, so the ranks draw what the one-process run draws."""
    if shard is None:
        return sample(tuple(shape))
    rows = shape[0]
    full = [rows * shard.data, *shape[1:]]
    index: list = [slice(shard.data_rank * rows, (shard.data_rank + 1) * rows)]
    if split_time and shard.seq > 1:
        t = shape[1]
        full[1] = t * shard.seq
        index.append(slice(shard.seq_rank * t, (shard.seq_rank + 1) * t))
    if split_last:
        n = shape[-1]
        full[-1] = n * shard.model
        index += [Ellipsis, slice(shard.model_rank * n, (shard.model_rank + 1) * n)]
    return sample(tuple(full))[tuple(index)]


def local_batch_slice(global_batch: int, mesh=None) -> slice:
    """The rows of a global batch this rank feeds: by its ``data``
    coordinate on ``mesh``, by rank without one (JAX: by process)."""
    if mesh is not None:
        n, i = mesh.size(0), mesh.get_local_rank(DATA_AXIS)
    elif dist.is_initialized():
        n, i = dist.get_world_size(), dist.get_rank()
    else:
        n, i = 1, 0
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} % data ranks {n} != 0")
    per_rank = global_batch // n
    return slice(i * per_rank, (i + 1) * per_rank)


def shard_batch(batch: dict, mesh, microbatches: int = 1) -> dict:
    """This rank's rows of a collated global batch (arrays, tensors and
    lists alike); the batch itself without a mesh. Collate the global batch
    first: its padded length is the global one. With ``microbatches`` (the
    trainers' gradient accumulation) each of that many equal slices of the
    batch is split over ``data``, so microbatch i of the local rows is this
    rank's block of the one-process microbatch i."""
    if mesh is None:
        return batch
    n = next(len(v) for v in batch.values()
             if isinstance(v, (np.ndarray, torch.Tensor, list)))
    if n % microbatches:
        raise ValueError(f"batch {n} does not split into {microbatches} microbatches")
    size = n // microbatches
    blocks = [range(i * size, (i + 1) * size)[local_batch_slice(size, mesh)]
              for i in range(microbatches)]
    if microbatches == 1:
        rows = slice(blocks[0].start, blocks[0].stop)
        take = lambda v: v[rows]
    else:
        idx = [r for block in blocks for r in block]
        take = lambda v: ([v[r] for r in idx] if isinstance(v, list)
                          else v[torch.as_tensor(idx, device=v.device)]
                          if isinstance(v, torch.Tensor) else v[idx])
    return {k: take(v) if isinstance(v, (np.ndarray, torch.Tensor, list)) else v
            for k, v in batch.items()}


def replica_devices(n: int, device: str | torch.device) -> list[torch.device]:
    """``n`` devices, one replica each: ``cuda:0 .. cuda:n-1`` for a card
    (refused past the cards present), the CPU ``n`` times."""
    dev = torch.device(device)
    if n < 1:
        raise ValueError(f"data parallelism must be >= 1, got {n}")
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        if n > have:
            raise ValueError(f"--data-parallel {n} needs {n} cards; this machine "
                             f"has {have}")
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


class Replicas:
    """One copy of an inference module per device; each batch splits into
    contiguous row blocks, one per copy, and the results concatenate in
    order (JAX: parameters replicated over the mesh, the batch sharded over
    ``data``). ``module`` is already on ``devices[0]``; a device the
    machine lacks is an error, never a fall back."""

    def __init__(self, module: torch.nn.Module, devices: Sequence[str | torch.device]):
        self.devices = [torch.device(d) for d in devices]
        for d in self.devices:
            if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
                raise ValueError(f"replica device {d} is not on this machine "
                                 f"({torch.cuda.device_count()} cards)")
        self.modules = [module] + [copy.deepcopy(module).to(d) for d in self.devices[1:]]

    def __len__(self) -> int:
        return len(self.modules)

    def check_divides(self, batch: int, what: str) -> None:
        if batch % len(self):
            raise ValueError(f"{what} {batch} not divisible by data axis {len(self)}")

    def blocks(self, n: int):
        """(module, device, rows) for each replica's contiguous block of
        ``n`` rows."""
        per = n // len(self)
        return [(m, d, slice(i * per, (i + 1) * per))
                for i, (m, d) in enumerate(zip(self.modules, self.devices))]

    @staticmethod
    def on(device: torch.device):
        """The context that makes ``device`` current: the hand-written
        kernels launch on the current card's stream."""
        return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()

    def __call__(self, fn: Callable, x: torch.Tensor) -> torch.Tensor:
        """``fn(module, block)`` on every replica's block of ``x``, gathered
        on ``x``'s device; ``fn(module, x)`` itself with one replica."""
        if len(self) == 1:
            return fn(self.modules[0], x)
        outs = []
        for m, d, rows in self.blocks(x.shape[0]):
            with self.on(d):
                outs.append(fn(m, x[rows].to(d, non_blocking=True)))
        return torch.cat([o.to(x.device, non_blocking=True) for o in outs])
