"""The ``(data, model)`` grid of ranks, a rank's rows of a batch, and the
replicated start.

Counterpart of ``multimodal_isic_tpu/parallel/sharding.py`` (:1-58).  A
JAX ``Mesh`` lays devices out on ``data`` × ``model`` axes and shardings say
which axis splits a value; here one process is one rank with one device,
and :class:`Grid` lays the ranks out the same way (``model`` fastest, as
``make_mesh`` reshapes its device list) with one process group a row and a
column: ``data_group`` (the ranks holding the other rows of this rank's
batch: gradient and BatchNorm all-reduces) and ``model_group`` (the ranks
splitting this rank's transformer blocks: the Megatron all-reduces of
``parallel.tp``).

The groups come from ``torch.distributed.new_group``, not
``torch.distributed.device_mesh``: a device mesh binds one device type and
maps rank r to card r, where two ranks here may share one card over gloo;
and the port uses no DTensor, only a row's and a column's group.

- :func:`shard_rows` gives a rank's rows of a global batch (JAX
  ``shard_batch`` / ``data_sharding``).
- :func:`replicate_` broadcasts rank 0's parameters and buffers (JAX
  ``replicated``: every device holds the same values).
- :func:`all_reduce_mean_` averages tensors over a group in one bucket
  (the data-parallel gradient all-reduce).
- :func:`shard_generator` / :func:`shard_transform` make a generator or
  a batch transform draw for the global batch and keep the rank's rows
  (``core.rng.ShardedGenerator``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional

import torch

from ..core.rng import ShardedGenerator
from . import distributed as D

@dataclass(frozen=True)
class Grid:
    """``n_data`` × ``n_model`` ranks, this one ``rank`` (row-major:
    ``rank = data_rank · n_model + model_rank``); a group of one rank is
    ``None`` and its collectives are skipped."""

    n_data: int
    n_model: int
    rank: int
    data_group: Any = None
    model_group: Any = None

    @property
    def world(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model


SINGLE = Grid(1, 1, 0)


def make_grid(n_data: int = -1, n_model: int = 1) -> Grid:
    """The ``(data, model)`` grid over every rank of the default group
    (JAX ``make_mesh``; ``n_data`` -1 takes the ranks left).  Every rank
    must call it, in the same order as every other group it makes."""
    world = D.process_count()
    if n_data == -1:
        if world % n_model:
            raise ValueError(f"{world} ranks not divisible by model="
                             f"{n_model}")
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"grid {n_data} × {n_model} != {world} ranks")
    rank = D.process_index()
    if world == 1:
        return SINGLE
    import torch.distributed as dist

    data_group = model_group = None
    for m in range(n_model):  # the columns: one data group a model rank
        ranks = [d * n_model + m for d in range(n_data)]
        g = (dist.group.WORLD if n_model == 1 else dist.new_group(ranks)) \
            if n_data > 1 else None
        if rank in ranks:
            data_group = g
    for d in range(n_data):  # the rows: one model group a data rank
        ranks = [d * n_model + m for m in range(n_model)]
        g = (dist.group.WORLD if n_data == 1 else dist.new_group(ranks)) \
            if n_model > 1 else None
        if rank in ranks:
            model_group = g
    return Grid(n_data, n_model, rank, data_group, model_group)


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def shard_rows(batch, grid: Optional[Grid]):
    """A rank's rows of a global batch: dim 0 of every tensor or array in
    ``batch`` (a dict of them, or one) cut into ``n_data`` equal parts, the
    ``data_rank``-th kept.  The whole batch for ``None`` or one data
    rank."""
    if grid is None or grid.n_data == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_rows(v, grid) for k, v in batch.items()}
    if batch is None:
        return None
    rows = D.process_local_rows(len(batch), grid.n_data, grid.data_rank)
    return batch[rows]


@torch.no_grad()
def replicate_(module: torch.nn.Module) -> torch.nn.Module:
    """Every rank's parameters and buffers set to rank 0's (one
    broadcast of a flat bucket a dtype and device over the default group);
    a no-op in one process."""
    if D.process_count() == 1:
        return module
    import torch.distributed as dist

    buckets: Dict[tuple, List[torch.Tensor]] = {}
    for t in [*module.parameters(), *module.buffers()]:
        buckets.setdefault((t.dtype, t.device), []).append(t.data)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=0)
        start = 0
        for t in ts:
            t.copy_(flat[start:start + t.numel()].view_as(t))
            start += t.numel()
    return module


@torch.no_grad()
def all_reduce_mean_(tensors: Iterable[torch.Tensor], group) -> None:
    """Each tensor replaced by its mean over ``group``, in one all-reduce
    of a flat bucket a dtype (a no-op for ``None``)."""
    if group is None:
        return
    import torch.distributed as dist

    world = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat /= world
        start = 0
        for t in ts:
            t.copy_(flat[start:start + t.numel()].view_as(t))
            start += t.numel()


def all_reduce_grads_(module: torch.nn.Module, group,
                      extras: Iterable[torch.Tensor] = ()) -> None:
    """The data-parallel gradient all-reduce: every parameter's gradient
    (and each of ``extras``, e.g. the step's loss) averaged over ``group``
    in one bucket.  A parameter without a gradient fills its slot with
    zeros, so every rank reduces the same bucket, and keeps ``None`` where
    no rank had one (as in one process, where the optimizer then skips
    it: no weight decay, no moment update)."""
    if group is None:
        return
    params = [p for p in module.parameters() if p.requires_grad]
    if not params:
        all_reduce_mean_(extras, group)
        return
    had = torch.tensor([p.grad is not None for p in params],
                       dtype=torch.float32, device=params[0].device)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    all_reduce_mean_([*grads, had, *extras], group)
    missing = [i for i, p in enumerate(params) if p.grad is None]
    if missing:
        had = had.tolist()
        for i in missing:
            if had[i] > 0:
                params[i].grad = grads[i]


def shard_generator(generator, grid: Optional[Grid]):
    """``generator`` drawing the global batch of ``grid``'s data ranks and
    keeping this rank's rows (a ``ShardedGenerator``); itself for one data
    rank or no generator."""
    if generator is None or grid is None or grid.n_data == 1:
        return generator
    return ShardedGenerator(generator, grid.n_data, grid.data_rank)


def shard_transform(transform, grid: Optional[Grid]):
    """``transform(images, masks, generator)`` of a rank's rows with the
    draws of the global batch (the generator wrapped in a
    ``ShardedGenerator``); ``transform`` itself for one data rank."""
    if transform is None or grid is None or grid.n_data == 1:
        return transform

    def sharded(images, masks, generator=None):
        if generator is None:
            return transform(images, masks)
        return transform(images, masks, shard_generator(generator, grid))

    return sharded
