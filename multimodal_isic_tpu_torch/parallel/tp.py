"""Megatron tensor parallelism of ConvMAE's transformer blocks over the
grid's ``model`` group.

Counterpart of ``multimodal_isic_tpu/parallel/tp.py`` (:1-61).  JAX places
the parameters with Megatron shardings and XLA's partitioner inserts the
collectives; here each rank of a model group holds its slice of every
transformer block (encoder ``blocks3.*``, decoder ``decoder_blocks.*``; the
JAX ``vit_*`` and ``dec_blocks_*``, ``_BLOCK_RULES`` :26-33) and the
all-reduces are explicit:

- ``attn.qkv`` and ``mlp.fc1`` are split by column: a rank computes
  ``num_heads / model`` whole heads (their q, k and v rows) and
  ``hidden / model`` hidden units.  JAX's ``P(None, model)`` cuts the fused
  qkv kernel's 3·dim columns in contiguous pieces and lets the partitioner
  move what the head reshape needs; a rank here takes its heads' rows of
  each of q, k and v, so the attention of its heads runs locally (on the
  card, the attention kernel B11 on the local heads).
- ``attn.proj`` and ``mlp.fc2`` are split by row (their input features):
  each rank's partial product is summed over the group, then the bias is
  added once.
- Every other parameter (conv stages, embeddings, norms, the row layers'
  biases) is replicated.

The collectives are the f / g pair of Megatron-LM as
``torch.autograd.Function``: f (before a column layer) is the identity
forward and an all-reduce of the input gradient backward; g (after a row
layer) is an all-reduce forward and the identity backward.  Every rank of
a model group then computes the same loss, and the replicated parameters'
gradients are equal on its ranks.

Constraint (the JAX docstring's): 3·dim, the MLP hidden width and the head
count must divide by ``model``; :func:`shard_convmae` raises otherwise.
:func:`gather_convmae` reassembles the replicated state dict (for a
checkpoint restored in one process).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.convmae import Block, ConvMAE, _round_scalar, dense
from ..ops.attention import flash_attention
from . import distributed as D
from .sharding import Grid

COLUMN, ROW = 0, 1  # the torch weight dim a layer is split on
_BLOCK_RULES = (("attn.qkv.weight", COLUMN), ("attn.qkv.bias", COLUMN),
                ("attn.proj.weight", ROW), ("mlp.fc1.weight", COLUMN),
                ("mlp.fc1.bias", COLUMN), ("mlp.fc2.weight", ROW))
_BLOCK_PREFIXES = ("blocks3.", "decoder_blocks.")


def megatron_dim(name: str) -> Optional[int]:
    """The dim of a ConvMAE state-dict entry split over ``model``
    (``COLUMN`` 0 or ``ROW`` 1 of a ``[out, in]`` weight, 0 of a bias),
    ``None`` for a replicated one (JAX ``megatron_spec``)."""
    if name.startswith(_BLOCK_PREFIXES):
        for suffix, dim in _BLOCK_RULES:
            if name.endswith(suffix):
                return dim
    return None


class _CopyToModel(torch.autograd.Function):
    """Megatron f: identity forward, Σ of the gradient over the group
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron g: Σ over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _qkv_rows(w: torch.Tensor, n_model: int, rank: int) -> torch.Tensor:
    """The rows of a [3·dim(, in)] qkv weight or bias holding rank's heads
    of q, k and v."""
    d = w.shape[0] // 3
    return w.reshape(3, n_model, d // n_model, *w.shape[1:])[:, rank].reshape(
        3 * d // n_model, *w.shape[1:])


def _split(name: str, t: torch.Tensor, n_model: int, rank: int
           ) -> torch.Tensor:
    """Rank's slice of the block entry ``name`` (the suffix after the
    block's index)."""
    dim = megatron_dim("blocks3.0." + name)
    if dim is None:
        return t
    if name.startswith("attn.qkv"):
        return _qkv_rows(t, n_model, rank)
    size = t.shape[dim] // n_model
    return t.narrow(dim, rank * size, size)


class TPBlock(Block):
    """A transformer block of which this rank holds ``num_heads / model``
    heads and ``hidden / model`` MLP units (module docstring).  The
    state-dict names are the block's; the split entries hold the rank's
    slices."""

    def __init__(self, block: Block, group, n_model: int, rank: int):
        dim = block.norm1.weight.shape[0]
        hidden = block.mlp.fc1.weight.shape[0]
        heads = block.attn.num_heads
        for what, n in (("3·dim", 3 * dim), ("the MLP hidden width", hidden),
                        ("the head count", heads)):
            if n % n_model:
                raise ValueError(f"tensor parallelism over {n_model}: {what} "
                                 f"{n} does not divide")
        with torch.device("meta"):
            super().__init__(dim // n_model, heads // n_model,
                             hidden / dim, block.dtype, block.use_flash)
        self.norm1, self.norm2 = block.norm1, block.norm2
        self.dim, self.group = dim, group
        for name, p in block.named_parameters():
            if name.startswith(("attn.", "mlp.")):
                mod, leaf = name.rsplit(".", 1)
                setattr(self.get_submodule(mod), leaf, nn.Parameter(
                    _split(name, p.detach(), n_model, rank).clone()))

    def _row(self, x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
        """A row-split layer: the partial product summed over the group,
        then the bias (rounded as ``dense`` rounds it)."""
        dt = self.dtype
        part = torch.matmul(x.to(dt), lin.weight.to(dt).t())
        return _ReduceFromModel.apply(part, self.group) + lin.bias.to(dt)

    def attention(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b, n, _ = x.shape
        heads = self.attn.num_heads
        hd = self.attn.qkv.weight.shape[0] // (3 * heads)
        x = _CopyToModel.apply(x, self.group)
        qkv = dense(x, self.attn.qkv, dt).reshape(b, n, 3, heads, hd)
        q, k, v = qkv.unbind(2)
        if self.use_flash:
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2))
            out = out.transpose(1, 2).reshape(b, n, heads * hd)
        else:
            q = q * _round_scalar(1.0 / math.sqrt(hd), dt)
            attn = torch.einsum("bqhd,bkhd->bhqk", q, k)
            attn = torch.softmax(attn.float(), dim=-1).to(dt)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(
                b, n, heads * hd)
        return self._row(out, self.attn.proj)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x + self.attention(self.norm1(x))
        h = dense(_CopyToModel.apply(self.norm2(x), self.group),
                  self.mlp.fc1, dt)
        h = F.gelu(h, approximate="none")
        return x + self._row(h, self.mlp.fc2)


def shard_convmae(model: ConvMAE, grid: Grid) -> ConvMAE:
    """Every transformer block of ``model`` replaced in place by its
    :class:`TPBlock` over ``grid.model_group`` (JAX ``place_tp``); a no-op
    for one model rank."""
    if grid.n_model == 1:
        return model
    for blocks in (model.blocks3, getattr(model, "decoder_blocks", ())):
        for i, blk in enumerate(blocks):
            blocks[i] = TPBlock(blk, grid.model_group, grid.n_model,
                                grid.model_rank)
    return model


@torch.no_grad()
def gather_convmae(model: ConvMAE, grid: Grid) -> Dict[str, torch.Tensor]:
    """The replicated state dict of a model sharded by
    :func:`shard_convmae` (every rank of the model group gets it)."""
    sd = model.state_dict()
    if grid.n_model == 1:
        return sd
    m = grid.n_model
    out = {}
    for name, t in sd.items():
        dim = megatron_dim(name)
        if dim is None:
            out[name] = t
            continue
        every = D.gather_rows(t.contiguous(), grid.model_group).reshape(
            m, *t.shape)  # [m, *local]
        if name.endswith("attn.qkv.weight") or name.endswith("attn.qkv.bias"):
            every = every.reshape(m, 3, t.shape[0] // 3, *t.shape[1:])
            out[name] = every.transpose(0, 1).reshape(3 * m * (t.shape[0] // 3),
                                                      *t.shape[1:])
        elif dim == 0:
            out[name] = every.reshape(m * t.shape[0], *t.shape[1:])
        else:
            out[name] = every.permute(1, 0, 2).reshape(t.shape[0],
                                                       m * t.shape[1])
    return out
