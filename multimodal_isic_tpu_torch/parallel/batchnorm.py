"""BatchNorm over the global batch of a data-parallel group.

The JAX data-parallel step normalises with the statistics of the whole
global batch: its BatchNorm reduces over the batch axis of a global array,
and XLA inserts the all-reduce over the mesh's ``data`` axis
(``tests/test_parallel.py:60-87``).  Here each rank holds its rows, so
:class:`GlobalBatchNorm` gathers the per-channel statistics itself:

- each rank computes its count n_i, mean m_i and centred sum of squares
  M2_i in float32 (float64 for float64 input), as the port's BatchNorm
  computes statistics;
- one autograd-aware all-reduce of zero-filled slots [world, 2C] gives
  every rank every (m_i, M2_i) (gloo takes CUDA tensors in ``all_reduce``,
  not in ``all_gather``; ``torch.nn.SyncBatchNorm`` all-gathers, and
  refuses CPU input);
- every rank combines them in rank order (the parallel variance formula:
  n = Σ n_i, mean = Σ n_i m_i / n, M2 = Σ M2_i + n_i (m_i − mean)²), so
  all ranks normalise with the same numbers, and moves the running
  statistics by the port's rule (flax momentum 0.99, the unbiased
  variance n/(n−1) of the global batch).

The all-reduce's backward all-reduces the gradient of the slots, so each
rank's parameter gradients, averaged over the group by the train step, are
the global batch's.  With one rank (no group) the layer is the port's
``BatchNorm`` to the bit.  Inside a remat block the update goes to copies,
as there.  :func:`convert` swaps the layer in.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..models.efficientnet import BatchNorm


class _AllReduceSum(torch.autograd.Function):
    """Σ over the group forward; Σ of the gradients over the group
    backward (every rank's loss depends on the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class GlobalBatchNorm(BatchNorm):
    """The port's ``BatchNorm`` with train-mode statistics of the global
    batch of ``group`` (module docstring)."""

    def __init__(self, features: int, eps: float, group):
        super().__init__(features, eps)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.group is None:
            return super().forward(x)
        import torch.distributed as dist

        world, rank = dist.get_world_size(self.group), dist.get_rank(self.group)
        dt = torch.float64 if x.dtype == torch.float64 else torch.float32
        xf = x.to(dt)
        c = xf.shape[-1]
        flat = xf.reshape(-1, c)
        n_i = flat.shape[0]
        m_i = flat.mean(dim=0)
        m2_i = ((flat - m_i) ** 2).sum(dim=0)
        slots = torch.zeros((world, 2, c), dtype=dt, device=x.device)
        slots[rank] = torch.stack([m_i, m2_i])
        every = _AllReduceSum.apply(slots, self.group)
        n = n_i * world  # the data-parallel ranks hold equal rows
        mean = every[:, 0].mean(dim=0)
        m2 = (every[:, 1] + n_i * (every[:, 0] - mean) ** 2).sum(dim=0)
        var = m2 / n
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight.to(dt) \
            + self.bias.to(dt)
        with torch.no_grad():
            rm, rv = self.running_mean, self.running_var
            if self.on_copies:
                rm, rv = rm.clone(), rv.clone()
                self.updated = (rm, rv)
            m = self.MOMENTUM
            rm.mul_(1 - m).add_(mean.detach().to(rm.dtype), alpha=m)
            rv.mul_(1 - m).add_((var.detach() * n / max(n - 1, 1)).to(rv.dtype),
                                alpha=m)
        return y.to(x.dtype)


@torch.no_grad()
def convert(model: nn.Module, group) -> nn.Module:
    """Every ``BatchNorm`` of ``model`` replaced in place by a
    :class:`GlobalBatchNorm` over ``group`` with its parameters and
    running statistics (the same tensors); a no-op for ``None``."""
    if group is None:
        return model
    for name, child in list(model.named_children()):
        if type(child) is BatchNorm:
            new = GlobalBatchNorm(child.weight.shape[0], child.eps, group)
            new.weight, new.bias = child.weight, child.bias
            new.running_mean = child.running_mean
            new.running_var = child.running_var
            setattr(model, name, new.train(child.training))
        else:
            convert(child, group)
    return model
