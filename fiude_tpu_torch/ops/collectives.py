"""The collectives of the sharded paths, on ``torch.distributed``.

No counterpart in ``fiude_tpu``: there XLA inserts every collective from the
shardings (GSPMD), and ``shard_map`` code writes ``jax.lax.psum``, whose
transpose is ``psum``.  Here the port writes them by hand:

* :func:`all_reduce`: the sum over a process group, differentiable; its
  backward sums the cotangents over the group (the transpose of ``psum``);
* :func:`all_gather`: concatenation of every rank's block along a dimension,
  differentiable; its backward sums the cotangents over the group and keeps
  this rank's block (a reduce-scatter);
* :func:`reduce_` and :func:`gather`: the same, in place or to a list, outside
  autograd (the gradient buffer, the centering round, serving's output);
* :func:`broadcast_`: a tensor from the group's first rank.

A group is a ``torch.distributed`` process group, or None for one process
alone, where every function is the identity (this is not torch's convention,
in which None names the default group).  Gloo takes CUDA tensors for
``all_reduce``, ``broadcast`` and the list form of ``all_gather`` (through the
host), so two ranks can share one card; these functions use nothing else.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.index, ctx.width = dist.get_rank(group), x.shape[dim]
        return torch.cat(gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width), None, None


def all_reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; its gradient is the sum of the
    cotangents over ``group``."""
    return x if group is None else _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """Every rank's ``x`` (all of one shape) concatenated along ``dim`` in
    group rank order; differentiable."""
    return x if group is None else _AllGather.apply(x, dim % x.ndim, group)


def reduce_(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place, outside autograd; returns ``x``."""
    if group is not None:
        with torch.no_grad():
            dist.all_reduce(x, group=group)
    return x


def gather(x: torch.Tensor, group: Group) -> List[torch.Tensor]:
    """Every rank's ``x`` in group rank order, outside autograd."""
    if group is None:
        return [x]
    x = x.detach().contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return out


def broadcast_(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Overwrite ``x`` with the group's first rank's ``x``; returns ``x``."""
    if group is not None:
        dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
    return x
