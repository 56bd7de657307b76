"""The collectives of the model axes, as autograd functions.

The JAX package leaves them to XLA, which also derives each one's
transpose.  Here each is written out, and the right backward depends on
whether what follows the collective is the same on every rank of the
group (replicated) or not:

  copy_to(x, g)         identity; backward: the sum over g.  Megatron's f:
                        the input of a column-parallel product (each rank
                        adds its heads' or its columns' part of dx)
  reduce_from(x, g)     the sum over g; backward: identity.  Megatron's g:
                        a row-parallel product's partials, summed into what
                        every rank then computes alike (a sum in the
                        backward would count the cotangent g-size times)
  gather_from(x, g, d)  every rank's x joined along dim d; backward: this
                        rank's part of the cotangent (what follows is
                        replicated, so each rank has the whole cotangent)
  gather_weight(x, g, d) the same join for a weight that each rank then
                        uses for its own part of the work; backward: the
                        sum over g, then this rank's part
  sum_both(x, g)        the sum over g; backward: the sum over g.  A mean
                        over the whole batch that each rank uses for its
                        share of the loss (MoE's load-balancing fractions
                        over the data group)

Each goes through torch.distributed: NCCL where every rank has a card of
its own, and through host memory for a card's tensors on a gloo group
(ranks that share a card), as `ops.collective.all_reduce` and
`all_gather` move them.  A group of one (None, or no process group) makes
every function the identity.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import collective as C


def group_size(group) -> int:
    return dist.get_world_size(group) if group is not None and dist.is_initialized() else 1


def group_rank(group) -> int:
    return dist.get_rank(group) if group is not None and dist.is_initialized() else 0


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    return C.all_reduce(x.contiguous(), group, "sum")


def _join(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = C.all_gather(x.contiguous(), group)  # [n, *x.shape]
    return torch.cat(parts.unbind(0), dim=dim)


def _part(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    return x.chunk(n, dim=dim)[group_rank(group)].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, summed):
        ctx.group, ctx.dim, ctx.summed = group, dim, summed
        return _join(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = _sum(g, ctx.group)
        return _part(g, ctx.group, ctx.dim), None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def sum_both(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _SumBoth.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group_size(group) == 1 else _GatherFrom.apply(x, group, dim, False)


def gather_weight(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group_size(group) == 1 else _GatherFrom.apply(x, group, dim, True)


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over the group (no gradient)."""
    return x if group_size(group) == 1 else C.all_reduce(x.detach().contiguous(), group, "max")
