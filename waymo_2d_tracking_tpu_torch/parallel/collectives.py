"""Collectives that autograd sees, for data-parallel training.

The JAX package's data-parallel step is one jitted program with sharding
annotations, so it means what the single-device step on the global batch
means. The port's ranks each hold a shard of the batch; every quantity that
couples the whole batch is gathered or summed over the data axis, and each
rank's loss is its share of the global loss, so that the sum of the ranks'
losses is the global loss and the sum of their gradients its gradient:

- ``all_gather_rows``: every rank's rows in rank order. Every rank's loss
  may depend on every row, so its backward sums the gradients of the
  gathered rows over the ranks and keeps this rank's slice (an all-reduce,
  which every backend has, in place of a reduce-scatter, which gloo lacks);
- ``sum_detached``: a sum over the ranks outside autograd (counts,
  normalisers, metrics, the gradients themselves).

A group of one is the identity.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, x.contiguous(), group=group)
        return torch.cat(out)

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * ctx.rows:(r + 1) * ctx.rows], None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along the first axis in
    rank order (differentiable)."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllGatherRows.apply(x, group)


def sum_detached(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the ranks, outside autograd (counts, metrics)."""
    y = x.detach().clone(memory_format=torch.contiguous_format)
    if dist.get_world_size(group) > 1:
        dist.all_reduce(y, group=group)
    return y
