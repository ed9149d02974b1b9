"""The two autograd Functions of Megatron-style tensor parallelism.

A product whose weight is split over a group (heads, FF columns,
experts) takes a replicated input and leaves each rank a partial sum:

- :func:`copy_to_group` wraps the input: identity forward; backward
  sums the input's gradient over the group, since each rank's partial
  product contributes to it;
- :func:`reduce_from_group` wraps the partial output: forward sums it
  over the group into the replicated result; backward is identity,
  since every rank's partial feeds that sum with weight one.

These are the collectives XLA inserts from the JAX package's shardings
(``param_shardings``, ``moe_param_specs``), written out by hand. Both
run their collective at every group size: at one rank an all-reduce is
a copy through the backend.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)
