"""The collectives of the mesh, over ``torch.distributed`` process groups.

Tensor parallelism replicates the loss on every rank of the model group,
so its two autograd-aware collectives are megatron's f and g:

  * ``copy_to_group`` (f): identity forward, the gradient all-reduced
    (summed) backward. It goes before a column-parallel product, whose
    input is replicated and whose gradient each rank holds a share of.
  * ``reduce_from_group`` (g): all-reduce (sum) forward, identity
    backward. It ends a row-parallel product and a vocab-parallel lookup.

``torch.distributed.nn.functional.all_reduce`` is not g: its backward sums
the cotangents of every rank, which for a loss replicated over the group
is m times the gradient. A group of one rank (or None) makes every
function here the identity, with no collective.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def group_size(group) -> int:
    """Ranks in ``group``; 1 for None (no process group)."""
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (and returned)."""
    if group_size(group) > 1:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``t`` (of one shape) concatenated along ``dim``, in group
    rank order."""
    n = group_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(memory_format=torch.contiguous_format),
                          group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """f: ``x``, whose gradient is summed over ``group``."""
    if group_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """g: ``x`` summed over ``group``; the gradient passes through."""
    if group_size(group) == 1:
        return x
    return _ReduceFromGroup.apply(x, group)


def broadcast_object(obj, src: int = 0):
    """``obj`` of global rank ``src``, on every rank of the world."""
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


class VocabShard:
    """A vocab-parallel table's share: rows [start, start + rows) of
    ``size`` on this rank of ``group``."""

    def __init__(self, group, start: int, size: int):
        self.group, self.start, self.size = group, start, size
