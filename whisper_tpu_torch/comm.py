"""The collectives of the mesh, written out: the port runs SPMD over
torch.distributed (one process per device), so what GSPMD derives from the
JAX package's sharding annotations is called here by hand, by the graphs
(models/graphs.py: tp and sp) and by parallel/ (dp and pp).

Each function takes a process group (one axis of the mesh,
parallel/mesh.py) or None; a group of one rank, or None, makes every
function the identity, so an unsharded call does no communication and the
same arithmetic as the single-device graphs. The autograd Functions are megatron's:

  copy_to_group     identity forward, all-reduce (sum) of the gradient
                    backward: the input of a column-parallel product, whose
                    ranks each compute a part of the input's gradient
  reduce_from_group all-reduce (sum) forward, identity backward: the output
                    of a row-parallel product, each rank holding a partial sum
  gather_from_group all-gather along a dim forward; backward, the gradient
                    summed over the group and this rank's slice of it (each
                    rank's use of the gathered tensor is its own part of the
                    loss, as sp's local queries over the gathered K/V are)
  stage_handoff     the pipeline hand-off: stage s receives stage s - 1's
                    tensor (stage 0 gets zeros); backward, the reverse

The hand-off is an all-gather over the pipeline group rather than send and
recv, so that it runs on every backend, gloo with CUDA tensors included
(several ranks sharing one card, where NCCL refuses). Under inference_mode
the Functions run their forwards.
"""

from typing import Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def group_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(x, group: Group, op=dist.ReduceOp.SUM):
    """x reduced over the group, in place; x itself when there is no one to
    reduce with."""
    if group_size(group) > 1:
        dist.all_reduce(x, op=op, group=group)
    return x


def all_gather(x, group: Group, dim: int = 0):
    """Every rank's x, concatenated along `dim` in rank order."""
    n = group_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def local_slice(x, group: Group, dim: int):
    """This rank's 1/n of x along `dim` (contiguous), the inverse of
    all_gather; x itself on a group of one."""
    n = group_size(group)
    if n == 1:
        return x
    return x.chunk(n, dim=dim)[group_rank(group)].contiguous()


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return local_slice(all_reduce(g.contiguous().clone(), ctx.group), ctx.group, ctx.dim), None, None


def _shift(x, group, by):
    """Rank r's result is rank r - by's x (zeros where that rank does not
    exist): one all-gather of the group."""
    n, r = group_size(group), group_rank(group)
    parts = all_gather(x.contiguous()[None], group).unbind(0)
    return parts[r - by].clone() if 0 <= r - by < n else torch.zeros_like(x)


class _StageHandoff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        # stage s's input gradient is stage s + 1's: the hand-off reversed
        return _shift(g, ctx.group, -1), None


def copy_to_group(x, group: Group):
    return x if group_size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x, group: Group):
    return x if group_size(group) == 1 else _ReduceFromGroup.apply(x, group)


def gather_from_group(x, group: Group, dim: int):
    return x if group_size(group) == 1 else _GatherFromGroup.apply(x, group, dim)


def stage_handoff(x, group: Group):
    """Stage s's input for the next tick: stage s - 1's `x`. Every stage of
    the group calls it every tick, as a collective."""
    if group_size(group) == 1:
        return torch.zeros_like(x)
    return _StageHandoff.apply(x, group)


def broadcast_from(x, group: Group, src: int):
    """Rank `src` (of the group)'s x on every rank of the group, in place."""
    if group_size(group) > 1:
        dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    return x
