"""Collectives over a process group, with autograd where the sharded paths
differentiate through them.

Where the JAX package's `shard_map` inserts a collective and its transpose,
the port calls these:

* `all_gather`: concatenation along dim 0 in group-rank order; backward,
  the sum over ranks of the cotangents, each rank keeping its own chunk
  (`reduce_scatter_tensor`). `torch.distributed.nn.functional.all_gather`
  is not used: its gloo backward scatters from a group rank as if it were a
  global rank, and fails on a subgroup that lacks rank 0.
* `all_to_all`: equal chunks of dim 0 exchanged; its backward is the same
  exchange of the cotangents.
* `replicated_output`: identity whose backward divides the cotangent by the
  group size. A result gathered to every rank, with a loss taken on every
  rank, then gets the single-device gradient (JAX divides the cotangent of
  a replicated `shard_map` output the same way).
* `all_reduce`: SUM or MAX, no autograd.

They take CUDA tensors on NCCL and on gloo alike: gloo (torch 2.11 and
2.13) runs each of these collectives on CUDA tensors by copying them
through host memory itself, which is how two gloo ranks share one card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """A new tensor holding the SUM or MAX of `x` over `group`."""
    out = x.detach().clone()
    dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                    group=group)
    return out


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _sum_scatter(g: torch.Tensor, group) -> torch.Tensor:
    """The sum of `g` [n * m, ...] over the group's n ranks; this rank's
    chunk of m rows."""
    g = g.contiguous()
    out = g.new_empty((g.shape[0] // dist.get_world_size(group),) + tuple(g.shape[1:]))
    dist.reduce_scatter_tensor(out, g, group=group)
    return out


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum_scatter(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


class _ReplicatedOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """[n * m, ...] from each rank's [m, ...], in group-rank order."""
    return _AllGather.apply(x, group)


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Chunk j of dim 0 goes to rank j; chunk j of the result came from
    rank j. Dim 0 must split into equal chunks."""
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 ({x.shape[0]}) does not split over {n} ranks")
    return _AllToAll.apply(x, group)


def replicated_output(x: torch.Tensor, group=None) -> torch.Tensor:
    """`x`, replicated over `group`: its cotangent is divided by the group
    size on the way back."""
    return _ReplicatedOutput.apply(x, group)
