"""The collectives the sharded paths use, on plain tensors.

``gather_rows`` all-gathers same-shaped tensors into a (D, ...) stack;
``GatherRows`` is its autograd form, whose backward keeps this rank's row
of the incoming gradient (every rank of the group computed the same
replicated function of the gathered rows, so its row is the whole gradient
of its input: a sum over the group would count it once per rank).
``gather_shards`` makes a tensor split along a dimension whole;
``gather_flat_shards`` does it for many tensors in one all-gather.
``reduce_scatter_rows`` sums (D, ...) stacks over a group of D ranks and
keeps this rank's row. ``all_gather_single`` and ``reduce_scatter_single``
are the one-tensor collectives under their current names, with the names of
older PyTorch releases as the fallback.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                         or dist.reduce_scatter_tensor)


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """(n, ...) on each of D ranks → (D, n, ...), rank order, on every rank."""
    D = dist.get_world_size(group)
    out = torch.empty(D * t.numel(), dtype=t.dtype, device=t.device)
    all_gather_single(out, t.contiguous().view(-1), group=group)
    return out.view((D,) + tuple(t.shape))


def reduce_scatter_rows(t: torch.Tensor, group) -> torch.Tensor:
    """(D, ...) on each of D ranks → the SUM over ranks of row r, on rank r."""
    out = torch.empty(t[0].numel(), dtype=t.dtype, device=t.device)
    reduce_scatter_single(out, t.contiguous().view(-1), op=dist.ReduceOp.SUM, group=group)
    return out.view(tuple(t.shape[1:]))


def gather_shards(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole tensor from every rank's shard, split along ``dim``."""
    return torch.cat(gather_rows(t, group).unbind(0), dim=dim)


class GatherRows(torch.autograd.Function):
    """``gather_rows`` with a backward that keeps this rank's row."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group):
        ctx.rank = dist.get_rank(group)
        return gather_rows(t, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad[ctx.rank].contiguous(), None


def gather_flat_shards(tensors: Dict[str, torch.Tensor], dims: Dict[str, Optional[int]],
                       group, grad: bool) -> Dict[str, torch.Tensor]:
    """Every tensor whole: those split along ``dims[name]`` from their
    shards, in ONE all-gather of the shards laid end to end (one collective
    for all); those with ``None`` as they are. ``grad``: differentiable, each shard's gradient its own
    slice."""
    shards = {n: t for n, t in tensors.items() if dims[n] is not None}
    flat = torch.cat([t.reshape(-1) for t in shards.values()])
    rows = GatherRows.apply(flat, group) if grad else gather_rows(flat, group)   # (D, N)
    out = dict(tensors)
    # split, not a slice per tensor: the backward of a slice fills a zero
    # gradient of the whole (D, N) buffer, once per tensor
    for (name, t), part in zip(shards.items(),
                               rows.split([t.numel() for t in shards.values()], dim=1)):
        parts = part.reshape((rows.shape[0],) + tuple(t.shape))
        out[name] = torch.cat(parts.unbind(0), dim=dims[name])
    return out
