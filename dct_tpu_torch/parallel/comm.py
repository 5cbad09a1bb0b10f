"""Collectives for the parallel steps, on ``torch.distributed``.

``all_gather`` carries gradients: its backward sums the cotangents of
every rank and hands each rank its own slice, as JAX's transpose of
``all_gather`` does (a reduce-scatter, made here of an all-reduce:
``torch.distributed.nn.functional.all_gather`` emulates it on gloo with
scatters addressed by group rank, which fails in any subgroup without
global rank 0). ``all_reduce_``, ``broadcast_`` and ``gather_rows`` act
on values that need no gradient.

A group of one rank, or ``None``, is the identity everywhere, so a step
written against a group runs unchanged in one process. On the gloo
backend a CUDA tensor is copied to the host for the collective and back;
``HOST_STAGED`` records that this happened.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

HOST_STAGED = False      # set once a gloo collective has staged a CUDA tensor


def group_size(group) -> int:
    """Ranks in ``group``; 1 for None (no process group)."""
    return 1 if group is None else dist.get_world_size(group)


def _staged(x: torch.Tensor, group) -> bool:
    global HOST_STAGED
    if x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        HOST_STAGED = True
        return True
    return False


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        if _staged(x, group):
            host = x.detach().cpu().contiguous()
            parts = [torch.empty_like(host) for _ in range(group_size(group))]
            dist.all_gather(parts, host, group=group)
            return torch.stack(parts).to(x.device)
        parts = [torch.empty_like(x) for _ in range(group_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce_(grad.contiguous().clone(), ctx.group)
        return grad[dist.get_rank(ctx.group)], None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in group-rank order, with
    gradient."""
    if group_size(group) == 1:
        return x[None]
    return _AllGather.apply(x, group)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` of a tensor that needs no gradient."""
    if group_size(group) == 1:
        return x
    if _staged(x, group):
        host = x.detach().cpu()
        dist.all_reduce(host, group=group)
        x.copy_(host)
    else:
        dist.all_reduce(x, group=group)
    return x


def broadcast_(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """In-place broadcast from global rank ``src`` over ``group``."""
    if group_size(group) == 1:
        return x
    if _staged(x, group):
        host = x.detach().cpu()
        dist.broadcast(host, src, group=group)
        x.copy_(host)
    else:
        dist.broadcast(x, src, group=group)
    return x


def gather_rows(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order (no
    gradient): a data-sharded axis made whole again."""
    if group_size(group) == 1:
        return x
    with torch.no_grad():
        parts = all_gather(x.detach().contiguous(), group)
    return torch.cat(list(parts), dim=dim)


def flat_all_reduce_grads(params, group, scale: Optional[float] = None) -> None:
    """Sum the ``.grad`` of ``params`` over ``group`` in one flat buffer,
    then multiply by ``scale`` when given. A parameter without a gradient
    (the same on every rank of the group, which runs the same graph) keeps
    none, so the optimizer skips it as it would in one process."""
    if group_size(group) == 1 and scale is None:
        return
    params = [p for p in params if p.grad is not None]
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    all_reduce_(flat, group)
    if scale is not None:
        flat.mul_(scale)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[offset:offset + n].view(p.shape))
        offset += n
