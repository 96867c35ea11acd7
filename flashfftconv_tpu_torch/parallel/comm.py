"""Differentiable collectives over one process group: the region functions of
Megatron's tensor parallelism, which tensor, vocabulary, expert and pipeline
parallelism build on.

Every rank of the group runs the same program on the same replicated
activations, except inside a region where each holds a part of some tensor.
The functions mark the borders of such a region, and each one's backward is
the adjoint that keeps the gradients of replicated tensors equal on every
rank:

  - ``copy_to``: forward the identity, backward an all-reduce (sum). A
    replicated tensor enters a region where each rank uses it for its own
    part, so its gradient is the sum of the parts';
  - ``reduce_from``: forward an all-reduce (sum), backward the identity. The
    parts leave a region summed; what follows is replicated, so every rank
    already holds the whole gradient;
  - ``scatter_to``: forward this rank's chunk of ``dim``, backward an
    all-gather along it;
  - ``gather_from``: forward an all-gather along ``dim``, backward this
    rank's chunk of the gradient.

JAX's ``shard_map`` makes the same choices when it transposes ``psum`` and
``all_gather`` of values it knows to be replicated. Every rank must call the
same collectives in the same order, forward and backward: a function whose
output one rank leaves unused never runs its backward there, and the others
wait for it. On a group of one rank each function is the identity and
calls no collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    if dist.get_world_size(group) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    p = dist.get_world_size(group)
    if p == 1:
        return x
    if x.shape[dim] % p:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over {p} ranks")
    return x.chunk(p, dim=dim)[dist.get_rank(group)].contiguous()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    if dist.get_world_size(group) == 1:
        return x
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.dim, ctx.group), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """x unchanged; its gradient is summed over ``group``."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over ``group``; the gradient passes through unchanged."""
    return _ReduceFrom.apply(x, group)


def scatter_to(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk of ``dim`` (chunks in rank order); the gradient is
    gathered back to the whole of ``dim``."""
    return _ScatterTo.apply(x, dim % x.ndim, group)


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's x concatenated along ``dim`` in rank order; the gradient
    is cut back to this rank's chunk."""
    return _GatherFrom.apply(x, dim % x.ndim, group)


__all__ = ["copy_to", "reduce_from", "scatter_to", "gather_from"]
