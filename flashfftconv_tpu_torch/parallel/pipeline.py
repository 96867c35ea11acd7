"""Pipeline parallelism (a GPipe schedule) over a mesh dimension.

Port of the JAX package's ``parallel/pipeline.py``. The S ranks of the
``pp`` dimension each hold one stage's parameters (a dict of tensors,
stacked over the stages by ``stack_stage_params`` and split on the stage dim
by ``stage_param_shardings``), and M microbatches stream through them in
M + S - 1 ticks: at tick t stage 0 takes microbatch t, every stage runs
``stage_fn`` on what it holds, the last stage writes its output as
microbatch t - (S - 1), and each stage hands its output to the next. The
hand-over, JAX's ``ppermute``, is an ``all_to_all_single`` that sends to
rank s + 1 only (``seq_conv``'s differentiable all-to-all, whose adjoint
sends the gradient back); every rank takes part in every hand-over, and its
received block (empty on stage 0) is padded to a microbatch, so every rank
builds the same graph and the backward runs the same collectives in the
same order on each. The output is replicated over ``pp`` by a sum from the
last stage (``reduce_from``), and the input enters through ``copy_to``, so
that its gradient, which stage 0 alone computes, reaches every rank.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from flashfftconv_tpu_torch.parallel.comm import copy_to, reduce_from
from flashfftconv_tpu_torch.parallel.mesh import Sharding
from flashfftconv_tpu_torch.parallel.seq_conv import _AllToAll


def stack_stage_params(param_trees: list[dict]) -> dict:
    """S per-stage parameter dicts of one structure -> one dict whose tensors
    carry a leading stage dim."""
    return {name: torch.stack([tree[name] for tree in param_trees]) for name in param_trees[0]}


def stage_param_shardings(mesh, stage_params: dict, axis: str = "pp") -> dict:
    """{name: Sharding} splitting each tensor's leading stage dim over
    ``axis``: ``Sharding.local`` of it is this rank's stage, with a leading
    dim of 1."""
    return {name: Sharding(mesh, (axis,) + (None,) * (t.ndim - 1))
            for name, t in stage_params.items()}


def _hand_over(y: torch.Tensor, group, s_total: int, sid: int) -> torch.Tensor:
    """y sent to stage sid + 1; returns what stage sid - 1 sent (zeros on
    stage 0)."""
    rows = y.shape[0]
    send = [rows if r == sid + 1 else 0 for r in range(s_total)]
    recv = [rows if r == sid - 1 else 0 for r in range(s_total)]
    got = _AllToAll.apply(y[: sum(send)], send, recv, group)
    return torch.cat([y.new_zeros((rows - got.shape[0], *y.shape[1:])), got])


def pipeline_apply(stage_fn: Callable, stage_params: dict, x: torch.Tensor, mesh,
                   axis: str = "pp", num_microbatches: int | None = None,
                   batch_axis: str | None = None) -> torch.Tensor:
    """y = f_{S-1}(... f_1(f_0(x))) over the S ranks of ``axis``.

    stage_fn(params, x_mb) -> y_mb of x_mb's shape and dtype (a residual-
    stream segment, such as a run of LM blocks: ``torch.func.functional_call``
    of a module with this stage's parameters). stage_params: this rank's
    stage, {name: tensor of leading dim 1} (``Sharding.local`` of
    ``stage_param_shardings``). x: (B, ...), the same on every
    rank of ``axis``, or this rank's shard of the batch where a mesh
    dimension splits it: the mesh gives each of that dimension's groups its
    own ``axis`` group, so each runs its own pipeline. ``batch_axis`` names
    that dimension, as the JAX function's argument does; it is only checked
    to be one of the mesh's and changes nothing else. B % num_microbatches
    == 0 (M defaults to S). Returns (B, ...), the same on every rank of
    ``axis``."""
    group = mesh.get_group(axis)
    s_total, sid = dist.get_world_size(group), dist.get_rank(group)
    if batch_axis is not None and batch_axis not in mesh.mesh_dim_names:
        raise ValueError(f"no mesh dimension {batch_axis!r} in {mesh.mesh_dim_names}")
    m = num_microbatches or s_total
    if x.shape[0] % m:
        raise ValueError(f"per-group batch {x.shape[0]} not divisible into {m} microbatches")
    if any(t.shape[0] != 1 for t in stage_params.values()):
        raise ValueError("stage_params must hold this rank's stage alone (leading dim 1)")
    params = {name: t[0] for name, t in stage_params.items()}
    xs = copy_to(x, group).reshape(m, x.shape[0] // m, *x.shape[1:])
    first = torch.tensor(sid == 0, device=x.device)
    last = torch.tensor(sid == s_total - 1, device=x.device)
    buf = torch.zeros_like(xs[0])
    out = [torch.zeros_like(xs[0])] * m
    for t in range(m + s_total - 1):
        y = stage_fn(params, torch.where(first, xs[min(t, m - 1)], buf))
        if t >= s_total - 1:
            o = t - (s_total - 1)
            out[o] = torch.where(last, y, out[o])
        buf = _hand_over(y, group, s_total, sid)
    out = torch.stack(out)
    return reduce_from(torch.where(last, out, torch.zeros_like(out)), group).reshape(x.shape)


__all__ = ["stack_stage_params", "stage_param_shardings", "pipeline_apply"]
