"""Mixture-of-Experts MLP (PyTorch).

Port of ``MoEMlp`` of the JAX package's ``models/moe.py``: token-choice
top-k routing with a fixed per-expert capacity C = ceil(T k / E *
capacity_factor), the Switch/GShard recipe. The gate is an f32 Dense and
softmax; choice j takes each token's most likely expert not taken by an
earlier choice (first index on ties) and gives the token the next free slot
of that expert, counted over the tokens in order after every slot the
earlier choices filled; a token past the capacity is dropped (the block's
residual carries it). The load-balancing loss E * sum_e f_e P_e (f_e the
share of tokens expert e kept, P_e its mean gate probability) is set on
``aux_loss`` by each forward, and f on ``kept_fraction``; no train step adds
the loss, in the JAX package or here.

The JAX module dispatches and combines by einsums against (T, E, C) one-hot
tensors, which at T = 32768, E = 8 and top-2 hold 2.7 G entries each. Here
the same function is computed from each token's slot index: the kept tokens
are copied into an (E, C, D) buffer (a dropped one into a spare row that is
cut off), the two expert products run as ``torch.bmm`` in the module's dtype
(f32 accumulation; a bf16 product is rounded to bf16 before the f32 bias,
where the JAX einsum keeps f32), and the outputs are gathered by
``index_select`` (whose backward is an ``index_add``, not the sorting
backward of advanced indexing) and added back to their tokens by
``index_add``, weighted by the gate probabilities of the chosen experts, not
renormalised. These are plain products and copies, as in the
JAX package, which runs them outside any Pallas kernel.

Expert parallelism: with ``mesh`` (a ``DeviceMesh``) and ``ep_axis`` (one of
its dimension names), each of the P ranks of that dimension holds E / P
experts (``w1``, ``b1``, ``w2``, ``b2`` split on dim 0, as
``moe_param_shardings`` and ``parallel.mesh.shard_parameters`` place them)
and the tokens are replicated over it, as in the JAX module under GSPMD. The
routing and the capacity are global: every rank routes every token, each
runs its own experts on the slots they were given and adds its part of the
combine, and a ``reduce_from`` over ``ep_axis`` sums the parts (the tokens
and their gate weights enter through ``copy_to``, so the gate's gradient is
summed over the parts too). When the mesh also has a ``"dp"`` dimension,
each of its ranks holds a shard of the batch, and the routing stays that of
the whole batch, as JAX's: a token's place in its expert's queue counts the
tokens of the dp ranks before it (an all-gather of each rank's counts) and
the capacity is that of every rank's tokens together. Each rank then runs its
experts over the whole capacity, the slots of other dp ranks' tokens being
zeros. Without a mesh, ``ep_axis`` changes nothing, as the JAX module's
sharding constraint does without one.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn

from flashfftconv_tpu_torch.models.layers import ACTIVATIONS, Dense, normal, zeros
from flashfftconv_tpu_torch.parallel.comm import copy_to, reduce_from


def _before_me(counts: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``counts`` over the ranks of ``group`` before this one."""
    parts = [torch.empty_like(counts) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, counts, group=group)
    return sum(parts[: dist.get_rank(group)], torch.zeros_like(counts))


def _summed(counts: torch.Tensor, group) -> torch.Tensor:
    counts = counts.clone()
    dist.all_reduce(counts, group=group)
    return counts


def route(probs: torch.Tensor, top_k: int, capacity: int, group=None):
    """Slots and combine weights of top-k routing with capacity.

    probs (T, E) f32 gate probabilities. Returns (slots, weights, fill):
    slots (top_k, T) int64, the flat slot e * capacity + c of each token's
    j-th choice, or E * capacity where it was dropped; weights (top_k, T),
    the gate probability of the chosen expert, 0 where dropped (it carries
    probs' grad); fill (E,) int64, the slots each expert filled. With
    ``group`` (the ranks that each hold a shard of the batch, in batch
    order), the queues and ``fill`` are those of the whole batch."""
    t, e = probs.shape
    experts = torch.arange(e, device=probs.device)
    fill = torch.zeros(e, dtype=torch.int64, device=probs.device)
    masked = probs.detach()
    slots, weights = [], []
    for _ in range(top_k):
        idx = masked.argmax(-1)
        chosen = experts[:, None] == idx  # (E, T), an expert a row
        # Each token's 1-based rank among the tokens that chose its expert, in
        # token order: one scan over the flattened rows, less each row's start
        # (a scan down the T axis of a (T, E) one-hot runs E lanes, 6 ms at
        # T = 32768 on an H100).
        count = chosen.flatten().cumsum(0).view(e, t)
        rank = count - (count[:, -1] - chosen.sum(1))[:, None]
        start = fill if group is None else fill + _before_me(chosen.sum(1), group)
        pos = rank.gather(0, idx[None])[0] + start[idx]
        keep = pos <= capacity
        slots.append(torch.where(keep, idx * capacity + pos - 1, e * capacity))
        weights.append(torch.where(keep, probs.gather(1, idx[:, None])[:, 0], 0.0))
        kept = (chosen & keep).sum(1)
        fill = fill + (kept if group is None else _summed(kept, group))
        masked = masked.masked_fill(chosen.T, 0.0)
    return torch.stack(slots), torch.stack(weights), fill


class MoEMlp(nn.Module):
    """y = combine(experts(dispatch(x))) over x (..., d_model).

    n_experts E, top_k experts a token, capacity_factor as above;
    ``activation`` names an entry of ``layers.ACTIVATIONS`` (flax's tanh
    GELU by default, as the JAX module's ``nn.gelu``); ``dtype`` is the
    experts' compute dtype (x's when None). Parameters: ``gate`` (a Dense
    d_model -> E), w1 (E, d_model, d_inner), b1 (E, d_inner), w2 (E,
    d_inner, d_model), b2 (E, d_model), in the JAX module's layout. With
    ``mesh`` and ``ep_axis`` the experts are split over that dimension and,
    where the mesh has a ``"dp"`` dimension, the batch over that one (module
    docstring)."""

    def __init__(self, d_model, d_inner, n_experts, top_k=1, capacity_factor=1.25, ep_axis=None,
                 activation="gelu", dtype=None, mesh=None, device="cuda", generator=None):
        super().__init__()
        self.ep_axis = ep_axis
        self.mesh = mesh if ep_axis is not None else None
        self.n_experts, self.top_k, self.capacity_factor = n_experts, top_k, capacity_factor
        self.activation = ACTIVATIONS[activation]
        self.dtype = dtype
        self.gate = Dense(d_model, n_experts, dtype=torch.float32, device=device,
                          generator=generator)
        self.w1 = normal((n_experts, d_model, d_inner), 1.0 / math.sqrt(d_model), generator,
                         device)
        self.b1 = zeros((n_experts, d_inner), device)
        self.w2 = normal((n_experts, d_inner, d_model), 1.0 / math.sqrt(d_inner), generator,
                         device)
        self.b2 = zeros((n_experts, d_model), device)
        self.aux_loss = None
        self.kept_fraction = None

    def capacity(self, tokens: int) -> int:
        return max(math.ceil(tokens * self.top_k / self.n_experts * self.capacity_factor), 1)

    def _groups(self):
        """(ep group or None, dp group or None)."""
        if self.mesh is None:
            return None, None
        names = self.mesh.mesh_dim_names
        return (self.mesh.get_group(self.ep_axis),
                self.mesh.get_group("dp") if "dp" in names else None)

    def forward(self, x):
        shape, d = x.shape, x.shape[-1]
        tokens = x.reshape(-1, d)
        t, e = tokens.shape[0], self.n_experts
        ep, dp = self._groups()
        t_all = t * (dist.get_world_size(dp) if dp is not None else 1)
        cap = self.capacity(t_all)
        probs = self.gate(tokens.float()).softmax(-1)
        slots, weights, fill = route(probs, self.top_k, cap, dp)
        self.kept_fraction = fill.float() / t_all
        p_mean = probs.mean(0) if dp is None else reduce_from(probs.sum(0), dp) / t_all
        self.aux_loss = e * (self.kept_fraction * p_mean).sum()

        dt = self.dtype or x.dtype
        flat = slots.reshape(-1)
        e_loc, lo = e, 0
        if ep is not None:  # this rank's experts: slots [lo, lo + e_loc * cap)
            e_loc = self.w1.shape[0]
            if e_loc * dist.get_world_size(ep) != e:
                raise ValueError(f"{self.w1.shape[0]} experts on each of "
                                 f"{dist.get_world_size(ep)} ranks of {self.ep_axis!r}, not "
                                 f"{e}: split them with moe_param_shardings")
            lo = dist.get_rank(ep) * e_loc * cap
            tokens, weights = copy_to(tokens, ep), copy_to(weights, ep)
            mine = (flat >= lo) & (flat < lo + e_loc * cap)
            flat = torch.where(mine, flat - lo, e_loc * cap)
            weights = torch.where(mine.view_as(weights), weights, 0.0)
        buf = tokens.new_zeros(e_loc * cap + 1, d, dtype=dt).index_copy(
            0, flat, tokens.to(dt).repeat(self.top_k, 1))
        xin = buf[:-1].view(e_loc, cap, d)
        h = torch.bmm(xin, self.w1.to(dt)).float() + self.b1[:, None, :]
        h = self.activation(h)
        y_e = (torch.bmm(h.to(dt), self.w2.to(dt)).float() + self.b2[:, None, :]).view(-1, d)
        # a dropped choice (or another rank's expert) reads the last slot with weight 0
        y_tok = y_e.index_select(0, flat.clamp(max=e_loc * cap - 1)) * weights.reshape(-1, 1)
        rows = torch.arange(t, device=x.device).repeat(self.top_k)
        y = y_e.new_zeros(t, d).index_add(0, rows, y_tok)
        if ep is not None:
            y = reduce_from(y, ep)
        return y.reshape(shape).to(x.dtype)


def moe_param_shardings(mesh, model: nn.Module, ep_axis: str = "ep") -> dict:
    """{parameter name: parallel.mesh.Sharding} for a model holding MoEMlp
    layers: the expert tensors (w1, b1, w2, b2, leading dim n_experts) split
    over ``ep_axis`` on dim 0, everything else replicated. Apply with
    ``parallel.mesh.shard_parameters``."""
    from flashfftconv_tpu_torch.parallel.mesh import Sharding

    experts = {f"{name}.{leaf}" if name else leaf
               for name, m in model.named_modules() if isinstance(m, MoEMlp)
               for leaf in ("w1", "b1", "w2", "b2")}
    return {name: Sharding(mesh, tuple(ep_axis if d == 0 and name in experts else None
                                       for d in range(p.ndim)))
            for name, p in model.named_parameters()}
