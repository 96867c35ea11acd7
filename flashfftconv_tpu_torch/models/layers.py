"""Dense, LayerNorm and Embed with flax's dtype semantics, and seeded inits.

The JAX package's layers keep f32 parameters and cast at the call: a flax
``Dense(dtype=bf16)`` casts both input and kernel to bf16, a ``LayerNorm``
with ``dtype=f32`` computes in f32, and ``Embed(dtype=bf16)`` returns bf16
rows and attends in bf16. These modules do the same, so a model's numbers
follow the JAX package step by step. Weights are (out, in) as in
``nn.Linear``. Every init draws on the CPU from the caller's
``torch.Generator`` and then moves to the device, so one seed gives the same
weights on every device. ``ACTIVATIONS`` names the MLP activations.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS = {
    # flax's nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    # nn.gelu(approximate=False), which ViT and the attention BERT use
    "gelu_exact": F.gelu,
    "relu": F.relu,
}


def normal(shape, std: float, generator, device) -> nn.Parameter:
    return nn.Parameter((torch.randn(shape, generator=generator) * std).to(device))


def uniform(shape, low: float, high: float, generator, device) -> nn.Parameter:
    t = torch.rand(shape, generator=generator) * (high - low) + low
    return nn.Parameter(t.to(device))


def zeros(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device))


class Dense(nn.Module):
    """``y = x W^T + b`` computed in ``dtype``: the one given at the call,
    else the one given at construction, else the promotion of the input's
    and the parameters' dtypes (a flax Dense without dtype)."""

    def __init__(self, in_features, out_features, bias=True, dtype=None, device="cuda",
                 generator=None):
        super().__init__()
        self.dtype = dtype
        # lecun_normal, as flax's default kernel init (untruncated here)
        self.weight = normal((out_features, in_features), 1.0 / math.sqrt(in_features),
                             generator, device)
        self.bias = zeros((out_features,), device) if bias else None
        # parallel.mesh.shard_parameters sets a TensorParallelLinear here when
        # it splits the weight
        self.tp = None

    def forward(self, x, dtype=None):
        dt = dtype or self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        if self.tp is not None:
            return self.tp(x.to(dt), self.weight.to(dt), b)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim, computed in f32 and returned in ``dtype``."""

    def __init__(self, dim, eps=1e-5, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = zeros((dim,), device)

    def forward(self, x):
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias, self.eps)
        return y.to(self.dtype)


class Embed(nn.Module):
    """Token embedding whose rows come out in ``dtype``; ``attend`` is the
    tied LM head (``h @ table^T`` in ``dtype``)."""

    def __init__(self, num_embeddings, dim, dtype=torch.bfloat16, device="cuda", generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = normal((num_embeddings, dim), 1.0 / math.sqrt(dim), generator, device)

    def forward(self, ids):
        return F.embedding(ids, self.weight).to(self.dtype)

    def attend(self, h):
        return F.linear(h.to(self.dtype), self.weight.to(self.dtype))
