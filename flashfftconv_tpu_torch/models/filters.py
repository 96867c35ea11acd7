"""Implicit convolution-kernel generators (Hyena filters), in PyTorch.

Port of the JAX package's ``models/filters.py``: a small MLP with
sinusoidal activations maps complex-exponential positional embeddings to a
(1, L, d) filter, modulated by a fixed exponential decay. Parameter names
follow the flax tree (``layers.{i}`` for ``layers_{i}``, ``freq``, ``bias``)
so ``utils.jax_weights`` can carry flax weights over.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from flashfftconv_tpu_torch.models.layers import Dense, normal
from flashfftconv_tpu_torch.ops.plan import resolve_device


class Sin(nn.Module):
    """Sinusoidal activation with (optionally trainable) frequency."""

    def __init__(self, dim, w=10.0, w_mod=1.0, train_freq=True, device="cuda"):
        super().__init__()
        self.w = w
        self.w_mod = w_mod
        self.freq = (
            nn.Parameter(torch.full((1, dim), float(w), device=device)) if train_freq else None
        )

    def forward(self, x):
        freq = self.freq.to(x.dtype) if self.freq is not None else self.w
        return torch.sin(self.w_mod * freq * x)


def positional_embedding(emb_dim: int, seq_len: int, device="cuda"):
    """Complex-exponential positional embeddings, computed in numpy f64.

    Returns (z, t): z (1, L, emb_dim) = [t, Re(e^{-i f w}), Im(e^{-i f w})],
    t (1, L, 1) normalized time, both f32.
    """
    if emb_dim % 2 == 0 or emb_dim < 3:
        raise ValueError("emb_dim must be odd and >= 3 (time, sine, cosine)")
    t = np.linspace(0, 1, seq_len)[None, :, None]
    bands = (emb_dim - 1) // 2
    t_rescaled = np.linspace(0, seq_len - 1, seq_len)[None, :, None]
    w = 2 * math.pi * t_rescaled / seq_len
    f = np.linspace(1e-4, bands - 1, bands)[None, None]
    z = np.exp(-1j * f * w)
    z = np.concatenate([t, z.real, z.imag], axis=-1)
    as_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return as_t(z), as_t(t)


class ExponentialModulation(nn.Module):
    """Per-channel exponential decay envelope (``deltas`` from linspace)."""

    def __init__(self, d_model, fast_decay_pct=0.3, slow_decay_pct=1.5, target=1e-2,
                 shift=0.0, learn_modulation=False, device="cuda"):
        super().__init__()
        self.shift = shift
        max_decay = math.log(target) / fast_decay_pct
        min_decay = math.log(target) / slow_decay_pct
        init = torch.from_numpy(
            np.linspace(min_decay, max_decay, d_model)[None, None].astype(np.float32)
        ).to(device)
        if learn_modulation:
            self.deltas = nn.Parameter(init)
        else:
            self.register_buffer("deltas", init, persistent=False)

    def forward(self, t, x):
        decay = torch.exp(-t * self.deltas.abs())
        return x * (decay + self.shift).to(x.dtype)


class HyenaFilter(nn.Module):
    """Implicit long filter with modulation; ``forward(L)`` returns the
    (1, L, d_model) kernel, in f32 or in ``mlp_dtype`` when that is set: the
    compute dtype of the implicit MLP (its Dense layers cast input and
    weights to it; the parameters stay f32). ``dropout`` and ``use_bias``
    are accepted and unused, as in the JAX module."""

    def __init__(self, d_model, emb_dim=3, order=16, seq_len=1024, dropout=0.0, w=1.0,
                 w_mod=1.0, num_inner_mlps=2, use_bias=True, modulate=True, normalized=False,
                 linear_mixer=False, modulation_args=None, mlp_dtype=None, device="cuda",
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.mlp_dtype = mlp_dtype
        self.modulate = modulate
        self.normalized = normalized
        self.linear_mixer = linear_mixer
        z, t = positional_embedding(emb_dim, seq_len, device)
        self.register_buffer("z", z, persistent=False)
        self.register_buffer("t", t, persistent=False)
        self.bias = normal((d_model,), 1.0, generator, device)
        dense = lambda i, o, b=True: Dense(i, o, bias=b, dtype=mlp_dtype, device=device,
                                           generator=generator)
        if linear_mixer:
            layers = [dense(emb_dim, d_model, False)]
        else:
            layers = [dense(emb_dim, order), Sin(order, w=w, w_mod=w_mod, device=device)]
            for _ in range(num_inner_mlps):
                layers += [dense(order, order), Sin(order, w=w, w_mod=w_mod, device=device)]
            layers.append(dense(order, d_model, False))
        self.layers = nn.ModuleList(layers)
        self.modulation = ExponentialModulation(d_model, **(modulation_args or {}), device=device)

    def forward(self, length: int):
        h = self.z[:, :length]
        t = self.t[:, :length]
        if self.mlp_dtype is not None:
            h = h.to(self.mlp_dtype)
        for layer in self.layers:
            h = layer(h)
        if self.modulate:
            h = self.modulation(t, h)
        if self.normalized:
            h = h / h.abs().sum(dim=-1, keepdim=True)
        return h
