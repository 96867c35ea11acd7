"""Monarch Mixer (M2) BERT components on the port's FFT conv (PyTorch).

Port of the JAX package's ``models/m2_bert.py``:
  - ``MonarchMixerSequenceMixing``: the gated bidirectional long-conv
    sequence mixer of M2-BERT: in-projection to (x1, x2, v), a short
    depthwise conv (kernel 3, symmetric padding 1), y = conv(x1 * v, k) * x2,
    an optional residual long conv of v, and an optional inference mode in
    which the kernels are plain weights;
  - ``BlockdiagLinear``: the block-diagonal (Monarch) linear layer of the
    M2 MLP, one batched product (``blockdiag_multiply``).

The long convs run through one shared plan per device at FFT size
2 * l_max: up to l_max 256 that is the direct-DFT kernels (``direct_conv``
and its backward), the path of M2-BERT at l_max 128. Parameter names follow
the flax tree (``in_linear``, ``short_filter``, ``filter``, ``filter_rev``,
``filter2``, ``filter2_rev``, ``out_linear``) so that
``utils.jax_weights.m2_bert_state_dict`` carries flax weights over.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from flashfftconv_tpu_torch.models.filters import HyenaFilter
from flashfftconv_tpu_torch.models.hyena import ShortDepthwiseConv
from flashfftconv_tpu_torch.models.layers import Dense, normal, zeros
from flashfftconv_tpu_torch.ops import dispatch
from flashfftconv_tpu_torch.ops.plan import get_plan, resolve_device


def blockdiag_multiply(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x (..., nblocks * p) times the block-diagonal weight (nblocks, q, p)
    -> (..., nblocks * q), in x's dtype."""
    nblocks, q, p = weight.shape
    xr = x.reshape(*x.shape[:-1], nblocks, p)
    out = torch.einsum("...kp,kqp->...kq", xr, weight.to(x.dtype))
    return out.reshape(*x.shape[:-1], nblocks * q)


class BlockdiagLinear(nn.Module):
    """Block-diagonal linear layer: weight (nblocks, q, p) drawn N(0, 1) *
    sqrt(nblocks) / sqrt(in_features) (the dense layer's scale), f32 bias
    (which promotes a bf16 product to f32, as in the flax module)."""

    def __init__(self, in_features, features, nblocks=4, bias=True, device="cuda",
                 generator=None):
        super().__init__()
        if in_features % nblocks or features % nblocks:
            raise ValueError(f"in/out features ({in_features}, {features}) must divide "
                             f"nblocks={nblocks}")
        shape = (nblocks, features // nblocks, in_features // nblocks)
        self.weight = normal(shape, math.sqrt(nblocks) / math.sqrt(in_features), generator,
                             device)
        self.bias = zeros((features,), device) if bias else None

    def forward(self, x):
        y = blockdiag_multiply(x, self.weight)
        return y if self.bias is None else y + self.bias


def bidirectional_kernel(k_fwd: torch.Tensor, k_rev: torch.Tensor, length: int) -> torch.Tensor:
    """k = pad(k_fwd, (0, L)) + pad(flip(k_rev), (L, 0)): (H, L) -> (H, 2L)."""
    zeros_ = torch.zeros_like(k_fwd[..., :length])
    return torch.cat([k_fwd, zeros_], dim=-1) + torch.cat([zeros_, k_rev.flip(-1)], dim=-1)


class MonarchMixerSequenceMixing(nn.Module):
    """M2-BERT sequence mixer; forward maps (B, L, d_model) -> (B, L, d_model)."""

    def __init__(self, d_model, l_max=128, bidirectional=False, residual_long_conv=False,
                 inference_mode=False, hyena_w=10.0, hyena_w_mod=1.0, hyena_emb_dim=5,
                 hyena_filter_order=16, hyena_filter_dropout=0.0, conv_dtype=torch.bfloat16,
                 impl="auto", device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        self.d_model = d_model
        self.l_max = l_max
        self.bidirectional = bidirectional
        self.residual_long_conv = residual_long_conv
        self.inference_mode = inference_mode
        self.conv_dtype = conv_dtype
        self.impl = impl
        # lecun_normal over fan_in = d_model, (out, in) as the flax param
        self.in_linear = normal((3 * d_model, d_model), 1.0 / math.sqrt(d_model), generator,
                                device)
        self.short_filter = ShortDepthwiseConv(3 * d_model, 3, padding=1, device=device,
                                               generator=generator)
        filter_len = 2 * l_max if bidirectional else l_max
        names = ["filter"] + (["filter2"] if residual_long_conv else [])
        for name in names:
            if inference_mode:  # the kernel as a plain weight
                setattr(self, name, normal((d_model, filter_len), 1.0, generator, device))
                continue
            for suffix in ("", "_rev") if bidirectional else ("",):
                setattr(self, name + suffix, HyenaFilter(
                    d_model, emb_dim=hyena_emb_dim, order=hyena_filter_order, seq_len=l_max,
                    dropout=hyena_filter_dropout, w=hyena_w, w_mod=hyena_w_mod, device=device,
                    generator=generator))
        self.out_linear = Dense(d_model, d_model, device=device, generator=generator)

    def _kernel(self, name: str, length: int) -> torch.Tensor:
        if self.inference_mode:
            return getattr(self, name)
        k = getattr(self, name)(length)[0].T  # (d_model, L), f32
        if self.bidirectional:
            k = bidirectional_kernel(k, getattr(self, name + "_rev")(length)[0].T, length)
        return k

    def forward(self, u):
        plan = get_plan(2 * self.l_max, self.conv_dtype, u.device)
        length = u.shape[1]
        x1x2v = torch.matmul(self.in_linear.to(u.dtype), u.transpose(1, 2))  # (B, 3D, L)
        x1, x2, v = self.short_filter(x1x2v).split(self.d_model, dim=1)
        y = dispatch.fft_conv(plan, x1 * v, self._kernel("filter", length), impl=self.impl)
        y = y * x2
        if self.residual_long_conv:
            y = y + dispatch.fft_conv(plan, v, self._kernel("filter2", length), impl=self.impl)
        return self.out_linear(y.transpose(1, 2), dtype=u.dtype)
