"""Hyena operator on the port's FFT conv (PyTorch).

Port of the JAX package's ``models/hyena.py`` (unchunked path): input
projection -> causal short depthwise conv -> Hyena recurrence of long
convolutions with implicit filters -> output projection. The long convs run
through one shared plan per device at FFT size 2*l_max (causal: zero-padded,
no circular wrap). Dtypes follow the JAX module step by step: the filter
output k stays f32, and ``bias * v`` (f32 times the activation dtype)
promotes v to f32 for the rest of the recurrence.
"""

from __future__ import annotations

import torch
from torch import nn

from flashfftconv_tpu_torch.models.filters import HyenaFilter
from flashfftconv_tpu_torch.models.layers import Dense, uniform, zeros
from flashfftconv_tpu_torch.ops import dispatch
from flashfftconv_tpu_torch.ops.depthwise import depthwise_conv1d
from flashfftconv_tpu_torch.ops.plan import get_plan, resolve_device


class ShortDepthwiseConv(nn.Module):
    """Learnable short depthwise conv in BHL: weights (D, K), bias (D,)."""

    def __init__(self, channels, kernel_size=3, padding=1, impl="auto", device="cuda",
                 generator=None):
        super().__init__()
        self.padding = padding
        self.impl = impl
        self.weights = uniform((channels, kernel_size), 0.0, 2.0 / channels**0.5, generator,
                               device)
        self.bias = zeros((channels,), device)

    def forward(self, x, history=None):  # x: (B, D, L)
        if history is not None:
            raise NotImplementedError("ShortDepthwiseConv(history=...) is not ported yet")
        return depthwise_conv1d(x, self.weights, self.bias, padding=self.padding, is_bhl=True,
                                impl=self.impl)


class HyenaOperator(nn.Module):
    """Hyena recurrence of depth ``order``; forward maps (B, L, D) -> (B, L, D).

    ``impl`` routes the long conv ('auto' | 'cuda' | 'plain' | 'fft') and
    ``short_filter_impl`` the short one ('auto' | 'cuda' | 'plain'). The
    JAX module's sequence-sharded, chunked and memory-lever options are not
    ported: setting one raises NotImplementedError.
    """

    def __init__(self, d_model, l_max, order=2, filter_order=64, dropout=0.0,
                 filter_dropout=0.0, short_filter_order=3, conv_dtype=torch.bfloat16,
                 impl="auto", filter_args=None, in_proj_bias=False, seq_mesh=None,
                 seq_axis="sp", short_filter_impl=None, conv_h_chunks=0,
                 filter_output_dtype=None, proj_l_chunks=0, proj_out_f32=False,
                 device="cuda", generator=None):
        super().__init__()
        for name, is_set in (
            ("seq_mesh", seq_mesh is not None),
            ("conv_h_chunks", conv_h_chunks > 1),
            ("filter_output_dtype", filter_output_dtype is not None),
            ("proj_l_chunks", proj_l_chunks > 1),
            ("proj_out_f32", bool(proj_out_f32)),
        ):
            if is_set:
                raise NotImplementedError(f"HyenaOperator({name}=...) is not ported yet")
        del seq_axis
        device = resolve_device(device)
        self.d_model = d_model
        self.l_max = l_max
        self.order = order
        self.conv_dtype = conv_dtype
        self.impl = impl
        inner = (order + 1) * d_model
        # lecun_normal over fan_in = d_model, stored (out, in) as in flax
        self.in_proj = nn.Parameter(
            (torch.randn((inner, d_model), generator=generator) / d_model**0.5).to(device)
        )
        self.in_proj_b = zeros((inner,), device) if in_proj_bias else None
        self.short_filter = ShortDepthwiseConv(
            inner, short_filter_order, padding=(short_filter_order - 1, 0),
            impl=short_filter_impl or "auto", device=device, generator=generator,
        )
        self.filter = HyenaFilter(
            d_model * (order - 1), order=filter_order, seq_len=l_max, dropout=filter_dropout,
            **(filter_args or {}), device=device, generator=generator,
        )
        self.drop = nn.Dropout(dropout)
        self.out_proj = Dense(d_model, d_model, device=device, generator=generator)

    def forward(self, u):
        b, l, d = u.shape
        l_filter = min(l, self.l_max)
        plan = get_plan(2 * self.l_max, self.conv_dtype, u.device)
        # in-projection as one (inner, D) @ (B, D, L) product: (B, inner, L)
        x = torch.matmul(self.in_proj.to(u.dtype), u.transpose(1, 2))
        if self.in_proj_b is not None:
            x = x + self.in_proj_b.to(x.dtype)[None, :, None]
        # causal: padding (K-1, 0) then cut to l
        x = self.short_filter(x)[..., :l]
        *gates, v = x.split(d, dim=1)

        k = self.filter(l_filter)  # (1, L, (order-1)*D), f32
        k = k[0].T.reshape(self.order - 1, d, l_filter)
        bias = self.filter.bias.reshape(self.order - 1, d)
        for o, gate in enumerate(reversed(gates[1:])):
            v = self.drop(v * gate)
            v = dispatch.fft_conv(plan, v, k[o], impl=self.impl) + bias[o][None, :, None] * v
        y = v * gates[0]
        return self.out_proj(y.transpose(1, 2), dtype=u.dtype)
