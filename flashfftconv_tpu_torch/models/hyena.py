"""Hyena operator on the port's FFT conv (PyTorch).

Port of the JAX package's ``models/hyena.py``: input projection -> causal
short depthwise conv -> Hyena recurrence of long convolutions with implicit
filters -> output projection. The long convs run through one shared plan
per device at FFT size 2*l_max (causal: zero-padded, no circular wrap).
Dtypes follow the JAX module step by step: the filter output k stays f32
unless ``filter_output_dtype`` is set, and ``bias * v`` (f32 times the
activation dtype) promotes v to f32 for the rest of the recurrence.

The memory levers of the JAX module's 1M-base train step are here too, each
exact: ``conv_h_chunks`` (the long conv in sequential channel blocks, so the
backward's band arrays and dk spectrum cover H/chunks channels at a time),
``filter_output_dtype`` (k and the skip bias cast before the conv),
``proj_l_chunks`` (the in-projection -> short-filter segment and the
gate-multiply -> out-projection tail in L-chunks, each chunk under
``torch.utils.checkpoint`` as the JAX scan-of-remat is, with the short
filter's K-1 halo carried between chunks) and ``proj_out_f32``.

With ``seq_mesh`` (a ``DeviceMesh`` whose ``seq_axis`` dimension carries the
sequence) the operator is sequence-parallel: each rank passes its chunk
(B, L/P, D) of the sequence and gets its chunk of the output. The long conv
is ``parallel.seq_conv.seq_fft_conv_padded`` at FFT size 2*l_max, every rank
computing the full filter taps from the same weights; the short conv's
history is the previous rank's last K-1 in-projection columns
(``seq_halo``), zeros on rank 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from flashfftconv_tpu_torch.models.filters import HyenaFilter
from flashfftconv_tpu_torch.models.layers import Dense, uniform, zeros
from flashfftconv_tpu_torch.ops import dispatch
from flashfftconv_tpu_torch.ops.depthwise import depthwise_conv1d
from flashfftconv_tpu_torch.ops.plan import get_plan, resolve_device
from flashfftconv_tpu_torch.parallel.seq_conv import seq_fft_conv_padded, seq_halo
from flashfftconv_tpu_torch.utils.tracing import span


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
        if history is None:
            return depthwise_conv1d(x, self.weights, self.bias, padding=self.padding,
                                    is_bhl=True, impl=self.impl)
        # Causal conv continuing from ``history``, the last K-1 inputs of the
        # previous L-chunk: the zero-history causal conv of the chunk alone,
        # plus the cross-boundary terms of the first K-1 outputs,
        # y[t] += sum_{j < K-1-t} w[j] * history[t+j].
        k = self.weights.shape[1]
        y = depthwise_conv1d(x, self.weights, self.bias, padding=(k - 1, 0), is_bhl=True,
                             impl=self.impl)[..., : x.shape[-1]]
        w = self.weights.to(x.dtype)
        corr = torch.stack(
            [sum(w[:, j][None, :] * history[..., t + j] for j in range(k - 1 - t))
             for t in range(k - 1)], dim=-1)  # (B, D, K-1)
        return y + F.pad(corr.to(y.dtype), (0, y.shape[-1] - (k - 1)))


def _bmm_f32(a, b):
    """``a @ b`` batched, accumulated and returned in f32."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _InProjection(torch.autograd.Function):
    """``x[b] = w @ u[b].T`` from a (B, L, D) ``u`` with unit stride along D,
    as a contiguous (B, inner, L) ``x``. cuBLAS reads ``u`` transposed by its
    flags, so neither direction copies an operand or a result: ``du`` comes
    back as a contiguous (B, L, D) and ``dw`` as one sum in f32, rounded once
    to ``w``'s dtype. (``torch.matmul`` of a weight that needs a gradient
    against the (B, D, L) view folds into one (B*L, inner) ``mm`` and clones
    its transpose; its backward copies the gradient again at B > 1.)"""

    @staticmethod
    def forward(ctx, u, w):
        ctx.save_for_backward(u, w)
        return torch.bmm(w.expand(len(u), *w.shape), u.mT)

    @staticmethod
    def backward(ctx, dx):
        u, w = ctx.saved_tensors
        du = dw = None
        if ctx.needs_input_grad[0]:
            du = torch.bmm(dx.mT, w.expand(len(dx), *w.shape))
        if ctx.needs_input_grad[1]:
            dw = torch.mm(dx[0], u[0]) if len(dx) == 1 else _bmm_f32(dx, u).sum(0).to(w.dtype)
        return du, dw


def in_projection(u, w, bias=None):
    """(B, D, L) -> (B, inner, L): ``w @ u[b]`` (plus ``bias``), written
    straight from the GEMM. ``u`` is the transposed view of a (B, L, D)
    activation (or an L-slice of it); where D is not its unit-stride axis,
    one copy of ``u`` makes it so, counted by ``in_projection.fallbacks``."""
    u = u.mT
    if u.stride(-1) != 1:
        in_projection.fallbacks += 1
        u = u.contiguous()
    x = _InProjection.apply(u, w)
    if bias is not None:
        x = x + bias.to(x.dtype)[None, :, None]
    return x


in_projection.fallbacks = 0


class HyenaOperator(nn.Module):
    """Hyena recurrence of depth ``order``; forward maps (B, L, D) -> (B, L, D).

    ``impl`` routes the long conv ('auto' | 'cuda' | 'plain' | 'fft') and
    ``short_filter_impl`` the short one ('auto' | 'cuda' | 'plain').
    ``conv_h_chunks`` takes effect when it divides d_model and
    ``proj_l_chunks`` when it divides L, as in the JAX module;
    ``proj_out_f32`` acts on the chunked tail only. ``seq_mesh`` and
    ``seq_axis`` make it sequence-parallel (module docstring); ``impl`` then
    does not apply, as in the JAX module, nor ``conv_dtype``: the sequence-
    parallel conv computes in f32.
    """

    def __init__(self, d_model, l_max, order=2, filter_order=64, dropout=0.0,
                 filter_dropout=0.0, short_filter_order=3, conv_dtype=torch.bfloat16,
                 impl="auto", filter_args=None, in_proj_bias=False, seq_mesh=None,
                 seq_axis="sp", short_filter_impl=None, conv_h_chunks=0,
                 filter_output_dtype=None, proj_l_chunks=0, proj_out_f32=False,
                 device="cuda", generator=None):
        super().__init__()
        self.seq_mesh = seq_mesh
        self.seq_axis = seq_axis
        self.conv_h_chunks = conv_h_chunks
        self.filter_output_dtype = filter_output_dtype
        self.proj_l_chunks = proj_l_chunks
        self.proj_out_f32 = proj_out_f32
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

    def _conv(self, plan, v, k):
        """The long conv, in ``conv_h_chunks`` sequential channel blocks when
        that divides d_model (depthwise, so exact)."""
        if self.seq_mesh is not None:
            def conv(x, kk):
                return seq_fft_conv_padded(x, kk, self.seq_mesh, seqlen=2 * self.l_max,
                                           axis=self.seq_axis)
        else:
            def conv(x, kk):
                return dispatch.fft_conv(plan, x, kk, impl=self.impl)
        c = self.conv_h_chunks
        if not (c > 1 and self.d_model % c == 0):
            return conv(v, k)
        return torch.cat([conv(vc, kc) for vc, kc in zip(v.chunk(c, dim=1), k.chunk(c, dim=0))],
                         dim=1)

    def _in_proj(self, u):  # (B, D, L) -> (B, inner, L)
        return in_projection(u, self.in_proj.to(u.dtype), self.in_proj_b)

    def _seg_a(self, carry, u_c):
        """One L-chunk of in-projection -> short filter: the new carry (the
        chunk's last K-1 in-projection columns) and the order+1 streams."""
        with span("mixer.in_proj") as s:
            x_c = s.outputs(self._in_proj(s.inputs(u_c)))
        with span("mixer.short_conv") as s:
            x_c = s.inputs(x_c)
            y_c = s.outputs(self.short_filter(x_c, history=carry.to(x_c.dtype)))
            k1 = self.short_filter.weights.shape[1] - 1
            return (x_c[..., x_c.shape[-1] - k1:], *y_c.split(self.d_model, dim=1))

    def _seg_b(self, v_c, gate_c):
        """One L-chunk of gate-multiply -> out-projection, in the product's
        dtype (f32 with ``proj_out_f32``)."""
        with span("mixer.gate") as s:
            y_c = s.outputs(s.inputs(v_c) * gate_c)
        with span("mixer.out_proj") as s:
            y_c = s.inputs(y_c).transpose(1, 2)
            out_c = self.out_proj(y_c, dtype=y_c.dtype)
            return s.outputs(out_c.float() if self.proj_out_f32 else out_c)

    def forward(self, u):
        b, l, d = u.shape
        seq = self.seq_mesh is not None
        # under a seq mesh u is this rank's chunk of a sequence P times longer
        l_global = l * self.seq_mesh.get_group(self.seq_axis).size() if seq else l
        l_filter = min(l_global, self.l_max)
        plan = None if seq else get_plan(2 * self.l_max, self.conv_dtype, u.device)
        c = self.proj_l_chunks
        chunked = c > 1 and l % c == 0
        k1 = self.short_filter.weights.shape[1] - 1
        if chunked:
            ut = u.transpose(1, 2)  # (B, D, L)
            # The carry makes the causal conv over [carry, chunk] equal the
            # unchunked padding=(K-1, 0) conv (zero carry = the left zero pad).
            if seq:  # the previous rank's last K-1 in-projection columns
                carry = seq_halo(self._in_proj(ut[..., l - k1:]), self.seq_mesh, self.seq_axis)
            else:
                carry = torch.zeros(b, self.in_proj.shape[0], k1, dtype=u.dtype, device=u.device)
            parts = []
            for u_c in ut.chunk(c, dim=2):
                carry, *streams = checkpoint(self._seg_a, carry, u_c, use_reentrant=False)
                parts.append(streams)
            *gates, v = (torch.cat(stream, dim=2) for stream in zip(*parts))
        else:
            with span("mixer.in_proj") as s:
                x = s.outputs(self._in_proj(s.inputs(u).transpose(1, 2)))  # (B, inner, L)
            with span("mixer.short_conv") as s:
                x = s.inputs(x)
                # causal: padding (K-1, 0) then cut to l
                if seq:
                    x = self.short_filter(
                        x, history=seq_halo(x[..., l - k1:], self.seq_mesh, self.seq_axis))
                else:
                    x = self.short_filter(x)[..., :l]
                *gates, v = s.outputs(*x.split(d, dim=1))

        with span("mixer.filter") as s:
            k = self.filter(l_filter)  # (1, L, (order-1)*D), f32
            bias = self.filter.bias
            if self.filter_output_dtype is not None:
                # an f32 bias would promote bias * v to f32
                k, bias = k.to(self.filter_output_dtype), bias.to(self.filter_output_dtype)
            k = k[0].T.reshape(self.order - 1, d, l_filter)
            k, bias = s.outputs(k, bias.reshape(self.order - 1, d))
        for o, gate in enumerate(reversed(gates[1:])):
            with span("mixer.gate") as s:
                v = s.outputs(self.drop(s.inputs(v) * gate))
            with span("mixer.long_conv") as s:
                y = s.outputs(self._conv(plan, *s.inputs(v, k[o])))
            with span("mixer.gate") as s:
                v = s.outputs(s.inputs(y) + bias[o][None, :, None] * v)
        if chunked:
            return torch.cat([checkpoint(self._seg_b, v_c, g_c, use_reentrant=False)
                              for v_c, g_c in zip(v.chunk(c, dim=2), gates[0].chunk(c, dim=2))],
                             dim=1)
        with span("mixer.gate") as s:
            y = s.outputs(s.inputs(v) * gates[0])
        with span("mixer.out_proj") as s:
            return s.outputs(self.out_proj(s.inputs(y).transpose(1, 2), dtype=u.dtype))
