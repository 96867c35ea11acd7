"""H3 operator with long-conv kernels on the port's FFT conv (PyTorch).

Port of the JAX package's ``models/h3.py``:

  q, k, v = projections(u)
  k <- conv(k, k_kernel) + k_D * k            (the "shift SSM")
  y <- conv(k * v, kernel) + D * (k * v)      (the "diagonal SSM")
  out = output_linear(q * y)                  (head_dim 1; a larger
                                               head_dim sums over d1)

Both convs run through ``ops.dispatch.fft_conv`` on one shared plan per
device at FFT size 2 * l_max, with kernels of l_max taps (causal: no
circular wrap). Dtypes follow the flax module step by step: the f32
``k_D`` promotes ``k`` to f32, so the second conv runs at f32 I/O, and
``output_linear`` casts back to the input's dtype.

``LongConvKernel`` is the learnable kernel with the squash operator
relu(|k| - lam) sign(k), its ``random`` and ``double_exp`` inits, moving-
average smoothing in time (a uniform odd window) or in frequency (a
gaussian window over the rfft bins), each the centred ``mode="same"``
convolution of ``jnp.convolve``, a ``bandlimit`` and kernel dropout. The
``shift`` and ``s4d`` generators of ``models.ssm`` give the original H3's
k-projection and diagonal SSM.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from flashfftconv_tpu_torch.models.layers import Dense, normal
from flashfftconv_tpu_torch.models.ssm import S4DKernel, SSKernelShift
from flashfftconv_tpu_torch.ops import dispatch
from flashfftconv_tpu_torch.ops.plan import get_plan, resolve_device


def convolve_same(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``jnp.convolve(row, w, mode="same")`` of every row of (R, L) real
    rows with the real window w (W,): the full convolution's samples
    [(W - 1) // 2, (W - 1) // 2 + L)."""
    width = w.shape[0]
    full = F.conv1d(F.pad(rows[:, None], (width - 1, width - 1)),
                    w.flip(0).to(rows.dtype)[None, None])[:, 0]
    start = (width - 1) // 2
    return full[:, start : start + rows.shape[-1]]


class LongConvKernel(nn.Module):
    """Learnable long-conv taps (channels, H, l_max) (2 l_max when not
    causal) with the squash operator; forward() returns them squashed."""

    def __init__(self, h, l_max, channels=1, lam=0.1, causal=True, kernel_dropout=0.0,
                 weight_init="random", use_ma_smoothing=False, ma_window_len=7,
                 smooth_freq=False, bandlimit=None, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        self.length = length = l_max if causal else 2 * l_max
        self.lam = lam
        self.use_ma_smoothing = use_ma_smoothing
        self.ma_window_len = ma_window_len
        self.smooth_freq = smooth_freq
        self.bandlimit = bandlimit
        if use_ma_smoothing and not smooth_freq and ma_window_len % 2 == 0:
            raise ValueError("window size must be odd")
        shape = (channels, h, length)
        if weight_init == "random":
            self.kernel = normal(shape, 0.002, generator, device)
        elif weight_init == "double_exp":
            k = torch.randn(shape, generator=generator) * 0.02
            i = torch.arange(h, dtype=torch.float32)[:, None] / h
            j = torch.arange(length, dtype=torch.float32)[None, :] / length
            self.kernel = nn.Parameter((k * torch.exp(-j * (h / 2) ** i)[None]).to(device))
        else:
            raise NotImplementedError(f"{weight_init} is not valid")
        self.drop = nn.Dropout(kernel_dropout)

    def forward(self) -> torch.Tensor:
        k = self.kernel
        length = self.length
        if self.use_ma_smoothing:
            width = self.ma_window_len
            if self.smooth_freq:
                pos = torch.arange(width, dtype=torch.float32, device=k.device)
                w = torch.exp(-0.5 * torch.abs(pos - width // 2) ** 2)
                k_f = torch.fft.rfft(k, dim=-1)
                flat = k_f.reshape(-1, k_f.shape[-1])
                k_f = torch.complex(convolve_same(flat.real, w),
                                    convolve_same(flat.imag, w)).reshape(k_f.shape)
                k = torch.fft.irfft(k_f, n=length, dim=-1)
            else:
                w = torch.full((width,), 1.0 / width, device=k.device)
                k = convolve_same(k.reshape(-1, length), w).reshape(k.shape)
        if self.bandlimit is not None:
            n_bands = length // 2 + 1
            keep = torch.arange(n_bands, device=k.device) < self.bandlimit * n_bands
            k = torch.fft.irfft(torch.fft.rfft(k, dim=-1) * keep, n=length, dim=-1)
        k = F.relu(torch.abs(k) - self.lam) * torch.sign(k)
        return self.drop(k)


class H3Operator(nn.Module):
    """H3 sequence mixer; forward maps (B, L, d_model) -> (B, L, d_model).

    ``k_kernel_type`` is "long-conv" or "shift" (``SSKernelShift`` with
    ``d_state`` taps), ``ssm_kernel_type`` "long-conv" or "s4d"
    (``S4DKernel`` with ``d_state`` states); ``impl`` routes both convs as
    ``dispatch.fft_conv`` does. ``dropout`` is accepted and unused, as in
    the flax module."""

    def __init__(self, d_model, l_max, head_dim=1, kernel_lam=0.1, conv_dtype=torch.bfloat16,
                 impl="auto", dropout=0.0, k_kernel_type="long-conv",
                 ssm_kernel_type="long-conv", d_state=64, device="cuda", generator=None):
        super().__init__()
        del dropout
        device = resolve_device(device)
        if d_model % head_dim:
            raise ValueError(f"d_model {d_model} is no multiple of head_dim {head_dim}")
        self.d_model, self.l_max, self.head_dim = d_model, l_max, head_dim
        self.conv_dtype, self.impl = conv_dtype, impl
        n_heads = d_model // head_dim
        mk = dict(device=device, generator=generator)
        self.q_proj = Dense(d_model, d_model, **mk)
        self.k_proj = Dense(d_model, d_model, **mk)
        self.v_proj = Dense(d_model, d_model, **mk)
        if k_kernel_type == "shift":
            self.k_kernel = SSKernelShift(d_model, d_state=d_state, **mk)
        else:
            self.k_kernel = LongConvKernel(d_model, l_max, lam=kernel_lam, **mk)
        if ssm_kernel_type == "s4d":
            self.kernel = S4DKernel(d_model, n_state=d_state, **mk)
        else:
            self.kernel = LongConvKernel(d_model, l_max, lam=kernel_lam, **mk)
        self.k_D = normal((d_model,), 1.0, generator, device)
        self.D = normal((n_heads,), 1.0, generator, device)
        self.output_linear = Dense(d_model, d_model, **mk)

    def _taps(self, module) -> torch.Tensor:
        if isinstance(module, LongConvKernel):
            return module()[0]
        if isinstance(module, SSKernelShift):
            return module(self.l_max)[0]
        return module(self.l_max)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        b, l, d = u.shape
        plan = get_plan(2 * self.l_max, self.conv_dtype, u.device)

        def conv(x, kk):
            return dispatch.fft_conv(plan, x, kk, impl=self.impl)

        q, k, v = (proj(u, dtype=u.dtype).transpose(1, 2)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))  # (B, D, L)
        k_kernel, ssm_kernel = self._taps(self.k_kernel), self._taps(self.kernel)
        k = conv(k, k_kernel) + self.k_D[None, :, None] * k
        hd = self.head_dim
        if hd == 1:
            kv = k * v
            y = (conv(kv, ssm_kernel) + self.D[None, :, None] * kv) * q
        else:
            n_heads = d // hd
            kv = k.reshape(b, n_heads, hd, 1, l) * v.reshape(b, n_heads, 1, hd, l)
            ssm_rep = ssm_kernel.reshape(n_heads, hd, 1, l).expand(n_heads, hd, hd, l)
            y = conv(kv.reshape(b, n_heads * hd * hd, l), ssm_rep.reshape(-1, l))
            y = y.reshape(b, n_heads, hd, hd, l) + kv * self.D[None, :, None, None, None]
            y = (y * q.reshape(b, n_heads, hd, 1, l)).sum(dim=2).reshape(b, d, l)
        return self.output_linear(y.transpose(1, 2), dtype=u.dtype)
