"""Partial and frequency-sparse FFT convolutions (PyTorch).

Port of the JAX package's ``ops/sparse.py``. Both convolve at FFT size
N = 2 L (linear convolution of the causal kernel) and return (..., L).

``partial_fft_conv`` truncates the kernel to its first ``n_partial`` taps.
With a plan it runs ``ops.dispatch.fft_conv``: on CUDA tensors the
hand-written kernels (``spectrum``, then ``direct_conv`` up to FFT size 512
or ``monarch_conv`` above), on CPU tensors their plain versions. Without a
plan, and in ``frequency_sparse_fft_conv``, the JAX package computes with
``jnp.fft`` outside any Pallas kernel; ``torch.fft`` is the port of that,
in f32, with the result cast back to x's dtype.
"""

from __future__ import annotations

import torch

from flashfftconv_tpu_torch.ops import dispatch
from flashfftconv_tpu_torch.ops.plan import FftPlan


def _fft_conv_2l(x: torch.Tensor, k_f: torch.Tensor) -> torch.Tensor:
    length = x.shape[-1]
    n = 2 * length
    x_f = torch.fft.rfft(x.float(), n=n, dim=-1)
    return torch.fft.irfft(x_f * k_f, n=n, dim=-1)[..., :length].to(x.dtype)


def partial_fft_conv(x: torch.Tensor, k: torch.Tensor, n_partial: int,
                     plan: FftPlan | None = None, impl: str = "auto") -> torch.Tensor:
    """x (..., H, L) convolved with k (H, k_len) truncated to its first
    ``n_partial`` taps, at FFT size 2 L (the plan's size when given),
    output (..., H, L) in x's dtype. ``impl`` is ``dispatch.fft_conv``'s
    and applies with a plan only."""
    k = k[..., :n_partial]
    if plan is not None:
        return dispatch.fft_conv(plan, x, k, impl=impl)
    return _fft_conv_2l(x, torch.fft.rfft(k.float(), n=2 * x.shape[-1], dim=-1))


def frequency_sparse_fft_conv(x: torch.Tensor, k: torch.Tensor, n_partial: int) -> torch.Tensor:
    """x (..., H, L) convolved at FFT size 2 L with k (H, k_len) whose rfft
    bins from ``n_partial // 2`` up are zeroed; output in x's dtype."""
    k_f = torch.fft.rfft(k.float(), n=2 * x.shape[-1], dim=-1)
    keep = torch.arange(k_f.shape[-1], device=k_f.device) < n_partial // 2
    return _fft_conv_2l(x, torch.where(keep, k_f, 0))


class PartialFFTConv:
    """``partial_fft_conv`` with ``n_partial`` and the plan fixed: call with
    (x, k)."""

    def __init__(self, n_partial: int, plan: FftPlan | None = None):
        self.n_partial = n_partial
        self.plan = plan

    def __call__(self, x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        return partial_fft_conv(x, k, self.n_partial, plan=self.plan)


class FrequencySparseFFTConv:
    """``frequency_sparse_fft_conv`` with ``n_partial`` fixed: call with (x, k)."""

    def __init__(self, n_partial: int):
        self.n_partial = n_partial

    def __call__(self, x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        return frequency_sparse_fft_conv(x, k, self.n_partial)
