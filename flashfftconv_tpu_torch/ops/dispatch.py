"""Implementation dispatch for the FFT convolution.

Routes a call to an implementation:
  - 'cuda':  the hand-written kernels through ``FftConvFunction``
             (``monarch_cuda.fft_conv``): ``spectrum`` of k, then one fused
             ``direct_conv`` (FFT sizes 16 to 512) or ``monarch_conv`` (1024
             to 32768); the backward runs ``spectrum``, ``direct_conv_bwd``
             or ``monarch_conv_bwd``, and ``dk_finish``. From FFT size 65536
             up: ``long_spectrum`` of k, then ``long_conv`` (``butterfly``,
             ``long_conv_inner``, inverse ``butterfly``); the backward runs
             ``long_spectrum``, ``long_conv_bwd`` and ``long_dk_finish``.
             CUDA tensors only.
  - 'plain': ``monarch.fft_conv_plain`` under torch's autograd, on any
             device (an oracle of the Function's backward).
  - 'fft':   the ``torch.fft`` oracle (tests and debugging).
'auto' resolves to 'cuda' for CUDA tensors and to 'cpu' for CPU tensors:
the same ``FftConvFunction`` over the same wrappers, which run the kernels'
plain versions there (``monarch.conv_bwd_plain`` is its backward). Nothing
reroutes a CUDA tensor to the plain path behind the caller's back.
"""

from __future__ import annotations

import torch

from flashfftconv_tpu_torch.ops import monarch, monarch_cuda
from flashfftconv_tpu_torch.ops.plan import FftPlan

_IMPLS = ("auto", "cuda", "plain", "fft")


def resolve_impl(u: torch.Tensor, impl: str = "auto") -> str:
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    if impl == "cuda" and u.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, got {u.device}")
    if impl != "auto":
        return impl
    if u.device.type == "cuda":
        return "cuda"
    if u.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no FFT conv implementation for device {u.device}")


def fft_conv(
    plan: FftPlan,
    u: torch.Tensor,
    k: torch.Tensor,
    pregate: torch.Tensor | None = None,
    postgate: torch.Tensor | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """FFT convolution ``postgate * ifft(fft(pre*u) * fft(k)).real[..., :L]``.

    u (..., H, L <= N), k (H, k_len <= N), optional (..., H, L) gates. See
    :func:`flashfftconv_tpu_torch.ops.monarch.fft_conv_plain` for semantics.
    """
    if (pregate is None) != (postgate is None):
        raise ValueError("pregate and postgate must both be provided or both be None")
    resolved = resolve_impl(u, impl)
    if resolved == "fft":
        return monarch.fft_conv_reference(plan.seqlen, u, k, pregate, postgate)
    if resolved == "plain":
        return monarch.fft_conv_plain(plan, u, k, pregate, postgate)
    return monarch_cuda.fft_conv(plan, u, k, pregate, postgate)
