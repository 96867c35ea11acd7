"""Implementation dispatch for the FFT convolution.

Routes a call to an implementation:
  - 'cuda':  the hand-written kernels (``monarch_cuda``): ``spectrum`` of k,
             then one fused ``monarch_conv``. CUDA tensors only.
  - 'plain': the plain PyTorch Monarch path (``monarch.fft_conv_plain``).
  - 'fft':   the ``torch.fft`` oracle (tests and debugging).
'auto' picks 'cuda' for CUDA tensors and 'plain' for CPU tensors. Nothing
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
        return "plain"
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
    return monarch_cuda.fft_conv_cuda(plan, u, k, pregate, postgate)
