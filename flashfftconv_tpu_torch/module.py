"""Public module API: FlashFFTConv and FlashDepthWiseConv1d as nn.Modules.

Create ONE FlashFFTConv per model for a fixed FFT size and share it across
layers; it holds the plan's DFT and twiddle tables as buffers.

    conv = FlashFFTConv(32768, dtype=torch.bfloat16)   # on "cuda" by default
    y = conv(u, k)                      # u: (B, H, L<=N), k: (H, k_len<=N)
    y = conv(u, k, pregate, postgate)   # gated variant

Any L <= N and any H are accepted. Both modules run on the card unless they
are built with ``device="cpu"``, where they run the plain versions. Both
are differentiable: their backward runs the backward kernels on the card
and the plain backward on the CPU.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from flashfftconv_tpu_torch.ops import dispatch
from flashfftconv_tpu_torch.ops.depthwise import depthwise_conv1d
from flashfftconv_tpu_torch.ops.plan import FftPlan, make_plan, resolve_device


class FlashFFTConv(nn.Module):
    """Monarch FFT convolution of FFT size ``seqlen`` (power of two,
    16..4194304). Up to 512 one dense-DFT kernel runs a conv, up to 32768
    one fused Monarch kernel; from 65536 up the chain butterfly -> band conv
    -> inverse butterfly does. Each has its backward kernels.

    Args:
      seqlen: FFT size N.
      dtype: activation dtype the plan is built for (the port computes in f32).
      device: where the tables live and the conv runs; "cuda" by default.
      impl: 'auto' | 'cuda' | 'plain' | 'fft'.
      use_32_butterfly: accepted for API parity with the reference
        constructor; the factorization comes from ``plan.default_factors``.
      remat: accepted for API parity with the JAX module (default True).
        The port's autograd Function always recomputes: it saves only (u,
        k, pregate, postgate) and recomputes k's spectrum in its backward.
    """

    def __init__(
        self,
        seqlen: int,
        dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        impl: str = "auto",
        use_32_butterfly: bool = True,
        remat: bool = True,
    ):
        super().__init__()
        del use_32_butterfly, remat
        self.seqlen = seqlen
        self.dtype = dtype
        self.impl = impl
        self._plan = make_plan(seqlen, dtype=dtype, device=resolve_device(device))
        for name, t in self._plan.tensors().items():
            self.register_buffer(name, t, persistent=False)

    @property
    def plan(self) -> FftPlan:
        """The plan over this module's (possibly moved) buffers."""
        return self._plan.with_tensors({n: getattr(self, n) for n in self._plan.tensors()})

    def forward(self, u, k, pregate=None, postgate=None):
        if (pregate is None) != (postgate is None):
            raise ValueError("pregate and postgate must be passed together")
        return dispatch.fft_conv(self.plan, u, k, pregate, postgate, impl=self.impl)


class FlashDepthWiseConv1d(nn.Module):
    """Short depthwise conv1d with the reference module's parameters.

    Layouts: is_bhl=True expects x (B, D, L) and weights (D, K); is_bhl=False
    expects x (B, L, D) and weights (K, D) (the reference stores BLH weights
    pre-transposed). ``weights``/``bias`` initialise the parameters when
    given; otherwise weights are drawn U(-1/sqrt(K), 1/sqrt(K)) from
    ``generator`` and there is no bias.
    """

    def __init__(
        self,
        channels: int,
        kernel_size: int,
        padding: int | tuple[int, int],
        weights: torch.Tensor | None = None,
        bias: torch.Tensor | None = None,
        is_bhl: bool = True,
        dtype: torch.dtype = torch.float32,
        device="cuda",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.channels = channels
        self.kernel_size = kernel_size
        self.padding = padding
        self.is_bhl = is_bhl
        shape = (channels, kernel_size) if is_bhl else (kernel_size, channels)
        if weights is None:
            bound = 1.0 / math.sqrt(kernel_size)
            weights = (torch.rand(shape, generator=generator) * 2 - 1) * bound
        if tuple(weights.shape) != shape:
            raise ValueError(f"weights shape {tuple(weights.shape)} != {shape}")
        self.weights = nn.Parameter(weights.detach().to(device=device, dtype=dtype).clone())
        if bias is not None:
            bias = nn.Parameter(bias.detach().to(device=device, dtype=dtype).clone())
        self.bias = bias

    def forward(self, x):
        return depthwise_conv1d(
            x, self.weights, self.bias, padding=self.padding, is_bhl=self.is_bhl
        )
