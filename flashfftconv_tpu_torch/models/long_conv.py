"""Long Conv sequence model on the port's FFT conv (PyTorch).

Port of the JAX package's ``models/long_conv.py``:

  - ``LongConv``: a learned kernel of 2 * l_max taps, as long as the FFT,
    under the squash operator relu(|k| - lam) sign(k) and kernel dropout;
    the FFT conv at size 2 * l_max (the taps past L reach the output by the
    circular wrap, as in the flax layer); the D skip; GELU (flax's tanh
    form); dropout; and a Linear(C*H -> 2H) with a GLU over the channels.
    The flax layer wraps the conv in ``jax.checkpoint``, a memory lever with
    the same numbers; the port's ``FftConvFunction`` already keeps only its
    inputs and recomputes the kernel's spectrum in the backward, so nothing
    wraps it here;
  - ``LongConvModel``: a linear encoder, n_layers residual blocks (post-norm,
    or pre-norm with ``prenorm``) with the LayerNorm over channels through
    two swaps, a mean pool (masked by ``mask`` when given) and a linear
    decoder;
  - ``LongConvOperator``: ``LongConv`` as a (B, L, D) sequence mixer for
    ``lm.Block`` and ``SequenceModel``.

With ``seq_mesh`` (a ``DeviceMesh`` whose ``seq_axis`` dimension carries
the sequence) the conv is ``parallel.seq_conv.seq_fft_conv_padded`` at
FFT size 2 * l_max: each rank passes its chunk of the sequence and the
full kernel; the sequence-parallel conv computes in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from flashfftconv_tpu_torch.models.layers import Dense, LayerNorm, normal
from flashfftconv_tpu_torch.ops import dispatch
from flashfftconv_tpu_torch.ops.plan import get_plan, resolve_device
from flashfftconv_tpu_torch.parallel.comm import gather_from, scatter_to
from flashfftconv_tpu_torch.parallel.seq_conv import seq_fft_conv_padded


class LongConv(nn.Module):
    """Long convolution layer; forward maps u (B, H, L) -> (B, H, L)."""

    def __init__(self, h, l_max, channels=1, dropout=0.1, kernel_lam=0.1, kernel_dropout=0.0,
                 conv_dtype=torch.bfloat16, impl="auto", seq_mesh=None, seq_axis="sp",
                 device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        self.h, self.l_max, self.channels = h, l_max, channels
        self.kernel_lam = kernel_lam
        self.conv_dtype, self.impl = conv_dtype, impl
        self.seq_mesh, self.seq_axis = seq_mesh, seq_axis
        self.kernel = normal((channels, h, 2 * l_max), 0.002, generator, device)
        self.D = normal((channels, h), 1.0, generator, device)
        self.kernel_drop = nn.Dropout(kernel_dropout)
        self.drop = nn.Dropout(dropout)
        self.output_linear = Dense(channels * h, 2 * h, device=device, generator=generator)
        # the process group over which parallel.mesh.shard_parameters split
        # kernel and D on their channels, or None
        self.tp = None

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        b, _, length = u.shape
        seqlen = 2 * self.l_max
        k = F.relu(torch.abs(self.kernel) - self.kernel_lam) * torch.sign(self.kernel)
        k = self.kernel_drop(k)
        if self.tp is not None:  # this rank's channels of u, as those of kernel and D
            u = scatter_to(u, 1, self.tp)
        if self.seq_mesh is not None:
            y = seq_fft_conv_padded(u, k[0], self.seq_mesh, seqlen=seqlen, axis=self.seq_axis)
        else:
            plan = get_plan(seqlen, self.conv_dtype, u.device)
            y = dispatch.fft_conv(plan, u, k[0], impl=self.impl)  # channel 0, as the flax layer
        y = y[:, None] + torch.einsum("bhl,ch->bchl", u.float(), self.D).to(y.dtype)
        if self.tp is not None:
            y = gather_from(y, 2, self.tp)
        y = y.reshape(b, self.channels * self.h, length)
        y = self.drop(F.gelu(y.float(), approximate="tanh").to(u.dtype))
        y = self.output_linear(y.transpose(-1, -2), dtype=u.dtype)  # (B, L, 2H)
        return F.glu(y, dim=-1).transpose(-1, -2)


class LongConvModel(nn.Module):
    """Residual stack of LongConv blocks for sequence classification;
    forward(x (B, L, d_input), mask=None) -> (B, d_output) f32 logits. A
    ``mask`` (B, L) of valid positions makes the pool a masked mean."""

    def __init__(self, d_input, d_output=10, d_model=512, n_layers=6, dropout=0.1,
                 prenorm=False, kernel_lam=0.1, kernel_dropout=0.0, channels=1, l_max=1024,
                 conv_dtype=torch.bfloat16, impl="auto", seq_mesh=None, seq_axis="sp",
                 device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        self.prenorm = prenorm
        self.encoder = Dense(d_input, d_model, device=device, generator=generator)
        # ModuleLists named as the flax modules' prefixes: layer_i, norm_i
        self.layer = nn.ModuleList(
            LongConv(d_model, l_max, channels=channels, dropout=dropout, kernel_lam=kernel_lam,
                     kernel_dropout=kernel_dropout, conv_dtype=conv_dtype, impl=impl,
                     seq_mesh=seq_mesh, seq_axis=seq_axis, device=device, generator=generator)
            for _ in range(n_layers))
        self.norm = nn.ModuleList(LayerNorm(d_model, device=device) for _ in range(n_layers))
        self.drop = nn.Dropout(dropout)
        self.decoder = Dense(d_model, d_output, dtype=torch.float32, device=device,
                             generator=generator)

    @staticmethod
    def _norm_channels(norm, x):
        """LayerNorm over the channels of (B, D, L), in f32, as two swaps."""
        return norm(x.transpose(-1, -2).float()).transpose(-1, -2)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        x = self.encoder(x, dtype=x.dtype).transpose(-1, -2)  # (B, d_model, L)
        for layer, norm in zip(self.layer, self.norm):
            z = self._norm_channels(norm, x).to(x.dtype) if self.prenorm else x
            z = self.drop(layer(z))
            x = z + x
            if not self.prenorm:
                x = self._norm_channels(norm, x).to(z.dtype)
        x = x.transpose(-1, -2)  # (B, L, d_model)
        if mask is not None:
            m = mask.float()[..., None]
            x = (x.float() * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
        else:
            x = x.mean(dim=1)
        return self.decoder(x)


class LongConvOperator(nn.Module):
    """LongConv as a (B, L, D) -> (B, L, D) mixer (``mixer="long-conv"``)."""

    def __init__(self, d_model, l_max, lam=0.003, dropout=0.0, conv_dtype=torch.bfloat16,
                 impl="auto", seq_mesh=None, seq_axis="sp", device="cuda", generator=None):
        super().__init__()
        self.conv = LongConv(d_model, l_max, dropout=dropout, kernel_lam=lam,
                             conv_dtype=conv_dtype, impl=impl, seq_mesh=seq_mesh,
                             seq_axis=seq_axis, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.transpose(-1, -2)).transpose(-1, -2)
