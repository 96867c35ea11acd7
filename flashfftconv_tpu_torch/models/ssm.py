"""State-space-model conv-kernel generators (PyTorch).

Port of the JAX package's ``models/ssm.py``: modules that return the
(H, L) taps of a long convolution, which the FFT conv then consumes.

  - ``S4DKernel``: the diagonal SSM (S4D), k[h, t] = 2 Re(sum_n c_eff[h, n]
    exp(dt[h] A[h, n] t)) with c_eff = C (exp(dt A) - 1) / A, a complex64
    Vandermonde (H, n, L) from f32 parameters, as JAX computes it;
  - ``SimpleLongConvKernel``: free taps under a learnable exponential decay;
  - ``SSKernelShift``: the shift SSM, an N-tap learnable FIR;
  - ``BlockFFT``: a two-factor blocked-matmul DFT whose factor matrices may
    be learned;
  - ``hippo_transition`` and ``dplr_diag_init``: the numpy HiPPO and DPLR
    initializations (a copy of the JAX package's, in float64).

These run outside any Pallas kernel in the JAX package (``jnp.fft`` and
``einsum``), so here they are ``torch.fft``, complex64 and ``torch.einsum``.
Parameter names follow the flax modules so that ``utils.jax_weights``
carries flax weights over one to one.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from flashfftconv_tpu_torch.models.layers import normal, uniform
from flashfftconv_tpu_torch.ops.plan import resolve_device


def hippo_transition(measure: str, n: int) -> tuple[np.ndarray, np.ndarray]:
    """HiPPO (A, B) transition matrices, float64: 'legs' (scaled Legendre),
    'legt' (translated Legendre) or 'fourier'."""
    if measure == "legs":
        q = np.arange(n, dtype=np.float64)
        col, row = np.meshgrid(q, q)
        r = 2 * q + 1
        m = -(np.where(row >= col, r, 0) - np.diag(q))
        t = np.sqrt(np.diag(2 * q + 1))
        a = t @ m @ np.linalg.inv(t)
        b = np.diag(t)[:, None].copy()
    elif measure == "legt":
        q = np.arange(n, dtype=np.float64)
        r = (2 * q + 1) ** 0.5
        j, i = np.meshgrid(q, q)
        a = -(r[:, None] * np.where(i < j, (-1.0) ** (i - j), 1) * r[None, :]) * 0.5
        b = r[:, None] * 0.5
    elif measure == "fourier":
        freqs = np.arange(n // 2)
        d = np.stack([np.zeros(n // 2), freqs], axis=-1).reshape(-1)[1:]
        a = np.pi * (-np.diag(d, 1) + np.diag(d, -1))
        b = np.zeros(n)
        b[0::2] = 2**0.5
        b[0] = 1
        a = a - b[:, None] * b[None, :]
        b = b[:, None].copy()
    else:
        raise NotImplementedError(f"measure {measure!r}")
    return a.astype(np.float64), b.astype(np.float64)


def dplr_diag_init(measure: str, n: int) -> np.ndarray:
    """n // 2 complex128 eigenvalues, one a conjugate pair, for S4D:
    'lin' -1/2 + i pi k, 'inv' -1/2 + i (N/pi)(N/(2k+1) - 1), 'legs' the
    eigenvalues of the normal part of HiPPO-LegS (padded with 'lin')."""
    half = n // 2
    if measure == "lin":
        w = -0.5 + 1j * np.pi * np.arange(half)
    elif measure == "inv":
        k = np.arange(half)
        w = -0.5 + 1j * (n / np.pi) * (n / (2 * k + 1) - 1)
    elif measure == "legs":
        a, _ = hippo_transition("legs", n)
        p = np.sqrt(np.arange(n, dtype=np.float64) + 0.5)
        w_all = np.linalg.eigvals(a + p[:, None] * p[None, :])
        w_all = w_all[np.argsort(w_all.imag)]
        w = w_all[w_all.imag > 0][:half]
        if len(w) < half:
            w = np.concatenate([w, (-0.5 + 1j * np.pi * np.arange(half))[len(w):]])
    else:
        raise NotImplementedError(f"measure {measure!r}")
    return w.astype(np.complex128)


class S4DKernel(nn.Module):
    """Diagonal SSM kernel generator; forward(length) -> (H, length) f32.
    Parameters: log_dt (H,), log_A_real and A_imag (H, n), C (H, n, 2), with
    n = n_state // 2."""

    def __init__(self, h, n_state=64, dt_min=1e-3, dt_max=1e-1, measure="lin", device="cuda",
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        n = n_state // 2
        w0 = dplr_diag_init(measure, n_state)
        self.log_dt = uniform((h,), math.log(dt_min), math.log(dt_max), generator, device)
        re = np.log(np.maximum(-w0.real.astype(np.float32), np.float32(1e-4)))
        self.log_A_real = nn.Parameter(
            torch.from_numpy(np.broadcast_to(re, (h, n)).copy()).to(device))
        self.A_imag = nn.Parameter(
            torch.from_numpy(np.broadcast_to(w0.imag.astype(np.float32), (h, n)).copy())
            .to(device))
        self.C = normal((h, n, 2), 0.5**0.5, generator, device)

    def forward(self, length: int) -> torch.Tensor:
        dt = torch.exp(self.log_dt)[:, None]
        a = torch.complex(-torch.exp(self.log_A_real), self.A_imag)
        c = torch.complex(self.C[..., 0], self.C[..., 1])
        dt_a = a * dt
        c_eff = c * (torch.exp(dt_a) - 1.0) / a
        t = torch.arange(length, device=dt.device, dtype=torch.float32)
        k = torch.einsum("hn,hnl->hl", c_eff, torch.exp(dt_a[..., None] * t))
        return 2 * k.real


class SimpleLongConvKernel(nn.Module):
    """Free taps w (channels, H, length) under exp(-|decay| t / length);
    forward(length) -> (channels, H, length). The flax module sizes its
    parameters at the first call; here ``length`` is given up front."""

    def __init__(self, h, length, channels=1, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        self.length = length
        self.w = normal((channels, h, length), 1.0 / length, generator, device)
        self.decay = uniform((channels, h, 1), 0.5, 4.0, generator, device)

    def forward(self, length: int | None = None) -> torch.Tensor:
        if length not in (None, self.length):
            raise ValueError(f"built for length {self.length}, called with {length}")
        t = torch.arange(self.length, device=self.w.device, dtype=torch.float32) / self.length
        return self.w * torch.exp(-torch.abs(self.decay) * t)


class SSKernelShift(nn.Module):
    """Shift SSM: B (H, d_state) fixed at e_1 at init, C (channels, H,
    d_state); k = irfft(conj(rfft(B, 2N)) rfft(C, 2N))[..., :N], zero-padded
    to the length asked. forward(length) -> (channels, H, length)."""

    def __init__(self, h, d_state=64, channels=1, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        b = torch.zeros(h, d_state)
        b[:, 0] = 1.0
        self.B = nn.Parameter(b.to(device))
        bound = (1.0 / (channels * d_state)) ** 0.5
        self.C = uniform((channels, h, d_state), -bound, bound, generator, device)

    def forward(self, length: int) -> torch.Tensor:
        n = self.B.shape[-1]
        b_f = torch.fft.rfft(self.B, n=2 * n)
        c_f = torch.fft.rfft(self.C, n=2 * n)
        k = torch.fft.irfft(torch.conj(b_f) * c_f, n=2 * n)[..., : min(n, length)]
        if n < length:
            k = torch.nn.functional.pad(k, (0, length - n))
        return k


def _block_fft_factors(n: int) -> tuple[int, int]:
    """The JAX BlockFFT's two factors: (N / 128, 128) from 1024 to 32768,
    else the near-square split (2^ceil(m/2), 2^floor(m/2))."""
    if 512 < n <= 32768:
        return n // 128, 128
    m = n.bit_length() - 1
    return 1 << ((m + 1) // 2), 1 << (m // 2)


def _dft(n: int) -> np.ndarray:
    idx = np.arange(n, dtype=np.int64)
    return np.exp(-2j * np.pi * ((idx[:, None] * idx[None, :]) % n).astype(np.float64) / n)


class BlockFFT(nn.Module):
    """Two-factor blocked-matmul DFT of a (..., N) signal, in the Monarch
    layout (..., f1, f2): the first factor's DFT over f1, the twiddles, the
    second's over f2. With ``learn_dft`` the two DFT matrices are parameters
    (f1_re, f1_im, f2_re, f2_im) initialised to the exact DFT; otherwise
    forward gives the exact FFT. forward(x_re, x_im=None) -> (re, im)."""

    def __init__(self, n, learn_dft=True, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.n = n
        self.learn_dft = learn_dft
        f1, f2 = self.factors = _block_fft_factors(n)
        k = np.arange(f1, dtype=np.int64)[:, None]
        t = np.arange(f2, dtype=np.int64)[None, :]
        tw = np.exp(-2j * np.pi * ((k * t) % n).astype(np.float64) / n)
        planar = lambda a: (torch.from_numpy(a.real.astype(np.float32)).to(device),
                            torch.from_numpy(a.imag.astype(np.float32)).to(device))
        self.register_buffer("tw_re", planar(tw)[0], persistent=False)
        self.register_buffer("tw_im", planar(tw)[1], persistent=False)
        mats = {"f1": planar(_dft(f1)), "f2": planar(_dft(f2))}
        for name, (re, im) in mats.items():
            if learn_dft:
                setattr(self, f"{name}_re", nn.Parameter(re))
                setattr(self, f"{name}_im", nn.Parameter(im))
            else:
                self.register_buffer(f"{name}_re", re, persistent=False)
                self.register_buffer(f"{name}_im", im, persistent=False)

    def forward(self, x_re: torch.Tensor, x_im: torch.Tensor | None = None):
        f1, f2 = self.factors
        batch = x_re.shape[:-1]
        xr = x_re.reshape(*batch, f1, f2).float()
        xi = None if x_im is None else x_im.reshape(*batch, f1, f2).float()
        m1r, m1i, m2r, m2i = self.f1_re, self.f1_im, self.f2_re, self.f2_im
        rr = torch.einsum("kn,...nr->...kr", m1r, xr)
        ri = torch.einsum("kn,...nr->...kr", m1i, xr)
        if xi is not None:
            rr = rr - torch.einsum("kn,...nr->...kr", m1i, xi)
            ri = ri + torch.einsum("kn,...nr->...kr", m1r, xi)
        xr, xi = rr * self.tw_re - ri * self.tw_im, rr * self.tw_im + ri * self.tw_re
        out_re = torch.einsum("...kn,nm->...km", xr, m2r) - torch.einsum("...kn,nm->...km", xi, m2i)
        out_im = torch.einsum("...kn,nm->...km", xr, m2i) + torch.einsum("...kn,nm->...km", xi, m2r)
        return out_re, out_im
