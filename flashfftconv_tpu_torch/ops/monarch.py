"""Plain PyTorch Monarch FFT convolution: the CPU path and the kernels' oracle.

Every function here repeats, with dense per-stage matmuls on the plan's
tables, the arithmetic that the CUDA kernels in ``monarch_cuda`` do with
in-register line DFTs:

  * the real input (length N, zero-padded) is packed as a complex signal of
    length M = N/2 (even samples real, odd samples imaginary);
  * ``monarch_dft`` takes its M-point complex DFT into Monarch layout;
  * ``_split`` turns that into the half spectrum X[0..M] of the real input;
  * the product with the kernel's half spectrum is unsplit (``_unsplit``)
    and ``monarch_idft`` brings it back to time, where real and imaginary
    parts are the even and odd output samples.

From N = 65536 up (``plan.n_outer > 0``) the M-point DFT is the chain of the
long kernels, and each has its plain version here: ``butterfly_plain`` and
``butterfly_inverse_plain`` (the outer F-point DFT across the (F, R) view and
the outer twiddle; ``butterfly``), ``long_conv_inner_plain`` (per band the
R-point FFT, the split, the product with k_f and the way back;
``long_conv_inner``) and ``long_spectrum_plain`` (``long_spectrum``).
``rfft_plain`` and ``irfft_plain`` take that chain for such a plan, so every
function below them is valid at every size. The long backward has the same
stages over the same bands: ``long_conv_bwd_inner_plain``
(``long_conv_bwd_inner``) and ``long_dk_finish_plain`` (``long_dk_finish``).

Up to FFT size 512 (``plan.direct``) the conv runs as one dense DFT a row:
``direct_conv_plain`` and ``direct_conv_bwd_plain`` are the plain versions
of the ``direct_conv`` and ``direct_conv_bwd`` kernels, dense f32 products
over the L input samples and the N/2+1 frequencies with entries taken from
``plan.direct_roots`` at the exact index (f * t) mod N.

``cfft_plain`` and ``icfft_plain`` are the plan's complex M-point DFT and
its inverse in natural order (the outer stage and the bands' stages for a
long plan). ``band_conv_plain``, the plain version of the ``band_conv``
kernel, is the M-point circular conv of a general complex signal with a full
complex spectrum: the band conv of the sequence-parallel FFT conv.

All math is complex64 (f32 real and imaginary parts). ``conv_bwd_plain``
and ``dk_finish_plain`` are the backward, the CPU path's and the backward
kernels' oracle at every size. ``fft_conv_reference`` is the ``torch.fft`` oracle and
serves the tests only.
"""

from __future__ import annotations

import math

import torch

from flashfftconv_tpu_torch.ops.plan import FftPlan, kf_permute, kf_unpermute


def _along(x: torch.Tensor, axis: int, mat: torch.Tensor) -> torch.Tensor:
    """Apply ``mat`` (f, f) along ``axis`` of x: out[..k..] = sum_n mat[k, n] x[..n..]."""
    return torch.movedim(torch.movedim(x, axis, -1) @ mat.T, -1, axis)


def _twiddle_shape(plan: FftPlan, j: int, w: torch.Tensor) -> torch.Tensor:
    return w.reshape(plan.factors[j:])


def monarch_dft(plan: FftPlan, z: torch.Tensor) -> torch.Tensor:
    """Forward Monarch DFT: complex (..., M) natural -> (..., f1, ..., fm).

    Output layout: X[..., k1, ..., km] = FFT_M(z)[k1 + f1*k2 + f1*f2*k3 + ...].
    """
    factors = plan.factors
    m = len(factors)
    batch = z.shape[:-1]
    x = z.reshape(*batch, *factors)
    nb = len(batch)
    for j in range(m):
        x = _along(x, nb + j, plan.dft[j])
        if j < m - 1:
            x = x * _twiddle_shape(plan, j, plan.tw[j])
    return x


def monarch_idft(plan: FftPlan, x: torch.Tensor) -> torch.Tensor:
    """Inverse Monarch DFT: (..., f1, ..., fm) -> complex (..., M), with 1/M
    (folded into the stage-0 inverse matrix)."""
    factors = plan.factors
    m = len(factors)
    nb = x.ndim - m
    for j in range(m - 1, -1, -1):
        if j < m - 1:
            x = x * _twiddle_shape(plan, j, plan.tw[j]).conj()
        x = _along(x, nb + j, plan.idft[j])
    return x.reshape(*x.shape[:nb], math.prod(factors))


def _pack(x: torch.Tensor, n: int) -> torch.Tensor:
    """Real (..., L <= n) -> complex (..., n/2): zero-pad to n, even samples
    real, odd samples imaginary."""
    x = x.float()
    if x.shape[-1] < n:
        x = torch.nn.functional.pad(x, (0, n - x.shape[-1]))
    return torch.complex(x[..., 0::2], x[..., 1::2])


def _unpack(z: torch.Tensor) -> torch.Tensor:
    """Complex (..., M) -> real (..., 2M) interleaving real and imaginary parts."""
    return torch.stack((z.real, z.imag), dim=-1).flatten(-2)


def _split(plan: FftPlan, z_f: torch.Tensor) -> torch.Tensor:
    """Natural-order M-point spectrum Z of the packed signal -> half
    spectrum X[0..M] of the real signal: X[k] = Xe[k] + W^k Xo[k] with
    Xe = (Z[k] + conj Z[M-k]) / 2, Xo = (Z[k] - conj Z[M-k]) / 2i."""
    ze = torch.cat((z_f, z_f[..., :1]), dim=-1)  # Z[M] = Z[0]
    zr = ze.flip(-1).conj()  # conj Z[M-k]
    return 0.5 * (ze + zr) + plan.split_tw * (0.5 * (ze - zr) / 1j)


def _unsplit(plan: FftPlan, y: torch.Tensor) -> torch.Tensor:
    """Half spectrum Y[0..M] of a real signal -> natural-order M-point
    spectrum of its packed form: Ye + i*Yo with Ye = (Y[k] + conj Y[M-k]) / 2,
    Yo = (Y[k] - conj Y[M-k]) conj(W^k) / 2."""
    yr = y.flip(-1).conj()
    ye = 0.5 * (y + yr)
    yo = 0.5 * (y - yr) * plan.split_tw.conj()
    return (ye + 1j * yo)[..., :-1]


def _outer_twiddle(plan: FftPlan) -> torch.Tensor:
    """(fa, fb) twiddle between the two outer stages: exp(-2 pi i ka nb / F)."""
    fa, fb = plan.outer_factors
    dev = plan.outer_roots.device
    idx = torch.arange(fa, device=dev)[:, None] * torch.arange(fb, device=dev)[None, :]
    return plan.outer_roots[idx % plan.outer]


def _outer_dft(plan: FftPlan, z: torch.Tensor) -> torch.Tensor:
    """Complex (..., M) natural -> (..., F, R): the F-point DFT down the
    columns of the (F, R) view, in one or two stages, then the outer twiddle.
    Row k0 is band k0: the R-point DFT along it gives frequencies k0 + F*k1."""
    fs, batch = plan.outer_factors, z.shape[:-1]
    nb = len(batch)
    x = _along(z.reshape(*batch, *fs, plan.band), nb, plan.dft[0])
    if len(fs) == 2:
        x = x * _outer_twiddle(plan)[..., None]
        x = _along(x, nb + 1, plan.dft[1]).transpose(nb, nb + 1)  # (kb, ka): k0 = ka + fa*kb
    return x.reshape(*batch, plan.outer, plan.band) * plan.outer_tw


def _outer_idft(plan: FftPlan, x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_outer_dft``: (..., F, R) -> complex (..., M), with the
    1/F that the stage-0 inverse matrix carries."""
    fs, batch = plan.outer_factors, x.shape[:-2]
    nb = len(batch)
    x = x * plan.outer_tw.conj()
    if len(fs) == 2:
        x = x.reshape(*batch, fs[1], fs[0], plan.band).transpose(nb, nb + 1)
        x = _along(x, nb + 1, plan.idft[1]) * _outer_twiddle(plan).conj()[..., None]
    else:
        x = x.reshape(*batch, fs[0], plan.band)
    return _along(x, nb, plan.idft[0]).reshape(*batch, plan.inner)


def butterfly_plain(
    plan: FftPlan, x: torch.Tensor, pregate: torch.Tensor | None = None
) -> torch.Tensor:
    """The plain version of the forward ``butterfly`` kernel: real (..., L <=
    N), zero-padded and packed (even samples real, odd imaginary), through the
    outer DFT and twiddle to complex64 (..., F, R). The pregate product rounds
    to x's dtype."""
    ug = x if pregate is None else x * pregate
    return _outer_dft(plan, _pack(ug, plan.seqlen)).contiguous()


def butterfly_inverse_plain(
    plan: FftPlan,
    z: torch.Tensor,
    length: int,
    postgate: torch.Tensor | None = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The plain version of the inverse ``butterfly`` kernel: complex (..., F,
    R) through the conjugate twiddle and the inverse outer DFT (with 1/F),
    unpacked to the real samples [0, length), times the optional postgate,
    at ``dtype``."""
    y = _unpack(_outer_idft(plan, z))[..., :length]
    if postgate is not None:
        y = y * postgate.float()
    return y.to(dtype)


def _bands_to_natural(plan: FftPlan, x: torch.Tensor) -> torch.Tensor:
    """(..., F, f1, ..., fm) bands in the band plan's Monarch layout ->
    natural order (..., M): frequency k0 + F*k1 of band k0."""
    x = kf_unpermute(x, plan.sub.factors)  # (..., F, R) indexed [k0, k1]
    return x.transpose(-1, -2).reshape(*x.shape[:-2], plan.inner)


def _natural_to_bands(plan: FftPlan, x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(*x.shape[:-1], plan.band, plan.outer).transpose(-1, -2)
    return kf_permute(x, plan.sub.factors)


def long_conv_inner_plain(plan: FftPlan, z: torch.Tensor, k_f: torch.Tensor) -> torch.Tensor:
    """The plain version of the ``long_conv_inner`` kernel: for z (..., H, F,
    R) from ``butterfly`` and k_f (H, M+1), the R-point DFT of every band,
    the split to the half spectrum, the product with k_f, the unsplit and
    the inverse R-point DFT (with 1/R); complex64 (..., H, F, R)."""
    z_f = _bands_to_natural(plan, monarch_dft(plan.sub, z))
    zc = _unsplit(plan, _split(plan, z_f) * k_f)
    return monarch_idft(plan.sub, _natural_to_bands(plan, zc)).contiguous()


def long_conv_bwd_inner_plain(
    plan: FftPlan, zu: torch.Tensor, zg: torch.Tensor, k_f: torch.Tensor, need_y: bool = False
):
    """The plain version of the ``long_conv_bwd_inner`` kernel: for the bands
    zu = butterfly(u * pre) and zg = butterfly(dout * post), both (..., H, F,
    R), and k_f (H, M+1): the R-point DFT of every band of both and the split
    to the half spectra U and G; then the bands (unsplit, inverse R-point DFT
    with 1/R) of G conj(K) (du's) and, with ``need_y``, of U K (the forward's
    output, for dpost), and the dk spectrum G conj(U). Returns (du bands,
    y bands or None, partials): complex64 (..., H, F, R) and (..., H, M+1)."""
    half = lambda z: _split(plan, _bands_to_natural(plan, monarch_dft(plan.sub, z)))
    bands = lambda x: monarch_idft(plan.sub, _natural_to_bands(plan, _unsplit(plan, x)))
    u_f, g_f = half(zu), half(zg)
    du = bands(g_f * k_f.conj()).contiguous()
    y = bands(u_f * k_f).contiguous() if need_y else None
    return du, y, g_f * u_f.conj()


def long_dk_finish_plain(plan: FftPlan, partials: torch.Tensor, k_len: int) -> torch.Tensor:
    """The plain version of ``long_dk_finish``: the (B, H, M+1) partials of
    ``long_conv_bwd_inner_plain`` summed over B, unsplit, through the inverse
    R-point DFT of every band (with 1/R) and the inverse butterfly to the
    real f32 dk (H, k_len)."""
    z = monarch_idft(plan.sub, _natural_to_bands(plan, _unsplit(plan, partials.sum(0))))
    return butterfly_inverse_plain(plan, z, k_len)


def long_spectrum_plain(plan: FftPlan, k: torch.Tensor) -> torch.Tensor:
    """The plain version of the ``long_spectrum`` kernel: the half spectrum
    (..., M+1) of the real taps k (..., k_len <= N), natural order."""
    return _split(plan, _bands_to_natural(plan, monarch_dft(plan.sub, butterfly_plain(plan, k))))


def cfft_plain(plan: FftPlan, z: torch.Tensor) -> torch.Tensor:
    """Complex (..., M) -> its M-point DFT (..., M), natural order in and out
    (== torch.fft.fft(z)), through the plan's Monarch stages (the outer DFT
    and the bands' stages for a long plan)."""
    if plan.n_outer:
        return _bands_to_natural(plan, monarch_dft(plan.sub, _outer_dft(plan, z)))
    return kf_unpermute(monarch_dft(plan, z), plan.factors)


def icfft_plain(plan: FftPlan, x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``cfft_plain``, with 1/M (== torch.fft.ifft(x))."""
    if plan.n_outer:
        return _outer_idft(plan, monarch_idft(plan.sub, _natural_to_bands(plan, x)))
    return monarch_idft(plan, kf_permute(x, plan.factors))


def band_conv_plain(
    plan: FftPlan, b: torch.Tensor, k_f: torch.Tensor, conj: bool = False
) -> torch.Tensor:
    """The plain version of the ``band_conv`` kernel: for complex b (..., H,
    M) and a full complex spectrum k_f (H, M) in natural order, the M-point
    circular conv ``ifft(fft(b) * k_f)`` (``conj(k_f)`` with ``conj``), M =
    ``plan.inner``, complex64. No Hermitian symmetry is assumed: a band of
    the sequence-parallel conv is a general complex signal."""
    k_f = k_f.conj() if conj else k_f
    return icfft_plain(plan, cfft_plain(plan, b.to(torch.complex64)) * k_f)


def rfft_plain(plan: FftPlan, x: torch.Tensor) -> torch.Tensor:
    """Real (..., L <= N) -> complex64 half spectrum (..., M+1) of the
    zero-padded signal, natural order (== torch.fft.rfft(x, n=N))."""
    return _split(plan, cfft_plain(plan, _pack(x, plan.seqlen)))


def irfft_plain(plan: FftPlan, y: torch.Tensor) -> torch.Tensor:
    """Half spectrum (..., M+1) -> real f32 signal (..., N)
    (== torch.fft.irfft(y, n=N))."""
    return _unpack(icfft_plain(plan, _unsplit(plan, y)))


def kernel_spectrum(plan: FftPlan, k: torch.Tensor) -> torch.Tensor:
    """Half spectrum of the real conv kernel k (..., k_len <= N), computed in
    f32: complex64 (..., M+1), natural order."""
    return rfft_plain(plan, k)


def conv_with_spectrum(
    plan: FftPlan,
    u: torch.Tensor,
    k_f: torch.Tensor,
    pregate: torch.Tensor | None = None,
    postgate: torch.Tensor | None = None,
) -> torch.Tensor:
    """``postgate * irfft(rfft(pre*u) * k_f)[..., :L]`` for k_f (H, M+1),
    the plain version of the ``monarch_conv`` kernel. The pregate product
    rounds to u's dtype, as the kernels and the JAX package do."""
    length = u.shape[-1]
    if length > plan.seqlen:
        raise ValueError(f"input length {length} > plan seqlen {plan.seqlen}")
    ug = u if pregate is None else u * pregate
    y = irfft_plain(plan, rfft_plain(plan, ug) * k_f)[..., :length]
    if postgate is not None:
        y = y * postgate.float()
    return y.to(u.dtype)


def conv_bwd_plain(
    plan: FftPlan,
    u: torch.Tensor,
    k_f: torch.Tensor,
    pregate: torch.Tensor | None,
    postgate: torch.Tensor | None,
    dout: torch.Tensor,
):
    """The backward of ``conv_with_spectrum``, the plain version of the
    ``monarch_conv_bwd`` kernel (the formulas of the JAX package's
    ``_bwd_fused_io_tiles`` and ``_gate_finish``, on the half spectrum):

      g = dout * post (f32), ug = u * pre (rounded to u's dtype, as in the
      forward), du_inner = irfft(G conj K)[:L], y_inner = irfft(U K)[:L];
      du = du_inner * pre, dpre = du_inner * u, dpost = y_inner * dout.

    Returns (du, dpre, dpost, partials): the first three at u's dtype
    (dpre, dpost None when ungated) and the per-row dk spectrum partials
    G conj(U), complex64 (..., H, M+1), which ``dk_finish_plain`` reduces.
    """
    length = u.shape[-1]
    ug = u if pregate is None else u * pregate
    g = dout.float() if postgate is None else dout.float() * postgate.float()
    g_f = rfft_plain(plan, g)
    u_f = rfft_plain(plan, ug)
    du_inner = irfft_plain(plan, g_f * k_f.conj())[..., :length]
    partials = g_f * u_f.conj()
    if pregate is None:
        return du_inner.to(u.dtype), None, None, partials
    y_inner = irfft_plain(plan, u_f * k_f)[..., :length]
    du = (du_inner * pregate.float()).to(u.dtype)
    dpre = (du_inner * u.float()).to(u.dtype)
    dpost = (y_inner * dout.float()).to(u.dtype)
    return du, dpre, dpost, partials


def dk_finish_plain(plan: FftPlan, partials: torch.Tensor, k_len: int) -> torch.Tensor:
    """dk (H, k_len) f32 from the (B, H, M+1) partials of ``conv_bwd_plain``:
    ``irfft(sum_b partials)[:k_len]``, the plain version of ``dk_finish``."""
    return irfft_plain(plan, partials.sum(0))[..., :k_len]


def _direct_tables(plan: FftPlan, length: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The direct DFT of a real row of ``length`` <= N samples: W (L, M+1)
    complex64, W[t, f] = exp(-2 pi i f t / N), so that x @ W is rfft(x, N);
    and the inverse's real weights (2, M+1, L) f32, so that the first L
    samples of irfft(Y, N) are Y.real @ A[0] + Y.imag @ A[1]:
    A[0][f, t] = c_f cos(2 pi f t / N) / N, A[1][f, t] = -c_f sin(...) / N,
    c_f = 1 at f = 0 and M (whose imaginary parts irfft ignores), else 2."""
    if not plan.direct:
        raise ValueError(f"a plan of seqlen {plan.seqlen} is no direct plan (seqlen <= 512)")
    n, m = plan.seqlen, plan.inner
    dev = plan.direct_roots.device
    idx = (torch.arange(length, device=dev)[:, None] * torch.arange(m + 1, device=dev)) % n
    w = plan.direct_roots[idx]
    c = torch.full((m + 1,), 2.0 / n, device=dev)
    c[0] = c[m] = 1.0 / n
    inv = torch.stack((w.real.T * c[:, None], w.imag.T * c[:, None]))
    inv[1, 0] = inv[1, m] = 0.0
    return w, inv


def _direct_dft(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.complex(x @ w.real, x @ w.imag)


def _direct_idft(inv: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return y.real @ inv[0] + y.imag @ inv[1]


def direct_conv_plain(
    plan: FftPlan,
    u: torch.Tensor,
    k_f: torch.Tensor,
    pregate: torch.Tensor | None = None,
    postgate: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain version of the ``direct_conv`` kernel (the function of the
    JAX package's ``_direct_fused_io_tiles``): for a plan of seqlen <=
    DIRECT_MAX, ``postgate * irfft(rfft(pre*u, N) * k_f)[..., :L]`` as dense
    DFT products in f32, k_f (H, M+1) the natural-order half spectrum from
    ``spectrum``. The pregate product rounds to u's dtype; output at u's dtype."""
    length = u.shape[-1]
    if length > plan.seqlen:
        raise ValueError(f"input length {length} > plan seqlen {plan.seqlen}")
    w, inv = _direct_tables(plan, length)
    ug = u if pregate is None else u * pregate
    y = _direct_idft(inv, _direct_dft(w, ug.float()) * k_f)
    if postgate is not None:
        y = y * postgate.float()
    return y.to(u.dtype)


def direct_conv_bwd_plain(
    plan: FftPlan,
    u: torch.Tensor,
    k_f: torch.Tensor,
    pregate: torch.Tensor | None,
    postgate: torch.Tensor | None,
    dout: torch.Tensor,
):
    """The plain version of the ``direct_conv_bwd`` kernel (the function of
    ``_direct_bwd_fused_io_tiles``), with the formulas of ``conv_bwd_plain``
    as dense DFT products: U and G the direct DFTs of ug = u * pre (rounded to
    u's dtype) and g = dout * post (f32), du_inner from G conj(K), y_inner
    from U K when gated. Returns (du, dpre, dpost, partials) as
    ``conv_bwd_plain`` does, but with the dk spectrum G conj(U) already
    summed over the batch: complex64 (1, H, M+1), which ``dk_finish_plain``
    (and ``dk_finish``) turn into dk."""
    length = u.shape[-1]
    w, inv = _direct_tables(plan, length)
    ug = u if pregate is None else u * pregate
    g = dout.float() if postgate is None else dout.float() * postgate.float()
    u_f, g_f = _direct_dft(w, ug.float()), _direct_dft(w, g)
    du_inner = _direct_idft(inv, g_f * k_f.conj())
    partials = (g_f * u_f.conj()).reshape(-1, *k_f.shape).sum(0, keepdim=True)
    if pregate is None:
        return du_inner.to(u.dtype), None, None, partials
    y_inner = _direct_idft(inv, u_f * k_f)
    du = (du_inner * pregate.float()).to(u.dtype)
    dpre = (du_inner * u.float()).to(u.dtype)
    dpost = (y_inner * dout.float()).to(u.dtype)
    return du, dpre, dpost, partials


def fft_conv_plain(
    plan: FftPlan,
    u: torch.Tensor,
    k: torch.Tensor,
    pregate: torch.Tensor | None = None,
    postgate: torch.Tensor | None = None,
) -> torch.Tensor:
    """Monarch FFT convolution in plain PyTorch (same semantics as the JAX
    package's ``fft_conv_xla``): u (..., H, L <= N), k (H, k_len <= N),
    optional (..., H, L) gates; output at u's dtype."""
    if k.shape[-1] > plan.seqlen:
        raise ValueError(f"kernel length {k.shape[-1]} > plan seqlen {plan.seqlen}")
    return conv_with_spectrum(plan, u, kernel_spectrum(plan, k), pregate, postgate)


def fft_conv_reference(
    seqlen: int,
    u: torch.Tensor,
    k: torch.Tensor,
    pregate: torch.Tensor | None = None,
    postgate: torch.Tensor | None = None,
) -> torch.Tensor:
    """f32 ``torch.fft`` oracle (the JAX package's ``fft_conv_reference``)."""
    length = u.shape[-1]
    if pregate is not None:
        u = u * pregate
    u_f = torch.fft.fft(u.float(), n=seqlen, dim=-1)
    k_f = torch.fft.fft(k.float(), n=seqlen, dim=-1)
    out = torch.fft.ifft(u_f * k_f, n=seqlen, dim=-1).real[..., :length]
    if postgate is not None:
        out = out * postgate.float()
    return out.to(u.dtype)
