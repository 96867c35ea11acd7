"""Wrappers of the FFT-conv kernels and the autograd Function over them.

``spectrum`` (csrc/spectrum.cu) replaces the TPU kernel ``_spectrum_tiles``,
``monarch_conv`` (csrc/monarch_conv.cu) replaces ``_conv_fused_io_tiles``
and ``monarch_conv_bwd`` (csrc/monarch_conv_bwd.cu) replaces
``_bwd_fused_io_tiles`` (flashfftconv_tpu/ops/monarch_pallas.py).
``spectrum``, ``monarch_conv`` and ``monarch_conv_bwd`` are instantiated
per FFT size on the in-register row FFT of csrc/row_fft.cuh, and their C
entries (``ffc_spectrum``, ``ffc_monarch_conv(u, pre, post, k_f, out,
split_tw, batch, channels, length, n, dtype, stream)``,
``ffc_monarch_conv_bwd``) take the FFT size and the plan's ``split_tw``
alone; ``monarch_conv`` moves u, the output and the f32 spectrum once
(bytes: about 45 us at B=4, H=768, L=8192, N=16384, bf16 on an H100) and
does two FFTs a row (about 64 us of f32 operations there);
``monarch_conv_bwd`` does three and sums the dk spectra of ``bwd_group(B)``
rows of a channel inside a thread block cluster, so that it leaves
B / ``bwd_group(B)`` partials; ``dk_finish``, in the same source, is the
card's counterpart of the JAX package's ``_finish_dk``. On a CUDA tensor
each wrapper checks its inputs, allocates its outputs with ``torch.empty``,
launches its kernel on the current stream, raises if the launch failed,
and adds one to its ``launches`` count. On a CPU tensor it runs the plain
version from ``ops/monarch.py`` instead; on any other device it raises.

From FFT size 65536 up (a plan with an outer part) no block holds a row, and
three more kernels take over: ``butterfly`` (csrc/butterfly.cu) replaces
``_butterfly_tiles``, ``long_conv_inner`` (csrc/long_conv.cu) replaces
``_long_tiles`` in its complex-I/O contract, and ``long_spectrum``
(csrc/long_spectrum.cu: the band FFTs and split, stored band by band, then
a transpose to natural order; one launch count a call) replaces
``_fwd_dft_tiles``. ``long_conv`` is
``_long_tiles``' real-I/O contract as the chain forward butterfly -> band
conv -> inverse butterfly over complex64 bands in device memory; it owns no
kernel and no count of its own.

The backward at these sizes has two more: ``long_conv_bwd_inner``
(csrc/long_conv_bwd.cu) replaces ``_long_bwd_tiles`` between the butterfly
passes, and ``long_dk_finish``, in the same source, replaces
``_inv_dft_tiles`` as ``_finish_dk`` drives it. ``long_conv_bwd`` is the
chain forward butterfly of u * pre and of dout * post -> band backward ->
inverse butterfly of du (and of y when gated), with no kernel and no count
of its own.

Up to FFT size 512 (``plan.direct``) a conv's forward is one dense DFT a
row: ``direct_conv`` (csrc/direct_conv.cu) replaces
``_direct_fused_io_tiles``. ``direct_conv_bwd`` replaces
``_direct_bwd_fused_io_tiles`` with the row-FFT backward of
csrc/monarch_conv_bwd.cu (its instances for N = 16 ... 512, through the same
C entry ``ffc_monarch_conv_bwd``), so that its dk spectrum comes in the same
(B / ``bwd_group(B)``, H, M+1) partials for ``dk_finish``; the launches count
on ``direct_conv_bwd``.

A plan whose band exceeds ``MAX_BWD_BAND`` (a custom split with R = 8192)
runs its long backward under ``bwd_plan(plan)``, the default plan of the
same size, as the JAX package's ``_bwd_plan`` lets a backward run under
factors of its own: k_f and the dk partials are in natural order, so the
function is the same.

``band_conv`` (csrc/band_conv.cu) replaces ``_conv_tiles`` in its complex
contract: the complex band conv ``ifft(fft(b) * k_f)`` of the
sequence-parallel FFT conv (``parallel/seq_conv.py``) for bands of 16 to
16384 points, with a ``conj`` flag for its backward, instantiated per band
length on the row FFT of csrc/row_fft.cuh (C entry ``ffc_band_conv(b, k_f,
out, split_tw, batch, channels, n2, conj, stream)``, ``split_tw`` that of
the plan of FFT size 2 N2); ``BandConvFunction`` is its autograd Function.

``FftConvFunction`` runs ``spectrum`` and then ``direct_conv`` up to 512,
``monarch_conv`` up to 32768, and ``long_spectrum`` and ``long_conv`` from
65536 up; in its backward it recomputes the spectrum and runs
``direct_conv_bwd``, ``monarch_conv_bwd`` or ``long_conv_bwd``, then
``dk_finish`` (``long_dk_finish`` from 65536 up). ``monarch_conv`` and
``monarch_conv_bwd`` stay callable at every size up to 32768. The Function
saves only (u, k, pregate, postgate), as the JAX package's custom VJP does.
"""

from __future__ import annotations

import torch

from flashfftconv_tpu_torch.ops import _build, monarch
from flashfftconv_tpu_torch.ops.monarch import bwd_group
from flashfftconv_tpu_torch.ops.plan import (
    DIRECT_MAX,
    MAX_FACTOR,
    MAX_FUSED_SEQLEN,
    FftPlan,
    get_plan,
)

# Longest band of the long backward kernel: it holds the band pairs of two
# signals, four rows, in one block's shared memory (128 KB at 4096).
MAX_BWD_BAND = 4096
# Longest band of the band_conv kernel: one row of N2 complex points in one
# block's shared memory (its largest instance in csrc/band_conv.cu).
BAND_CONV_MAX = 16384

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def on_cpu(*tensors: torch.Tensor | None) -> bool:
    """True if every tensor lies on the CPU; raise on a device that is
    neither the CPU nor CUDA."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs <= {"cpu"}:
        return True
    if devs != {"cuda"}:
        raise ValueError(f"tensors must all be on the CPU or all on CUDA, got {sorted(devs)}")
    return False


def _check_cuda(name: str, t: torch.Tensor, device: torch.device, dtypes, ndim: int) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the plan on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {sorted(map(str, dtypes))}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _factor_args(plan: FftPlan) -> list[int]:
    if plan.n_outer:
        raise ValueError(
            f"a plan of seqlen {plan.seqlen} has an outer part: the one-block kernels stop at "
            f"{MAX_FUSED_SEQLEN}; use long_spectrum and long_conv"
        )
    if any(f > MAX_FACTOR for f in plan.factors) or len(plan.factors) > 4:
        raise ValueError(f"plan factors {plan.factors} not supported by the kernels")
    return [len(plan.factors), *plan.factors, *([1] * (4 - len(plan.factors)))]


def _require_long(plan: FftPlan) -> None:
    """Raise unless ``plan`` has an outer part (the long kernels' plans)."""
    if not plan.n_outer:
        raise ValueError(
            f"a plan of seqlen {plan.seqlen} has no outer part: the long kernels start at "
            f"{2 * MAX_FUSED_SEQLEN}; use spectrum and monarch_conv"
        )


def _stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an int, for the C launchers.
    The raw query: ``current_stream(device).cuda_stream`` builds a Stream
    object on every call, a host cost that bounded small launches."""
    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def spectrum(plan: FftPlan, k: torch.Tensor) -> torch.Tensor:
    """Half spectrum (H, M+1) complex64 of real f32 taps k (H, k_len <= N).
    The kernel is instantiated per FFT size and needs only the plan's
    ``split_tw`` (its root table); the plan's factors do not enter."""
    if on_cpu(k):
        return monarch.kernel_spectrum(plan, k)
    _check_cuda("k", k, plan.device, (torch.float32,), 2)
    if plan.n_outer:
        raise ValueError(
            f"a plan of seqlen {plan.seqlen} has an outer part: spectrum stops at "
            f"{MAX_FUSED_SEQLEN}; use long_spectrum"
        )
    h, k_len = k.shape
    if not 1 <= k_len <= plan.seqlen:
        raise ValueError(f"kernel length {k_len} not in [1, {plan.seqlen}]")
    out = torch.empty(h, plan.inner + 1, dtype=torch.complex64, device=k.device)
    if h == 0:
        return out
    lib = _build.load("spectrum")
    rc = lib.ffc_spectrum(k.data_ptr(), out.data_ptr(), plan.split_tw.data_ptr(), h, k_len,
                          plan.seqlen, _stream(k.device))
    _build.check(lib, rc, "spectrum kernel")
    spectrum.launches += 1
    return out


spectrum.launches = 0


def _check_gates(plan: FftPlan, u: torch.Tensor, *gates: torch.Tensor | None) -> None:
    for name, g in zip(("pregate", "postgate", "dout"), gates):
        if g is not None:
            _check_cuda(name, g, plan.device, (u.dtype,), 3)
            if g.shape != u.shape:
                raise ValueError(f"{name} shape {tuple(g.shape)} != u shape {tuple(u.shape)}")


def monarch_conv(
    plan: FftPlan,
    u: torch.Tensor,
    k_f: torch.Tensor,
    pregate: torch.Tensor | None = None,
    postgate: torch.Tensor | None = None,
) -> torch.Tensor:
    """``postgate * irfft(rfft(pre*u, N) * k_f)[..., :L]`` for u (B, H, L <= N)
    in f32 or bf16, k_f (H, M+1) complex64 from ``spectrum``, and optional
    gates (B, H, L) at u's dtype. Output (B, H, L) at u's dtype. The kernel
    is instantiated per FFT size (16 ... 32768), dtype and gating, and needs
    only the plan's ``split_tw`` (its root table); the plan's factors do not
    enter."""
    if (pregate is None) != (postgate is None):
        raise ValueError("pregate and postgate must both be given or both be None")
    if on_cpu(u, k_f, pregate, postgate):
        return monarch.conv_with_spectrum(plan, u, k_f, pregate, postgate)
    _check_cuda("u", u, plan.device, tuple(_DTYPE_CODES), 3)
    b, h, length = u.shape
    _check_cuda("k_f", k_f, plan.device, (torch.complex64,), 2)
    if k_f.shape != (h, plan.inner + 1):
        raise ValueError(f"k_f shape {tuple(k_f.shape)} != {(h, plan.inner + 1)}")
    _check_gates(plan, u, pregate, postgate)
    if not 1 <= length <= plan.seqlen:
        raise ValueError(f"input length {length} not in [1, {plan.seqlen}]")
    out = torch.empty_like(u)
    if b * h == 0:
        return out
    if plan.n_outer:
        raise ValueError(
            f"a plan of seqlen {plan.seqlen} has an outer part: monarch_conv stops at "
            f"{MAX_FUSED_SEQLEN}; use long_spectrum and long_conv"
        )
    lib = _build.load("monarch_conv")
    rc = lib.ffc_monarch_conv(
        u.data_ptr(),
        None if pregate is None else pregate.data_ptr(),
        None if postgate is None else postgate.data_ptr(),
        k_f.data_ptr(), out.data_ptr(), plan.split_tw.data_ptr(),
        b, h, length, plan.seqlen, _DTYPE_CODES[u.dtype], _stream(u.device),
    )
    _build.check(lib, rc, "monarch_conv kernel")
    monarch_conv.launches += 1
    return out


monarch_conv.launches = 0


def monarch_conv_bwd(
    plan: FftPlan,
    u: torch.Tensor,
    k_f: torch.Tensor,
    pregate: torch.Tensor | None,
    postgate: torch.Tensor | None,
    dout: torch.Tensor,
):
    """The backward of ``monarch_conv`` for u (B, H, L <= N) in f32 or bf16,
    k_f (H, M+1) complex64, optional gates and dout (B, H, L) at u's dtype.
    Returns (du, dpre, dpost, partials): du, dpre and dpost at u's dtype
    (dpre, dpost None when ungated) and the dk spectrum partials, complex64
    (B / c, H, M+1) with c = ``bwd_group(B)``, whose sum over dim 0, in
    order, is dk's spectrum, for ``dk_finish``: partial g sums the rows'
    G conj(U) over b = g c ... g c + c - 1 in b order, inside the thread
    block cluster that runs them. The kernel is instantiated per FFT size
    (16 ... 32768), dtype and gating and needs only the plan's ``split_tw``;
    it parks one spectrum a row in a (B, H, M+1) scratch."""
    if (pregate is None) != (postgate is None):
        raise ValueError("pregate and postgate must both be given or both be None")
    if on_cpu(u, k_f, pregate, postgate, dout):
        return monarch.conv_bwd_plain(plan, u, k_f, pregate, postgate, dout)
    _check_cuda("u", u, plan.device, tuple(_DTYPE_CODES), 3)
    b, h, length = u.shape
    _check_cuda("k_f", k_f, plan.device, (torch.complex64,), 2)
    if k_f.shape != (h, plan.inner + 1):
        raise ValueError(f"k_f shape {tuple(k_f.shape)} != {(h, plan.inner + 1)}")
    _check_gates(plan, u, pregate, postgate, dout)
    if not 1 <= length <= plan.seqlen:
        raise ValueError(f"input length {length} not in [1, {plan.seqlen}]")
    if plan.n_outer:
        raise ValueError(
            f"a plan of seqlen {plan.seqlen} has an outer part: monarch_conv_bwd stops at "
            f"{MAX_FUSED_SEQLEN}; use long_conv_bwd"
        )
    return _row_fft_bwd(plan, u, k_f, pregate, postgate, dout, monarch_conv_bwd)


monarch_conv_bwd.launches = 0


def _row_fft_bwd(plan, u, k_f, pregate, postgate, dout, wrapper):
    """Launch the row-FFT backward (``ffc_monarch_conv_bwd``) on checked
    inputs for ``wrapper`` (``monarch_conv_bwd`` or ``direct_conv_bwd``) and
    add one to its count. Returns (du, dpre, dpost, partials), the partials
    (B / ``bwd_group(B)``, H, M+1)."""
    b, h, length = u.shape
    gated = pregate is not None
    group = bwd_group(b)
    du = torch.empty_like(u)
    dpre = torch.empty_like(u) if gated else None
    dpost = torch.empty_like(u) if gated else None
    partials = torch.empty(b // group, h, plan.inner + 1, dtype=torch.complex64, device=u.device)
    if b * h == 0:
        return du, dpre, dpost, partials
    park = torch.empty(b, h, plan.inner + 1, dtype=torch.complex64, device=u.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.load("monarch_conv_bwd")
    rc = lib.ffc_monarch_conv_bwd(
        u.data_ptr(), ptr(pregate), ptr(postgate), dout.data_ptr(), k_f.data_ptr(),
        du.data_ptr(), ptr(dpre), ptr(dpost), park.data_ptr(), partials.data_ptr(),
        plan.split_tw.data_ptr(), b, h, length, plan.seqlen, group, _DTYPE_CODES[u.dtype],
        _stream(u.device),
    )
    _build.check(lib, rc, f"{wrapper.__name__} kernel")
    wrapper.launches += 1
    return du, dpre, dpost, partials


def dk_finish(plan: FftPlan, partials: torch.Tensor, k_len: int) -> torch.Tensor:
    """dk (H, k_len) f32 = irfft(sum_g partials)[:k_len] for the (G, H, M+1)
    complex64 partials of ``monarch_conv_bwd`` or ``direct_conv_bwd`` (G = B /
    ``bwd_group(B)``), summed over G in order."""
    if on_cpu(partials):
        return monarch.dk_finish_plain(plan, partials, k_len)
    _check_cuda("partials", partials, plan.device, (torch.complex64,), 3)
    b, h, m1 = partials.shape
    if m1 != plan.inner + 1:
        raise ValueError(f"partials shape {tuple(partials.shape)} != (G, H, {plan.inner + 1})")
    if not 1 <= k_len <= plan.seqlen:
        raise ValueError(f"kernel length {k_len} not in [1, {plan.seqlen}]")
    dk = torch.empty(h, k_len, dtype=torch.float32, device=partials.device)
    if h == 0:
        return dk
    if b == 0:
        return dk.zero_()
    lib = _build.load("monarch_conv_bwd")
    rc = lib.ffc_dk_finish(
        partials.data_ptr(), dk.data_ptr(), plan.tw_flat.data_ptr(), plan.split_tw.data_ptr(),
        plan.roots.data_ptr(), b, h, k_len, *_factor_args(plan), _stream(partials.device),
    )
    _build.check(lib, rc, "dk_finish kernel")
    dk_finish.launches += 1
    return dk


dk_finish.launches = 0


def _require_direct(plan: FftPlan) -> None:
    if not plan.direct:
        raise ValueError(
            f"a plan of seqlen {plan.seqlen} is no direct plan: the direct kernels take FFT "
            f"sizes up to {DIRECT_MAX}"
        )


def _check_direct(plan: FftPlan, u: torch.Tensor, k_f: torch.Tensor, *gates) -> None:
    _require_direct(plan)
    _check_cuda("u", u, plan.device, tuple(_DTYPE_CODES), 3)
    _check_cuda("k_f", k_f, plan.device, (torch.complex64,), 2)
    if k_f.shape != (u.shape[1], plan.inner + 1):
        raise ValueError(f"k_f shape {tuple(k_f.shape)} != {(u.shape[1], plan.inner + 1)}")
    _check_gates(plan, u, *gates)
    if not 1 <= u.shape[-1] <= plan.seqlen:
        raise ValueError(f"input length {u.shape[-1]} not in [1, {plan.seqlen}]")


def direct_conv(
    plan: FftPlan,
    u: torch.Tensor,
    k_f: torch.Tensor,
    pregate: torch.Tensor | None = None,
    postgate: torch.Tensor | None = None,
) -> torch.Tensor:
    """``monarch_conv`` for a plan of seqlen <= DIRECT_MAX, as one dense DFT a
    row: ``postgate * irfft(rfft(pre*u, N) * k_f)[..., :L]`` for u (B, H, L
    <= N) in f32 or bf16, k_f (H, M+1) complex64 from ``spectrum`` and
    optional gates (B, H, L) at u's dtype. Output (B, H, L) at u's dtype."""
    if (pregate is None) != (postgate is None):
        raise ValueError("pregate and postgate must both be given or both be None")
    if on_cpu(u, k_f, pregate, postgate):
        return monarch.direct_conv_plain(plan, u, k_f, pregate, postgate)
    _check_direct(plan, u, k_f, pregate, postgate)
    b, h, length = u.shape
    out = torch.empty_like(u)
    if b * h == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.load("direct_conv")
    rc = lib.ffc_direct_conv(
        u.data_ptr(), ptr(pregate), ptr(postgate), k_f.data_ptr(), out.data_ptr(),
        plan.direct_tf32.data_ptr(), b, h, length, plan.seqlen, _DTYPE_CODES[u.dtype],
        _stream(u.device),
    )
    _build.check(lib, rc, "direct_conv kernel")
    direct_conv.launches += 1
    return out


direct_conv.launches = 0


def direct_conv_bwd(
    plan: FftPlan,
    u: torch.Tensor,
    k_f: torch.Tensor,
    pregate: torch.Tensor | None,
    postgate: torch.Tensor | None,
    dout: torch.Tensor,
):
    """The backward of ``direct_conv``, same inputs and outputs as
    ``monarch_conv_bwd``: (du, dpre, dpost, partials), the dk spectrum in
    (B / ``bwd_group(B)``, H, M+1) partials for ``dk_finish``. On the card it
    launches the row-FFT backward of csrc/monarch_conv_bwd.cu (its
    instances for N = 16 ... 512) through the same C entry, counted here;
    on the CPU it runs that kernel's plain version, ``conv_bwd_plain``."""
    if (pregate is None) != (postgate is None):
        raise ValueError("pregate and postgate must both be given or both be None")
    _require_direct(plan)
    if on_cpu(u, k_f, pregate, postgate, dout):
        return monarch.conv_bwd_plain(plan, u, k_f, pregate, postgate, dout)
    _check_direct(plan, u, k_f, pregate, postgate, dout)
    return _row_fft_bwd(plan, u, k_f, pregate, postgate, dout, direct_conv_bwd)


direct_conv_bwd.launches = 0


def butterfly(
    plan: FftPlan,
    x: torch.Tensor,
    gate: torch.Tensor | None = None,
    inverse: bool = False,
    length: int | None = None,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """The outer stage of a long plan (seqlen >= 65536).

    Forward: real x (B, H, L <= N) in f32 or bf16, zero-padded, times the
    optional pregate ``gate`` (B, H, L), packed and taken through the outer
    F-point DFT and twiddle: complex64 bands (B, H, F, R). Inverse: complex64
    x (B, H, F, R) back through the conjugate twiddle and the inverse outer
    DFT (with 1/F) to the real samples [0, ``length``), times the optional
    postgate ``gate`` (B, H, length), at ``dtype`` (f32 or bf16)."""
    _require_long(plan)
    if not inverse:
        length = x.shape[-1]
    if not 1 <= length <= plan.seqlen:
        raise ValueError(f"input length {length} not in [1, {plan.seqlen}]")
    if on_cpu(x, gate):
        if inverse:
            return monarch.butterfly_inverse_plain(plan, x, length, gate, dtype)
        return monarch.butterfly_plain(plan, x, gate)
    if inverse:
        _check_cuda("z", x, plan.device, (torch.complex64,), 4)
        b, h = x.shape[:2]
        if x.shape[2:] != (plan.outer, plan.band):
            raise ValueError(f"z shape {tuple(x.shape)} != (B, H, {plan.outer}, {plan.band})")
        if dtype not in _DTYPE_CODES:
            raise TypeError(f"output dtype {dtype} not in {sorted(map(str, _DTYPE_CODES))}")
        out = torch.empty(b, h, length, dtype=dtype, device=x.device)
        reals = out
    else:
        _check_cuda("u", x, plan.device, tuple(_DTYPE_CODES), 3)
        b, h, _ = x.shape
        out = torch.empty(b, h, plan.outer, plan.band, dtype=torch.complex64, device=x.device)
        reals = x
    if gate is not None:
        _check_cuda("gate", gate, plan.device, (reals.dtype,), 3)
        if gate.shape != reals.shape:
            raise ValueError(f"gate shape {tuple(gate.shape)} != {tuple(reals.shape)}")
    if b * h == 0:
        return out
    if inverse:
        x = _aligned16(x)
    lib = _build.load("butterfly")
    fn = lib.ffc_butterfly_inv if inverse else lib.ffc_butterfly_fwd
    rc = fn(
        x.data_ptr(), None if gate is None else gate.data_ptr(), out.data_ptr(),
        plan.split_tw.data_ptr(), b * h, length, plan.outer, plan.band,
        _DTYPE_CODES[reals.dtype], _stream(x.device),
    )
    _build.check(lib, rc, "butterfly kernel")
    butterfly.launches += 1
    return out


butterfly.launches = 0


def _check_bands(plan: FftPlan, name: str, z: torch.Tensor) -> None:
    _check_cuda(name, z, plan.device, (torch.complex64,), 4)
    if z.shape[2:] != (plan.outer, plan.band):
        raise ValueError(f"{name} shape {tuple(z.shape)} != (B, H, {plan.outer}, {plan.band})")


def long_conv_inner(
    plan: FftPlan, z: torch.Tensor, k_f: torch.Tensor, out: torch.Tensor | None = None
) -> torch.Tensor:
    """The band stage of a long conv: for the bands z (B, H, F, R) complex64
    of ``butterfly`` and k_f (H, M+1) complex64, per band the R-point FFT,
    the split, the product with k_f, the unsplit and the inverse FFT (with
    1/R). Returns complex64 (B, H, F, R), written into ``out`` when given;
    ``out`` may be z itself."""
    _require_long(plan)
    if on_cpu(z, k_f, out):
        res = monarch.long_conv_inner_plain(plan, z, k_f)
        return res if out is None else out.copy_(res)
    _check_bands(plan, "z", z)
    b, h = z.shape[:2]
    _check_cuda("k_f", k_f, plan.device, (torch.complex64,), 2)
    if k_f.shape != (h, plan.inner + 1):
        raise ValueError(f"k_f shape {tuple(k_f.shape)} != {(h, plan.inner + 1)}")
    if out is None:
        out = torch.empty_like(z)
    else:
        _check_bands(plan, "out", out)
        if out.shape != z.shape:
            raise ValueError(f"out shape {tuple(out.shape)} != z shape {tuple(z.shape)}")
    if b * h == 0:
        return out
    z = _aligned16(z)
    dst = out if out.data_ptr() % 16 == 0 else torch.empty_like(z)
    lib = _build.load("long_conv")
    rc = lib.ffc_long_conv(
        z.data_ptr(), dst.data_ptr(), k_f.data_ptr(), plan.split_tw.data_ptr(),
        plan.sub.split_tw.data_ptr(), b, h, plan.outer, plan.band, _stream(z.device),
    )
    _build.check(lib, rc, "long_conv kernel")
    long_conv_inner.launches += 1
    return out if dst is out else out.copy_(dst)


long_conv_inner.launches = 0


def long_conv(
    plan: FftPlan,
    u: torch.Tensor,
    k_f: torch.Tensor,
    pregate: torch.Tensor | None = None,
    postgate: torch.Tensor | None = None,
) -> torch.Tensor:
    """``monarch_conv`` for a long plan (seqlen >= 65536): u (B, H, L <= N)
    in f32 or bf16, k_f (H, M+1) complex64 from ``long_spectrum``, optional
    gates (B, H, L) at u's dtype; output (B, H, L) at u's dtype. Runs
    ``butterfly``, ``long_conv_inner`` in place on the bands, and the inverse
    ``butterfly``; the bands (8 bytes a complex point, 8*M a row) live in
    device memory in between."""
    if (pregate is None) != (postgate is None):
        raise ValueError("pregate and postgate must both be given or both be None")
    z = butterfly(plan, u, pregate)
    z = long_conv_inner(plan, z, k_f, out=z)
    return butterfly(plan, z, postgate, inverse=True, length=u.shape[-1], dtype=u.dtype)


def long_spectrum(plan: FftPlan, k: torch.Tensor) -> torch.Tensor:
    """``spectrum`` for a long plan (seqlen >= 65536): half spectrum (H, M+1)
    complex64, natural order, of real f32 taps k (H, k_len <= N). Runs the
    forward ``butterfly`` on the taps and then its own kernel over the bands."""
    _require_long(plan)
    if on_cpu(k):
        return monarch.long_spectrum_plain(plan, k)
    _check_cuda("k", k, plan.device, (torch.float32,), 2)
    h, k_len = k.shape
    if not 1 <= k_len <= plan.seqlen:
        raise ValueError(f"kernel length {k_len} not in [1, {plan.seqlen}]")
    out = torch.empty(h, plan.inner + 1, dtype=torch.complex64, device=k.device)
    if h == 0:
        return out
    return _long_spectrum_bands(plan, butterfly(plan, k[None])[0], out)


def _long_spectrum_bands(plan: FftPlan, z: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The ``long_spectrum`` kernels alone: the half spectrum of the bands z
    (H, F, R) complex64 that the forward ``butterfly`` left, into ``out``;
    z is overwritten (the split spectrum, band by band, on its way to
    ``out``)."""
    sub = plan.sub
    lib = _build.load("long_spectrum")
    rc = lib.ffc_long_spectrum(
        z.data_ptr(), out.data_ptr(), sub.tw_flat.data_ptr(), plan.split_tw.data_ptr(),
        sub.split_tw.data_ptr(), sub.roots.data_ptr(), z.shape[0], plan.outer,
        *_factor_args(sub), _stream(z.device),
    )
    _build.check(lib, rc, "long_spectrum kernel")
    long_spectrum.launches += 1
    return out


long_spectrum.launches = 0


def long_conv_bwd_inner(
    plan: FftPlan,
    zu: torch.Tensor,
    zg: torch.Tensor,
    k_f: torch.Tensor,
    need_y: bool = False,
    inplace: bool = False,
):
    """The band stage of the backward of a long conv: for the bands zu =
    ``butterfly(u, pre)`` and zg = ``butterfly(dout * post)``, both (B, H, F,
    R) complex64, and k_f (H, M+1) complex64, per band pair the R-point FFTs
    and splits of both, then the bands (unsplit, inverse FFT with 1/R) of
    G conj(K) and, with ``need_y``, of U K, and the dk spectrum G conj(U).
    Returns (du bands, y bands or None, partials): complex64 (B, H, F, R)
    and (B, H, M+1), the partials one row a batch element for
    ``long_dk_finish``. With ``inplace`` the card writes the du bands over zg
    and the y bands over zu."""
    _require_long(plan)
    if on_cpu(zu, zg, k_f):
        return monarch.long_conv_bwd_inner_plain(plan, zu, zg, k_f, need_y)
    if plan.band > MAX_BWD_BAND:
        raise ValueError(
            f"the long backward kernel takes bands of at most {MAX_BWD_BAND} points, the plan's "
            f"factors {plan.factors} give {plan.band}; long_conv_bwd runs such a plan's "
            f"backward under bwd_plan(plan)"
        )
    _check_bands(plan, "zu", zu)
    _check_bands(plan, "zg", zg)
    b, h = zu.shape[:2]
    if zg.shape != zu.shape:
        raise ValueError(f"zg shape {tuple(zg.shape)} != zu shape {tuple(zu.shape)}")
    _check_cuda("k_f", k_f, plan.device, (torch.complex64,), 2)
    if k_f.shape != (h, plan.inner + 1):
        raise ValueError(f"k_f shape {tuple(k_f.shape)} != {(h, plan.inner + 1)}")
    zu, zg = _aligned16(zu), _aligned16(zg)
    du = zg if inplace else torch.empty_like(zg)
    y = (zu if inplace else torch.empty_like(zu)) if need_y else None
    partials = torch.empty(b, h, plan.inner + 1, dtype=torch.complex64, device=zu.device)
    if b * h == 0:
        return du, y, partials
    lib = _build.load("long_conv_bwd")
    rc = lib.ffc_long_conv_bwd(
        zu.data_ptr(), zg.data_ptr(), du.data_ptr(), None if y is None else y.data_ptr(),
        partials.data_ptr(), k_f.data_ptr(), plan.split_tw.data_ptr(),
        plan.sub.split_tw.data_ptr(), b, h, plan.outer, plan.band, _stream(zu.device),
    )
    _build.check(lib, rc, "long_conv_bwd kernel")
    long_conv_bwd_inner.launches += 1
    return du, y, partials


long_conv_bwd_inner.launches = 0


def long_dk_finish(plan: FftPlan, partials: torch.Tensor, k_len: int) -> torch.Tensor:
    """``dk_finish`` for a long plan: dk (H, k_len) f32 from the (B, H, M+1)
    complex64 partials of ``long_conv_bwd_inner``. Its own kernel sums them
    over B in order, unsplits and runs the inverse R-point FFT of every band;
    the inverse ``butterfly`` then gives the real samples [0, k_len)."""
    _require_long(plan)
    if on_cpu(partials):
        return monarch.long_dk_finish_plain(plan, partials, k_len)
    _check_cuda("partials", partials, plan.device, (torch.complex64,), 3)
    b, h, m1 = partials.shape
    if m1 != plan.inner + 1:
        raise ValueError(f"partials shape {tuple(partials.shape)} != (B, H, {plan.inner + 1})")
    if not 1 <= k_len <= plan.seqlen:
        raise ValueError(f"kernel length {k_len} not in [1, {plan.seqlen}]")
    if h == 0:
        return torch.empty(h, k_len, dtype=torch.float32, device=partials.device)
    if b == 0:
        return torch.zeros(h, k_len, dtype=torch.float32, device=partials.device)
    z = torch.empty(1, h, plan.outer, plan.band, dtype=torch.complex64, device=partials.device)
    _long_dk_finish_bands(plan, partials, z[0])
    return butterfly(plan, z, inverse=True, length=k_len, dtype=torch.float32)[0]


def _long_dk_finish_bands(plan: FftPlan, partials: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The ``long_dk_finish`` kernel alone: the (H, F, R) bands of the dk
    spectrum (the partials summed over B, unsplit, inverse R-point FFT with
    1/R) into ``out``, 16-byte aligned, for the inverse ``butterfly``."""
    b, h = partials.shape[:2]
    lib = _build.load("long_conv_bwd")
    rc = lib.ffc_long_dk_finish(
        partials.data_ptr(), out.data_ptr(), plan.split_tw.data_ptr(),
        plan.sub.split_tw.data_ptr(), b, h, plan.outer, plan.band, _stream(partials.device),
    )
    _build.check(lib, rc, "long_dk_finish kernel")
    long_dk_finish.launches += 1
    return out


long_dk_finish.launches = 0


def bwd_plan(plan: FftPlan) -> FftPlan:
    """The plan a long backward runs under: ``plan`` itself when its band
    fits the backward kernel (``MAX_BWD_BAND``), else the cached default
    plan of the same seqlen and dtype (band ``LONG_BAND`` = 4096), as the JAX
    package's ``_bwd_plan`` lets a backward run under factors of its own.
    k_f and the dk partials are in natural order, so the function is the
    same under either plan."""
    if not plan.n_outer or plan.band <= MAX_BWD_BAND:
        return plan
    return get_plan(plan.seqlen, plan.dtype, plan.device)


def long_conv_bwd(
    plan: FftPlan,
    u: torch.Tensor,
    k_f: torch.Tensor,
    pregate: torch.Tensor | None,
    postgate: torch.Tensor | None,
    dout: torch.Tensor,
):
    """``monarch_conv_bwd`` for a long plan (seqlen >= 65536), same inputs
    and outputs: (du, dpre, dpost, partials). Runs ``butterfly`` on u * pre
    (rounded to u's dtype, as in the forward) and on g = dout * post (f32),
    ``long_conv_bwd_inner`` in place on the two band arrays, and the inverse
    ``butterfly`` of the du bands and, when gated, of the y bands with dout as
    its gate, all under ``bwd_plan(plan)``. The two gate products of du_inner
    (du = du_inner * pre, dpre = du_inner * u) are elementwise on its f32
    samples."""
    gated = pregate is not None
    if gated != (postgate is not None):
        raise ValueError("pregate and postgate must both be given or both be None")
    if dout.shape != u.shape:
        raise ValueError(f"dout shape {tuple(dout.shape)} != u shape {tuple(u.shape)}")
    plan = bwd_plan(plan)
    length = u.shape[-1]
    zu = butterfly(plan, u, pregate)
    zg = butterfly(plan, dout.float() * postgate.float() if gated else dout)
    zdu, zy, partials = long_conv_bwd_inner(plan, zu, zg, k_f, need_y=gated, inplace=True)
    if not gated:
        du = butterfly(plan, zdu, inverse=True, length=length, dtype=u.dtype)
        return du, None, None, partials
    du_inner = butterfly(plan, zdu, inverse=True, length=length, dtype=torch.float32)
    dpost = butterfly(plan, zy, dout, inverse=True, length=length, dtype=u.dtype)
    du = (du_inner * pregate.float()).to(u.dtype)
    dpre = (du_inner * u.float()).to(u.dtype)
    return du, dpre, dpost, partials


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its storage starts off a 16-byte boundary."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def band_conv(
    plan: FftPlan, b: torch.Tensor, k_f: torch.Tensor, conj: bool = False
) -> torch.Tensor:
    """The complex band conv of the sequence-parallel FFT conv: for complex64
    bands b (B, H, N2) and a full complex64 spectrum k_f (H, N2) in natural
    order, ``ifft(fft(b) * k_f)`` (``conj(k_f)`` with ``conj``), complex64
    (B, H, N2). ``plan`` is the plan of FFT size 2 * N2 (its inner complex
    length is N2), N2 from 16 to ``BAND_CONV_MAX``; the kernel is
    instantiated per N2 and needs only the plan's ``split_tw`` (its root
    table)."""
    if on_cpu(b, k_f):
        return monarch.band_conv_plain(plan, b, k_f, conj)
    _check_cuda("b", b, plan.device, (torch.complex64,), 3)
    bsz, h, n2 = b.shape
    _check_cuda("k_f", k_f, plan.device, (torch.complex64,), 2)
    if n2 != plan.inner or k_f.shape != (h, n2):
        raise ValueError(f"b shape {tuple(b.shape)} and k_f shape {tuple(k_f.shape)} do not "
                         f"match (B, H, {plan.inner}) and (H, {plan.inner})")
    if not 16 <= n2 <= BAND_CONV_MAX:
        raise ValueError(f"band_conv takes bands of 16 to {BAND_CONV_MAX} points, got {n2}")
    out = torch.empty_like(b)
    if bsz * h == 0:
        return out
    b, k_f = _aligned16(b), _aligned16(k_f)
    lib = _build.load("band_conv")
    rc = lib.ffc_band_conv(
        b.data_ptr(), k_f.data_ptr(), out.data_ptr(), plan.split_tw.data_ptr(), bsz, h, n2,
        int(conj), _stream(b.device),
    )
    _build.check(lib, rc, "band_conv kernel")
    band_conv.launches += 1
    return out


band_conv.launches = 0


class BandConvFunction(torch.autograd.Function):
    """``band_conv`` over b (..., H, N2) with the JAX package's custom VJP
    (``parallel/seq_conv.py``'s ``_band_conv_bwd``): the map is complex
    linear, b -> F^-1 diag(k_f) F b, so db is the band conv of dy with
    conj(k_f), one more ``band_conv`` launch, and dk_f = conj(F b) * (F dy)
    / N2 summed over the leading axes, its two forward DFTs through the
    plan's Monarch matmul chain (``monarch.cfft_plain``), as the JAX package
    computes them in XLA. Saves (b, k_f)."""

    @staticmethod
    def forward(ctx, plan, b, k_f):
        ctx.plan = plan
        ctx.save_for_backward(b, k_f)
        rows = b.reshape(-1, *b.shape[-2:]).contiguous()
        return band_conv(plan, rows, k_f.contiguous()).reshape(b.shape)

    @staticmethod
    def backward(ctx, dy):
        b, k_f = ctx.saved_tensors
        plan = ctx.plan
        db = dk_f = None
        if ctx.needs_input_grad[1]:
            rows = dy.reshape(-1, *dy.shape[-2:]).contiguous()
            db = band_conv(plan, rows, k_f.contiguous(), conj=True).reshape(b.shape)
        if ctx.needs_input_grad[2]:
            prod = monarch.cfft_plain(plan, b).conj() * monarch.cfft_plain(plan, dy)
            dk_f = prod.reshape(-1, *k_f.shape).sum(0) / plan.inner
        return None, db, dk_f


def _io_dtype(u: torch.Tensor) -> torch.dtype:
    """The kernels' I/O dtype: float16 runs as bfloat16 on the card (as the
    JAX package's ``_io_dtype`` does); the CPU keeps u's dtype."""
    return torch.bfloat16 if u.dtype == torch.float16 and u.device.type == "cuda" else u.dtype


def _rows(t: torch.Tensor | None, shape, io: torch.dtype) -> torch.Tensor | None:
    """t as contiguous (B, H, L) rows at the I/O dtype."""
    return None if t is None else t.reshape(-1, *shape[-2:]).to(io).contiguous()


class FftConvFunction(torch.autograd.Function):
    """The FFT conv with the kernels' backward (the plain versions on CPU
    tensors). Saves only (u, k, pregate, postgate); the backward recomputes
    k's spectrum. Grads come back at each input's dtype (dk f32 like k)."""

    @staticmethod
    def forward(ctx, plan, u, k, pregate, postgate):
        if k.shape[-1] > plan.seqlen:
            raise ValueError(f"kernel length {k.shape[-1]} > plan seqlen {plan.seqlen}")
        ctx.plan = plan
        ctx.save_for_backward(u, k, pregate, postgate)
        u3, pre3, post3 = (_rows(t, u.shape, _io_dtype(u)) for t in (u, pregate, postgate))
        if plan.n_outer:
            out = long_conv(plan, u3, long_spectrum(plan, k.float().contiguous()), pre3, post3)
        else:
            conv = direct_conv if plan.direct else monarch_conv
            out = conv(plan, u3, spectrum(plan, k.float().contiguous()), pre3, post3)
        return out.reshape(u.shape).to(u.dtype)

    @staticmethod
    def backward(ctx, dout):
        u, k, pregate, postgate = ctx.saved_tensors
        plan, shape, io = ctx.plan, u.shape, _io_dtype(u)
        u3, pre3, post3, dout3 = (_rows(t, shape, io) for t in (u, pregate, postgate, dout))
        spec, bwd, finish = (
            (long_spectrum, long_conv_bwd, long_dk_finish) if plan.n_outer
            else (spectrum, direct_conv_bwd if plan.direct else monarch_conv_bwd, dk_finish))
        k_f = spec(plan, k.float().contiguous())
        du, dpre, dpost, partials = bwd(plan, u3, k_f, pre3, post3, dout3)
        del k_f  # 2.1 GB at H = 256, N = 2^21, not needed by the dk finish
        dk = finish(plan, partials, k.shape[-1]) if ctx.needs_input_grad[2] else None
        back = lambda g, like: None if g is None else g.reshape(like.shape).to(like.dtype)
        return (None, back(du, u), back(dk, k), back(dpre, pregate), back(dpost, postgate))


def fft_conv(
    plan: FftPlan,
    u: torch.Tensor,
    k: torch.Tensor,
    pregate: torch.Tensor | None = None,
    postgate: torch.Tensor | None = None,
) -> torch.Tensor:
    """The JAX package's ``fft_conv_pallas`` through the wrappers: the
    kernels on CUDA tensors, the plain versions on CPU tensors, at every plan
    size from 16 to 4194304. u (..., H, L <= N), k (H, k_len <= N); gates
    cast to u's I/O dtype (float16 runs as bfloat16 on the card); output at
    u's dtype. Runs through
    ``FftConvFunction``, which saves nothing and builds no graph when no
    grad is needed."""
    return FftConvFunction.apply(plan, u, k, pregate, postgate)
