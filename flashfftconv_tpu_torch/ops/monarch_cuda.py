"""Wrappers of the FFT-conv kernels and the autograd Function over them.

``spectrum`` (csrc/spectrum.cu) replaces the TPU kernel ``_spectrum_tiles``,
``monarch_conv`` (csrc/monarch_conv.cu) replaces ``_conv_fused_io_tiles``
and ``monarch_conv_bwd`` (csrc/monarch_conv_bwd.cu) replaces
``_bwd_fused_io_tiles`` (flashfftconv_tpu/ops/monarch_pallas.py);
``dk_finish``, in the same source, is the card's counterpart of the JAX
package's ``_finish_dk``. On a CUDA tensor each wrapper checks its inputs,
allocates its outputs with ``torch.empty``, launches its kernel on the
current stream, raises if the launch failed, and adds one to its
``launches`` count. On a CPU tensor it runs the plain version from
``ops/monarch.py`` instead; on any other device it raises.

``FftConvFunction`` runs ``spectrum`` and ``monarch_conv`` forward and, in
its backward, recomputes the spectrum and runs ``monarch_conv_bwd`` and
``dk_finish``; it saves only (u, k, pregate, postgate), as the JAX
package's custom VJP does.
"""

from __future__ import annotations

import torch

from flashfftconv_tpu_torch.ops import _build, monarch
from flashfftconv_tpu_torch.ops.plan import MAX_FACTOR, FftPlan

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
    if any(f > MAX_FACTOR for f in plan.factors) or len(plan.factors) > 4:
        raise ValueError(f"plan factors {plan.factors} not supported by the kernels")
    return [len(plan.factors), *plan.factors, *([1] * (4 - len(plan.factors)))]


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def spectrum(plan: FftPlan, k: torch.Tensor) -> torch.Tensor:
    """Half spectrum (H, M+1) complex64 of real f32 taps k (H, k_len <= N)."""
    if on_cpu(k):
        return monarch.kernel_spectrum(plan, k)
    _check_cuda("k", k, plan.device, (torch.float32,), 2)
    h, k_len = k.shape
    if not 1 <= k_len <= plan.seqlen:
        raise ValueError(f"kernel length {k_len} not in [1, {plan.seqlen}]")
    out = torch.empty(h, plan.inner + 1, dtype=torch.complex64, device=k.device)
    if h == 0:
        return out
    lib = _build.load("spectrum")
    rc = lib.ffc_spectrum(
        k.data_ptr(), out.data_ptr(), plan.tw_flat.data_ptr(), plan.split_tw.data_ptr(),
        plan.roots.data_ptr(), h, k_len, *_factor_args(plan), _stream(k.device),
    )
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
    gates (B, H, L) at u's dtype. Output (B, H, L) at u's dtype."""
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
    lib = _build.load("monarch_conv")
    rc = lib.ffc_monarch_conv(
        u.data_ptr(),
        None if pregate is None else pregate.data_ptr(),
        None if postgate is None else postgate.data_ptr(),
        k_f.data_ptr(), out.data_ptr(),
        plan.tw_flat.data_ptr(), plan.split_tw.data_ptr(), plan.roots.data_ptr(),
        b, h, length, *_factor_args(plan), _DTYPE_CODES[u.dtype], _stream(u.device),
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
    (dpre, dpost None when ungated) and the dk spectrum partials
    G conj(U), complex64 (B, H, M+1), for ``dk_finish``."""
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
    gated = pregate is not None
    du = torch.empty_like(u)
    dpre = torch.empty_like(u) if gated else None
    dpost = torch.empty_like(u) if gated else None
    partials = torch.empty(b, h, plan.inner + 1, dtype=torch.complex64, device=u.device)
    if b * h == 0:
        return du, dpre, dpost, partials
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.load("monarch_conv_bwd")
    rc = lib.ffc_monarch_conv_bwd(
        u.data_ptr(), ptr(pregate), ptr(postgate), dout.data_ptr(), k_f.data_ptr(),
        du.data_ptr(), ptr(dpre), ptr(dpost), partials.data_ptr(),
        plan.tw_flat.data_ptr(), plan.split_tw.data_ptr(), plan.roots.data_ptr(),
        b, h, length, *_factor_args(plan), _DTYPE_CODES[u.dtype], _stream(u.device),
    )
    _build.check(lib, rc, "monarch_conv_bwd kernel")
    monarch_conv_bwd.launches += 1
    return du, dpre, dpost, partials


monarch_conv_bwd.launches = 0


def dk_finish(plan: FftPlan, partials: torch.Tensor, k_len: int) -> torch.Tensor:
    """dk (H, k_len) f32 = irfft(sum_b partials)[:k_len] for the (B, H, M+1)
    complex64 partials of ``monarch_conv_bwd``, summed over B in order."""
    if on_cpu(partials):
        return monarch.dk_finish_plain(plan, partials, k_len)
    _check_cuda("partials", partials, plan.device, (torch.complex64,), 3)
    b, h, m1 = partials.shape
    if m1 != plan.inner + 1:
        raise ValueError(f"partials shape {tuple(partials.shape)} != (B, H, {plan.inner + 1})")
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
        out = monarch_conv(plan, u3, spectrum(plan, k.float().contiguous()), pre3, post3)
        return out.reshape(u.shape).to(u.dtype)

    @staticmethod
    def backward(ctx, dout):
        u, k, pregate, postgate = ctx.saved_tensors
        plan, shape, io = ctx.plan, u.shape, _io_dtype(u)
        u3, pre3, post3, dout3 = (_rows(t, shape, io) for t in (u, pregate, postgate, dout))
        k_f = spectrum(plan, k.float().contiguous())
        du, dpre, dpost, partials = monarch_conv_bwd(plan, u3, k_f, pre3, post3, dout3)
        dk = dk_finish(plan, partials, k.shape[-1]) if ctx.needs_input_grad[2] else None
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
    kernels on CUDA tensors, the plain versions on CPU tensors. u (..., H,
    L <= N), k (H, k_len <= N); gates cast to u's I/O dtype (float16 runs as
    bfloat16 on the card); output at u's dtype. Runs through
    ``FftConvFunction``, which saves nothing and builds no graph when no
    grad is needed."""
    return FftConvFunction.apply(plan, u, k, pregate, postgate)
