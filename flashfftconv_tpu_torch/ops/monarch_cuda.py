"""Wrappers of the FFT-conv kernels: ``spectrum`` and ``monarch_conv``.

``spectrum`` (csrc/spectrum.cu) replaces the TPU kernel ``_spectrum_tiles``
and ``monarch_conv`` (csrc/monarch_conv.cu) replaces ``_conv_fused_io_tiles``
(flashfftconv_tpu/ops/monarch_pallas.py). On a CUDA tensor each wrapper
checks its inputs, allocates its output with ``torch.empty``, launches its
kernel on the current stream, raises if the launch failed, and adds one to
its ``launches`` count. On a CPU tensor it runs the plain version from
``ops/monarch.py`` instead; on any other device it raises.

The kernels have no backward yet: a wrapper called on a CUDA tensor that
requires grad while grad mode is on raises NotImplementedError.
"""

from __future__ import annotations

import ctypes

import torch

from flashfftconv_tpu_torch.ops import _build, monarch
from flashfftconv_tpu_torch.ops.plan import MAX_FACTOR, FftPlan

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures (csrc/spectrum.cu, csrc/monarch_conv.cu): pointers, then the
# sizes, n_stages and four factors, [dtype], then the stream.
_ARGTYPES = {
    "spectrum": [_P] * 5 + [_I] * 7 + [_P],
    "monarch_conv": [_P] * 8 + [_I] * 9 + [_P],
}


def _lib(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, f"ffc_{name}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
    return lib


def on_cpu(*tensors: torch.Tensor | None) -> bool:
    """True if every tensor lies on the CPU; raise on a device that is
    neither the CPU nor CUDA."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs <= {"cpu"}:
        return True
    if devs != {"cuda"}:
        raise ValueError(f"tensors must all be on the CPU or all on CUDA, got {sorted(devs)}")
    return False


def check_no_grad(*tensors: torch.Tensor | None) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError("backward kernels are slice 2")


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
    check_no_grad(k)
    _check_cuda("k", k, plan.device, (torch.float32,), 2)
    h, k_len = k.shape
    if not 1 <= k_len <= plan.seqlen:
        raise ValueError(f"kernel length {k_len} not in [1, {plan.seqlen}]")
    out = torch.empty(h, plan.inner + 1, dtype=torch.complex64, device=k.device)
    if h == 0:
        return out
    lib = _lib("spectrum")
    rc = lib.ffc_spectrum(
        k.data_ptr(), out.data_ptr(), plan.tw_flat.data_ptr(), plan.split_tw.data_ptr(),
        plan.roots.data_ptr(), h, k_len, *_factor_args(plan), _stream(k.device),
    )
    _build.check(lib, rc, "spectrum kernel")
    spectrum.launches += 1
    return out


spectrum.launches = 0


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
    check_no_grad(u, k_f, pregate, postgate)
    _check_cuda("u", u, plan.device, tuple(_DTYPE_CODES), 3)
    b, h, length = u.shape
    _check_cuda("k_f", k_f, plan.device, (torch.complex64,), 2)
    if k_f.shape != (h, plan.inner + 1):
        raise ValueError(f"k_f shape {tuple(k_f.shape)} != {(h, plan.inner + 1)}")
    for name, g in (("pregate", pregate), ("postgate", postgate)):
        if g is not None:
            _check_cuda(name, g, plan.device, (u.dtype,), 3)
            if g.shape != u.shape:
                raise ValueError(f"{name} shape {tuple(g.shape)} != u shape {tuple(u.shape)}")
    if not 1 <= length <= plan.seqlen:
        raise ValueError(f"input length {length} not in [1, {plan.seqlen}]")
    out = torch.empty_like(u)
    if b * h == 0:
        return out
    lib = _lib("monarch_conv")
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


def fft_conv_cuda(
    plan: FftPlan,
    u: torch.Tensor,
    k: torch.Tensor,
    pregate: torch.Tensor | None = None,
    postgate: torch.Tensor | None = None,
) -> torch.Tensor:
    """The forward of the JAX package's ``fft_conv_pallas`` on the card:
    ``spectrum`` of k, then one ``monarch_conv``. u (..., H, L <= N), k
    (H, k_len <= N); gates cast to u's I/O dtype, float16 runs as bfloat16
    (as the JAX package's ``_io_dtype`` does); output at u's dtype."""
    if u.device.type != "cuda":
        raise ValueError(f"fft_conv_cuda needs CUDA tensors, got {u.device}")
    io = torch.bfloat16 if u.dtype == torch.float16 else u.dtype
    shape = u.shape
    u3 = u.reshape(-1, *shape[-2:]).to(io).contiguous()
    gates = [None if g is None else g.reshape(u3.shape).to(io).contiguous()
             for g in (pregate, postgate)]
    k_f = spectrum(plan, k.float().contiguous())
    out = monarch_conv(plan, u3, k_f, *gates)
    return out.reshape(shape).to(u.dtype)
