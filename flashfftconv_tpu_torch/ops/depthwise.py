"""Short depthwise 1-D convolution (the reference's ``FlashDepthWiseConv1d``).

Depthwise conv1d with stride 1, dilation 1, odd kernel size, symmetric or
``(left, right)`` zero padding and optional bias, in two layouts:

  - BHL: x (B, D, L), weights (D, K)  -> out (B, D, L + left + right - K + 1)
  - BLH: x (B, L, D), weights (K, D)  -> out (B, L + left + right - K + 1, D)

Multiply-adds run in f32 and the output takes the activation dtype. On a
CUDA tensor the ``depthwise`` wrapper launches csrc/depthwise.cu, which
replaces the TPU kernel ``_pallas_depthwise`` (flashfftconv_tpu/ops/
depthwise.py); on a CPU tensor it runs the plain version, the shift form of
the JAX package's ``_xla_depthwise``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from flashfftconv_tpu_torch.ops import _build
from flashfftconv_tpu_torch.ops.monarch_cuda import check_no_grad, on_cpu

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_IMPLS = ("auto", "cuda", "plain")


def _lib() -> ctypes.CDLL:
    lib = _build.load("depthwise")
    fn = lib.ffc_depthwise
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _pads(padding) -> tuple[int, int]:
    if isinstance(padding, int):
        return padding, padding
    return int(padding[0]), int(padding[1])


def depthwise_plain(x, weights, bias, padding, is_bhl: bool) -> torch.Tensor:
    """K shifted f32 multiply-adds over the zero-padded input, output at
    x's dtype (the shift form of the JAX package's ``_xla_depthwise``)."""
    left, right = _pads(padding)
    w_kd = (weights.T if is_bhl else weights).float()
    k = w_kd.shape[0]
    if is_bhl:
        xp = F.pad(x, (left, right))
        l_out = xp.shape[-1] - k + 1
        out = torch.zeros(xp.shape[:-1] + (l_out,), dtype=torch.float32, device=x.device)
        for tap in range(k):
            out = out + xp[..., tap : tap + l_out].float() * w_kd[tap][None, :, None]
        if bias is not None:
            out = out + bias.float()[None, :, None]
    else:
        xp = F.pad(x, (0, 0, left, right))
        l_out = xp.shape[1] - k + 1
        out = torch.zeros((xp.shape[0], l_out, xp.shape[2]), dtype=torch.float32, device=x.device)
        for tap in range(k):
            out = out + xp[:, tap : tap + l_out, :].float() * w_kd[tap][None, None, :]
        if bias is not None:
            out = out + bias.float()[None, None, :]
    return out.to(x.dtype)


def depthwise(x, weights, bias, padding, is_bhl: bool) -> torch.Tensor:
    """The depthwise kernel's wrapper: csrc/depthwise.cu on CUDA tensors,
    ``depthwise_plain`` on CPU tensors. x contiguous f32/bf16/f16; weights
    and bias are read as f32."""
    if on_cpu(x, weights, bias):
        return depthwise_plain(x, weights, bias, padding, is_bhl)
    check_no_grad(x, weights, bias)
    left, right = _pads(padding)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x dtype {x.dtype} not in {sorted(map(str, _DTYPE_CODES))}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 3-D tensor, got shape {tuple(x.shape)}")
    if left < 0 or right < 0:
        raise ValueError(f"padding must be non-negative, got {(left, right)}")
    if is_bhl:
        b, d, length = x.shape
        k = weights.shape[1]
    else:
        b, length, d = x.shape
        k = weights.shape[0]
    if weights.shape != ((d, k) if is_bhl else (k, d)):
        raise ValueError(f"weights shape {tuple(weights.shape)} does not match x {tuple(x.shape)}")
    out_len = length + left + right - k + 1
    if out_len < 1:
        raise ValueError(f"output length {out_len} < 1")
    w = weights.float().contiguous()
    bf = None if bias is None else bias.float().contiguous()
    for name, t in (("weights", w), ("bias", bf)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    out = torch.empty((b, d, out_len) if is_bhl else (b, out_len, d), dtype=x.dtype, device=x.device)
    if b * d == 0:
        return out
    lib = _lib()
    rc = lib.ffc_depthwise(
        x.data_ptr(), w.data_ptr(), None if bf is None else bf.data_ptr(), out.data_ptr(),
        b, d, length, k, left, out_len, int(is_bhl), _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "depthwise kernel")
    depthwise.launches += 1
    return out


depthwise.launches = 0


def _check(weights, bias, k):
    if k % 2 != 1:
        # Parity with the reference constraint (csrc/flashfftconv/conv1d/conv1d.h:67).
        raise ValueError(f"kernel size must be odd, got {k}")
    if bias is not None and bias.shape != weights.shape[:1] and bias.ndim != 1:
        raise ValueError(f"bias shape {bias.shape} incompatible")


def depthwise_conv1d(
    x: torch.Tensor,
    weights: torch.Tensor,
    bias: torch.Tensor | None = None,
    padding: int | tuple[int, int] = 0,
    is_bhl: bool = True,
    impl: str = "auto",
) -> torch.Tensor:
    """Depthwise conv1d matching the reference ``conv1d_forward`` semantics.

    Args:
      x: (B, D, L) if is_bhl else (B, L, D).
      weights: (D, K) if is_bhl else (K, D).
      bias: (D,) or None.
      padding: zero padding, an int (symmetric) or (left, right); output
        length L + left + right - K + 1. Causal convs use (K-1, 0).
      impl: 'auto' (the kernel on CUDA tensors, the plain version on CPU
        tensors), 'cuda' (the kernel; CUDA tensors only) or 'plain'.
    """
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    k = weights.shape[1] if is_bhl else weights.shape[0]
    _check(weights, bias, k)
    if impl == "plain":
        return depthwise_plain(x, weights, bias, padding, is_bhl)
    if impl == "cuda" and x.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs a CUDA tensor, got {x.device}")
    return depthwise(x.contiguous(), weights, bias, padding, is_bhl)
