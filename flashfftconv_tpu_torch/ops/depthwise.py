"""Short depthwise 1-D convolution (the reference's ``FlashDepthWiseConv1d``).

Depthwise conv1d with stride 1, dilation 1, odd kernel size, symmetric or
``(left, right)`` zero padding and optional bias, in two layouts:

  - BHL: x (B, D, L), weights (D, K)  -> out (B, D, L + left + right - K + 1)
  - BLH: x (B, L, D), weights (K, D)  -> out (B, L + left + right - K + 1, D)

Multiply-adds run in f32 and the output takes the activation dtype. On a
CUDA tensor the ``depthwise`` wrapper launches csrc/depthwise.cu, which
replaces the TPU kernel ``_pallas_depthwise`` (flashfftconv_tpu/ops/
depthwise.py), and ``depthwise_bwd`` launches csrc/depthwise_bwd.cu, which
replaces ``_pallas_depthwise_bwd``; on a CPU tensor each runs its plain
version (``depthwise_plain``, the shift form of the JAX package's
``_xla_depthwise``, and ``depthwise_bwd_plain``). ``DepthwiseFunction``
joins the two as an autograd Function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flashfftconv_tpu_torch.ops import _build
from flashfftconv_tpu_torch.ops.monarch_cuda import _stream, on_cpu

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_IMPLS = ("auto", "cuda", "plain")


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


def _shape_args(x, weights, padding, is_bhl: bool) -> tuple[int, ...]:
    """Check a CUDA call's x and weights; return (B, D, L, K, left, out_len)."""
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
    if weights.device != x.device:
        raise ValueError(f"weights are on {weights.device}, x on {x.device}")
    out_len = length + left + right - k + 1
    if out_len < 1:
        raise ValueError(f"output length {out_len} < 1")
    return b, d, length, k, left, out_len


def depthwise(x, weights, bias, padding, is_bhl: bool) -> torch.Tensor:
    """The depthwise kernel's wrapper: csrc/depthwise.cu on CUDA tensors,
    ``depthwise_plain`` on CPU tensors. x contiguous f32/bf16/f16; weights
    and bias are read as f32."""
    if on_cpu(x, weights, bias):
        return depthwise_plain(x, weights, bias, padding, is_bhl)
    b, d, length, k, left, out_len = _shape_args(x, weights, padding, is_bhl)
    w = weights.float().contiguous()
    bf = None if bias is None else bias.float().contiguous()
    if bf is not None and bf.device != x.device:
        raise ValueError(f"bias is on {bf.device}, x on {x.device}")
    out = torch.empty((b, d, out_len) if is_bhl else (b, out_len, d), dtype=x.dtype, device=x.device)
    if b * d == 0:
        return out
    lib = _build.load("depthwise")
    rc = lib.ffc_depthwise(
        x.data_ptr(), w.data_ptr(), None if bf is None else bf.data_ptr(), out.data_ptr(),
        b, d, length, k, left, out_len, int(is_bhl), _DTYPE_CODES[x.dtype], _stream(x.device),
    )
    _build.check(lib, rc, "depthwise kernel")
    depthwise.launches += 1
    return out


depthwise.launches = 0


def depthwise_bwd_plain(x, weights, dout, padding, is_bhl: bool):
    """The backward of ``depthwise_plain`` in f32 (the plain version of the
    depthwise_bwd kernel), with x zero outside [0, L) and dout (the
    output's layout and length):

      du[i] = sum_t w[t] dout[i - t + left],  dk[t] = sum_{b,l} x[l + t - left] dout[l],
      dbias = sum_{b,l} dout[l].

    Returns (du at x's dtype, dk f32 in weights' layout, dbias f32 (D,))."""
    left, right = _pads(padding)
    w_dk = (weights if is_bhl else weights.T).float()
    xb = (x if is_bhl else x.transpose(1, 2)).float()
    db = (dout if is_bhl else dout.transpose(1, 2)).float()
    length, l_out = xb.shape[-1], db.shape[-1]
    xp = F.pad(xb, (left, right))
    dup = torch.zeros_like(xp)
    taps = []
    for tap in range(w_dk.shape[1]):
        dup[..., tap : tap + l_out] += db * w_dk[None, :, tap, None]
        taps.append((xp[..., tap : tap + l_out] * db).sum((0, 2)))
    du = dup[..., left : left + length]
    dk = torch.stack(taps, dim=1)
    if not is_bhl:
        du, dk = du.transpose(1, 2), dk.T
    return du.to(x.dtype), dk, db.sum((0, 2))


def depthwise_bwd(x, weights, dout, padding, is_bhl: bool):
    """The depthwise backward kernel's wrapper: csrc/depthwise_bwd.cu on CUDA
    tensors, ``depthwise_bwd_plain`` on CPU tensors. x and dout contiguous,
    of one dtype; returns (du at x's dtype, dk f32 in weights' layout,
    dbias f32 (D,))."""
    if on_cpu(x, weights, dout):
        return depthwise_bwd_plain(x, weights, dout, padding, is_bhl)
    b, d, length, k, left, out_len = _shape_args(x, weights, padding, is_bhl)
    out_shape = (b, d, out_len) if is_bhl else (b, out_len, d)
    if dout.shape != out_shape or dout.dtype != x.dtype or not dout.is_contiguous():
        raise ValueError(f"dout must be a contiguous {x.dtype} tensor of shape {out_shape}, got "
                         f"{dout.dtype} {tuple(dout.shape)}")
    w = weights.float().contiguous()
    du = torch.empty_like(x)
    dk = torch.empty(weights.shape, dtype=torch.float32, device=x.device)
    dbias = torch.empty(d, dtype=torch.float32, device=x.device)
    if b * d == 0:
        return du, dk.zero_(), dbias.zero_()
    lib = _build.load("depthwise_bwd")
    tiles = lib.ffc_depthwise_bwd_tiles(b, out_len)
    partials = torch.empty(d, tiles, k + 1, dtype=torch.float32, device=x.device)
    rc = lib.ffc_depthwise_bwd(
        x.data_ptr(), dout.data_ptr(), w.data_ptr(), du.data_ptr(), partials.data_ptr(),
        dk.data_ptr(), dbias.data_ptr(), b, d, length, k, left, out_len, int(is_bhl),
        _DTYPE_CODES[x.dtype], _stream(x.device),
    )
    _build.check(lib, rc, "depthwise_bwd kernel")
    depthwise_bwd.launches += 1
    return du, dk, dbias


depthwise_bwd.launches = 0


class DepthwiseFunction(torch.autograd.Function):
    """``depthwise`` with ``depthwise_bwd`` as its backward: the kernels on
    CUDA tensors, the plain versions on CPU tensors. Saves x, weights and
    bias; grads come back at each input's dtype."""

    @staticmethod
    def forward(ctx, x, weights, bias, padding, is_bhl):
        ctx.padding, ctx.is_bhl = padding, is_bhl
        ctx.save_for_backward(x, weights, bias)
        return depthwise(x, weights, bias, padding, is_bhl)

    @staticmethod
    def backward(ctx, dout):
        x, weights, bias = ctx.saved_tensors
        du, dk, dbias = depthwise_bwd(x, weights, dout.to(x.dtype).contiguous(), ctx.padding,
                                      ctx.is_bhl)
        dbias = None if bias is None else dbias.to(bias.dtype)
        return du, dk.to(weights.dtype), dbias, None, None


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
      impl: 'auto' (``DepthwiseFunction``: the kernels on CUDA tensors, the
        plain versions on CPU tensors),
        'cuda' (the kernels; CUDA tensors only) or 'plain' (``depthwise_plain``
        under torch's autograd).
    """
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    k = weights.shape[1] if is_bhl else weights.shape[0]
    _check(weights, bias, k)
    if impl == "plain":
        return depthwise_plain(x, weights, bias, padding, is_bhl)
    if impl == "cuda" and x.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs a CUDA tensor, got {x.device}")
    return DepthwiseFunction.apply(x.contiguous(), weights, bias, padding, is_bhl)
