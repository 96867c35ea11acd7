"""Wrappers of the attention kernels and the autograd Functions over them.

``flash_attn_fwd`` (csrc/flash_attn.cu) replaces the forward TPU kernel of
JAX's Pallas ``flash_attention`` that the JAX package's ``flash_mha`` calls
(``flashfftconv_tpu/ops/attention.py:202``); ``flash_attn_bwd_dkv`` and
``flash_attn_bwd_dq`` (csrc/flash_attn_bwd.cu) replace its two backward
kernels, the dK/dV one and the dQ one that also gives the bias's grad.
``splash_attn_fwd`` (csrc/splash_attn.cu) replaces the forward kernel of
JAX's splash attention, which ``flash_mha(window=W)`` and
``blocksparse_mha`` reach (``ops/attention.py:268-294, 331-340`` there);
``splash_attn_bwd_dkv`` and ``splash_attn_bwd_dq`` (csrc/splash_attn_bwd.cu)
replace its fused backward kernel, dK/dV in one kernel and dQ in another,
under a ``SplashMask`` (``ops/splash_mask.py``) whose hidden tiles they
skip. On a CUDA tensor each wrapper checks its inputs, allocates its
outputs with ``torch.empty`` (``torch.zeros`` for the bias grad, whose
tiles above the diagonal the causal kernel never visits), launches its
kernel on the current stream, raises if the launch failed, and adds one to
its ``launches`` count. On CPU tensors it runs the plain version from
``ops/attention.py``.

The kernels take q, k, v (B, H, L, D) contiguous, of one shape and dtype
(f32, bf16 or f16), head_dim 64 or any multiple of 128, any B * H, any
L >= 1 (``kernels_take`` asks this of shapes and dtypes; the wrappers raise
otherwise). At 64 and 128 one block holds a tile's whole rows; from 256 to
1024 the forward and the backward run in thread block clusters of D / 128
blocks on ``wgmma`` (``csrc/flash_attn_fwd_wide.cuh``,
``csrc/flash_attn_bwd_wide.cuh``), whose launch raises if no such cluster
fits the card; above 1024 every kernel runs in D slices of 256 columns
across blocks, each computing the scores over all of D. The flash kernels also take an
optional f32 bias whose expansion to (B, H, L, L) has a unit last stride (a
(1, H, L, L) ALiBi table is read in place for every batch row, not copied)
and optional int32 segment ids (B, L). Softmax statistics and every
accumulation are f32. The kernels run their products on the tensor cores
in split TF32, which keeps f32 accuracy (``csrc/flash_attn_common.cuh``),
and load 16 bytes at a time: their wrappers copy an operand whose data
does not start on a 16-byte boundary.

``FlashAttnFunction`` is the attention over (q, k, v, bias, segment_ids)
and ``SplashAttnFunction`` over (q, k, v) under a mask: each forward saves
q, k, v, the output and the row logsumexp; each backward computes delta =
rowsum(do * o) in torch (as JAX's backward does in XLA), then runs the
dK/dV kernel and the dQ kernel (the flash dQ kernel's ds summed to the
bias's shape by ``sum_to_size``). No atomics: two backwards give the same
bits.
"""

from __future__ import annotations

import struct

import torch

from flashfftconv_tpu_torch.ops import _build
from flashfftconv_tpu_torch.ops import attention as plain
from flashfftconv_tpu_torch.ops.monarch_cuda import _stream, on_cpu

# The head_dims the kernels take: 64, and any multiple of 128. From 256 up to
# MAX_CLUSTERED a block holds CLUSTER_DIM columns, the blocks of a tile in
# one thread block cluster (kWgDim and kMaxClustered in csrc/); above, D
# slices of SLICE_DIM columns, one block a slice (kSliceDim): no largest.
CLUSTER_DIM = 128
MAX_CLUSTERED = 1024
SLICE_DIM = 256
# The operands' dtypes, each with its code in the C interface (DType in
# csrc/flash_attn_common.cuh).
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _scale_bits(sm_scale: float) -> int:
    """sm_scale as the bits of an f32, the form the C interface takes."""
    return struct.unpack("<i", struct.pack("<f", sm_scale))[0]


def _refusal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str | None:
    """Why the attention kernels cannot take q, k, v, or None if they can.
    Looks at shapes and dtypes only, never at the device."""
    if q.ndim != 4:
        return f"q must be (B, H, L, D), got shape {tuple(q.shape)}"
    for t in (k, v):
        if t.shape != q.shape or t.dtype != q.dtype:
            return (f"the attention kernels take q, k, v of one shape and dtype, got "
                    f"{tuple(t.shape)} {t.dtype} against {tuple(q.shape)} {q.dtype}")
    if q.dtype not in DTYPES:
        return f"the attention kernels take f32, bf16 or f16, got {q.dtype}"
    d = q.shape[-1]
    if d != 64 and (d < 128 or d % 128 != 0):
        return f"the attention kernels take head_dim 64 or a multiple of 128, got {d}"
    return None


def kernels_take(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """True if the attention kernels take q, k, v (B, H, L, D) by shape and
    dtype: what ``impl='auto'`` asks before it sends CUDA tensors to them."""
    return _refusal(q, k, v) is None


def _check_qkv(*tensors: torch.Tensor) -> tuple[int, int, int, int]:
    q = tensors[0]
    if (why := _refusal(*tensors[:3])) is not None:
        raise ValueError(why)
    for t in tensors:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"q, k, v (and do) must share shape, dtype and device; got "
                             f"{tuple(t.shape)} {t.dtype} {t.device} against "
                             f"{tuple(q.shape)} {q.dtype} {q.device}")
        if not t.is_contiguous():
            raise ValueError("q, k, v (and do) must be contiguous")
    return tuple(q.shape)


def _aligned(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """The tensors, each copied if its data does not start on a 16-byte
    boundary (the kernels load 16 bytes at a time)."""
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors]


def _bias_args(bias: torch.Tensor | None, shape) -> tuple[torch.Tensor | None, list[int]]:
    """The bias as an f32 (B, H, L, L) view with a unit last stride, and its
    (b, h, query) strides."""
    if bias is None:
        return None, [0, 0, 0]
    b, h, l, _ = shape
    e = bias.float().expand(b, h, l, l)
    if e.stride(-1) != 1:
        e = e.contiguous()
    strides = list(e.stride()[:3])
    if max(strides) >= 2**31:
        raise ValueError(f"bias strides {strides} do not fit the kernels' 32-bit ints")
    return e, strides


def _seg(segment_ids: torch.Tensor | None, b: int, l: int, device) -> torch.Tensor | None:
    if segment_ids is None:
        return None
    if segment_ids.shape != (b, l) or segment_ids.dtype != torch.int32 or \
            segment_ids.device != device or not segment_ids.is_contiguous():
        raise ValueError(f"segment_ids must be contiguous int32 ({b}, {l}) on {device}, got "
                         f"{tuple(segment_ids.shape)} {segment_ids.dtype} {segment_ids.device}")
    return segment_ids


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _common(q, causal, sm_scale, bias, segment_ids):
    """(the kernels' trailing int args, the bias view, the segment ids)."""
    b, h, l, d = q.shape
    bias_e, strides = _bias_args(bias, q.shape)
    seg = _seg(segment_ids, b, l, q.device)
    args = [b, h, l, d, DTYPES[q.dtype], int(causal), *strides,
            _scale_bits(sm_scale)]
    return args, bias_e, seg


def flash_attn_fwd(q, k, v, causal: bool = True, sm_scale: float | None = None, bias=None,
                   segment_ids=None):
    """(o, lse): softmax(q k^T * sm_scale + bias) v at q's dtype, and the row
    logsumexp (B, H, L) f32 (+inf for a row that sees no key)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if on_cpu(q, k, v, bias, segment_ids):
        return plain.flash_attn_fwd_plain(q, k, v, causal, sm_scale, bias, segment_ids)
    b, h, l, d = _check_qkv(q, k, v)
    q, k, v = _aligned(q, k, v)
    args, bias_e, seg = _common(q, causal, sm_scale, bias, segment_ids)
    o = torch.empty_like(q)
    lse = torch.empty(b, h, l, dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attn")
    rc = lib.ffc_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), _ptr(bias_e),
        _ptr(seg), *args, _stream(q.device))
    _build.check(lib, rc, "flash_attn_fwd kernel")
    flash_attn_fwd.launches += 1
    return o, lse


flash_attn_fwd.launches = 0


def _check_stats(lse, delta, shape) -> None:
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != shape[:3] or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 {tuple(shape[:3])}, got "
                             f"{tuple(t.shape)} {t.dtype}")


def flash_attn_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                       sm_scale: float | None = None, bias=None, segment_ids=None):
    """(dk, dv) from the output grad do, the forward's logsumexp lse and
    delta = rowsum(do * o) (both (B, H, L) f32)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if on_cpu(q, k, v, do, lse, delta, bias, segment_ids):
        _, dk, dv, _ = plain.flash_attn_bwd_plain(q, k, v, None, lse, do, causal, sm_scale, bias,
                                                  segment_ids, delta=delta)
        return dk, dv
    _check_qkv(q, k, v, do)
    _check_stats(lse, delta, q.shape)
    q, k, v, do = _aligned(q, k, v, do)
    args, bias_e, seg = _common(q, causal, sm_scale, bias, segment_ids)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _build.load("flash_attn_bwd")
    rc = lib.ffc_flash_attn_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(bias_e), _ptr(seg), *args,
        _stream(q.device))
    _build.check(lib, rc, "flash_attn_bwd_dkv kernel")
    flash_attn_bwd_dkv.launches += 1
    return dk, dv


flash_attn_bwd_dkv.launches = 0


def flash_attn_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                      sm_scale: float | None = None, bias=None, segment_ids=None,
                      bias_grad: bool = False):
    """(dq, ds): dq, and with ``bias_grad`` the grad of the bias broadcast to
    (B, H, L, L) f32 (else None)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if on_cpu(q, k, v, do, lse, delta, bias, segment_ids):
        dq, _, _, ds = plain.flash_attn_bwd_plain(q, k, v, None, lse, do, causal, sm_scale,
                                                  bias, segment_ids, bias_grad, delta=delta)
        return dq, ds
    b, h, l, _ = _check_qkv(q, k, v, do)
    _check_stats(lse, delta, q.shape)
    q, k, v, do = _aligned(q, k, v, do)
    args, bias_e, seg = _common(q, causal, sm_scale, bias, segment_ids)
    dq = torch.empty_like(q)
    ds = torch.zeros(b, h, l, l, dtype=torch.float32, device=q.device) if bias_grad else None
    lib = _build.load("flash_attn_bwd")
    rc = lib.ffc_flash_attn_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), _ptr(ds), _ptr(bias_e), _ptr(seg), *args,
        _stream(q.device))
    _build.check(lib, rc, "flash_attn_bwd_dq kernel")
    flash_attn_bwd_dq.launches += 1
    return dq, ds


flash_attn_bwd_dq.launches = 0


class FlashAttnFunction(torch.autograd.Function):
    """Attention over (q, k, v, bias, segment_ids, causal, sm_scale) with the
    kernels' backward (the plain versions on CPU tensors). q, k, v, the bias
    and the output grad are made contiguous and the segment ids int32; grads
    come back at each input's dtype, the bias's summed to its shape."""

    @staticmethod
    def forward(ctx, q, k, v, bias, segment_ids, causal, sm_scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if segment_ids is not None:
            segment_ids = segment_ids.to(torch.int32).contiguous()
        o, lse = flash_attn_fwd(q, k, v, causal, sm_scale, bias, segment_ids)
        ctx.save_for_backward(q, k, v, o, lse, bias, segment_ids)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, bias, seg = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = plain.attention_delta(o, do)
        args = (ctx.causal, ctx.sm_scale, bias, seg)
        dk, dv = flash_attn_bwd_dkv(q, k, v, do, lse, delta, *args)
        bias_grad = bias is not None and ctx.needs_input_grad[3]
        dq, ds = flash_attn_bwd_dq(q, k, v, do, lse, delta, *args, bias_grad=bias_grad)
        dbias = ds.sum_to_size(bias.shape).to(bias.dtype) if bias_grad else None
        return dq, dk, dv, dbias, None, None, None


def _check_mask(mask, q) -> None:
    if q.ndim != 4 or mask.length != q.shape[2]:
        raise ValueError(f"the mask is over L={mask.length}, q has shape {tuple(q.shape)}")


def _splash_launch(name: str, fn_name: str, q, mask, sm_scale, pointers) -> None:
    """Launch ``fn_name`` of library ``name`` with the tensors' pointers,
    the mask's table and block mask, and the sizes."""
    b, h, l, d = q.shape
    table, blocks, ints = mask.kernel_args(q.device)
    lib = _build.load(name)
    rc = getattr(lib, fn_name)(*pointers, _ptr(table), _ptr(blocks), b, h, l, d,
                               DTYPES[q.dtype], *ints, _scale_bits(sm_scale),
                               _stream(q.device))
    _build.check(lib, rc, f"{fn_name} kernel")


def splash_attn_fwd(q, k, v, mask, sm_scale: float | None = None):
    """(o, lse) under ``mask`` (a ``SplashMask``): softmax(q k^T * sm_scale)
    v at q's dtype over the kept scores, and the row logsumexp (B, H, L) f32;
    a row that sees no key gives o = 0 and lse = +inf."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    _check_mask(mask, q)
    if on_cpu(q, k, v):
        return plain.splash_attn_fwd_plain(q, k, v, mask.dense(q.device), sm_scale)
    b, h, l, _ = _check_qkv(q, k, v)
    q, k, v = _aligned(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(b, h, l, dtype=torch.float32, device=q.device)
    _splash_launch("splash_attn", "ffc_splash_attn_fwd", q, mask, sm_scale,
                   [t.data_ptr() for t in (q, k, v, o, lse)])
    splash_attn_fwd.launches += 1
    return o, lse


splash_attn_fwd.launches = 0


def splash_attn_bwd_dkv(q, k, v, do, lse, delta, mask, sm_scale: float | None = None):
    """(dk, dv) under ``mask`` from the output grad do, the forward's
    logsumexp lse and delta = rowsum(do * o) (both (B, H, L) f32)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    _check_mask(mask, q)
    if on_cpu(q, k, v, do, lse, delta):
        _, dk, dv = plain.splash_attn_bwd_plain(q, k, v, None, lse, do, mask.dense(q.device),
                                                sm_scale, delta=delta)
        return dk, dv
    _check_qkv(q, k, v, do)
    _check_stats(lse, delta, q.shape)
    q, k, v, do = _aligned(q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _splash_launch("splash_attn_bwd", "ffc_splash_attn_bwd_dkv", q, mask, sm_scale,
                   [t.data_ptr() for t in (q, k, v, do, lse, delta, dk, dv)])
    splash_attn_bwd_dkv.launches += 1
    return dk, dv


splash_attn_bwd_dkv.launches = 0


def splash_attn_bwd_dq(q, k, v, do, lse, delta, mask, sm_scale: float | None = None):
    """dq under ``mask``, from the same inputs as ``splash_attn_bwd_dkv``."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    _check_mask(mask, q)
    if on_cpu(q, k, v, do, lse, delta):
        return plain.splash_attn_bwd_plain(q, k, v, None, lse, do, mask.dense(q.device),
                                           sm_scale, delta=delta)[0]
    _check_qkv(q, k, v, do)
    _check_stats(lse, delta, q.shape)
    q, k, v, do = _aligned(q, k, v, do)
    dq = torch.empty_like(q)
    _splash_launch("splash_attn_bwd", "ffc_splash_attn_bwd_dq", q, mask, sm_scale,
                   [t.data_ptr() for t in (q, k, v, do, lse, delta, dq)])
    splash_attn_bwd_dq.launches += 1
    return dq


splash_attn_bwd_dq.launches = 0


class SplashAttnFunction(torch.autograd.Function):
    """Attention over (q, k, v, mask, sm_scale), mask a ``SplashMask``, with
    the splash kernels forward and backward (the plain versions on CPU
    tensors). q, k, v and the output grad are made contiguous; grads come
    back at each input's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, mask, sm_scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = splash_attn_fwd(q, k, v, mask, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask, ctx.sm_scale = mask, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = plain.attention_delta(o, do)
        dk, dv = splash_attn_bwd_dkv(q, k, v, do, lse, delta, ctx.mask, ctx.sm_scale)
        dq = splash_attn_bwd_dq(q, k, v, do, lse, delta, ctx.mask, ctx.sm_scale)
        return dq, dk, dv, None, None
