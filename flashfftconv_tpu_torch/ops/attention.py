"""Multi-head attention ops of the JAX package's ``ops/attention.py`` (PyTorch).

Layout is (B, num_heads, L, head_dim) throughout, as in the JAX package.

``flash_mha`` is fused softmax attention. On CUDA tensors it runs the
hand-written flash-attention kernels (``ops/attention_cuda.py``:
``flash_attn_fwd``, and ``flash_attn_bwd_dkv`` and ``flash_attn_bwd_dq`` in
the backward) through ``FlashAttnFunction``, for every shape they take (q,
k, v of one shape, head_dim 64, 128, 256, 384 or 512, f32, bf16 or f16, any
B * H: ``attention_cuda.kernels_take``); the JAX package's TPU limits (L and
head_dim multiples of 128) do not apply here. Where the kernels refuse a
CUDA call, ``impl="auto"`` runs the plain ``mha_reference`` if the JAX
package's ``auto`` would run XLA there too (L < 256, or L or head_dim not a
multiple of 128), and raises where its TPU kernel would run (head_dim above
512, q and k of different shapes); ``impl="flash"`` raises. On CPU tensors
the same Function runs the plain versions below.
``impl="xla"`` asks for the plain ``mha_reference`` on any device, under
the JAX package's name for it.

The sliding window (``flash_mha(window=W)``) and ``blocksparse_mha`` run
JAX's splash attention on a TPU. Here they run the hand-written splash
kernels (``splash_attn_fwd``, ``splash_attn_bwd_dkv``, ``splash_attn_bwd_dq``)
through ``SplashAttnFunction`` on CUDA tensors, under a ``SplashMask``
(``ops/splash_mask.py``) whose hidden tiles the kernels skip, and the same
Function's plain versions on CPU tensors. A window with a bias or segment
ids raises NotImplementedError where the kernels would run (CUDA tensors
they take, or any under ``impl="flash"``), as the JAX package's TPU path
does, and runs ``mha_reference`` elsewhere, as the JAX package does off a
TPU or where its kernel does not tile. ``blocksparse_mha`` under ``auto``
likewise runs its plain dense-mask softmax where the kernels refuse and
the JAX package's kernel would not run. A row
that sees no key gives 0, as the JAX package's plain version documents.

The plain versions: ``mha_reference`` (the oracle, differentiated by
autograd), ``flash_attn_fwd_plain`` (the output and the row logsumexp the
forward kernel writes), ``flash_attn_bwd_plain`` (the explicit softmax
backward, the CPU backward of ``FlashAttnFunction``) and their splash
counterparts ``splash_attn_fwd_plain`` and ``splash_attn_bwd_plain``, which
take the mask as a dense (L, L) boolean. The bias convention is
flash_mha's: an additive f32 bias broadcastable to (B, H, L, L), added
after the ``sm_scale`` multiply.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from flashfftconv_tpu_torch.ops.monarch_cuda import on_cpu
from flashfftconv_tpu_torch.ops.splash_mask import SplashMask, window_keep


def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """Per-head ALiBi slopes (Press et al.): for a power-of-2 head count the
    geometric series 2^(-8/n), 2^(-16/n), ...; otherwise the nearest
    power-of-2 series interleaved with its sqrt-ratio refinement. f32 (H,)."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        slopes = pow2_slopes(num_heads)
    else:
        base = 2 ** int(math.floor(math.log2(num_heads)))
        slopes = pow2_slopes(base) + pow2_slopes(2 * base)[0::2][: num_heads - base]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def alibi_bias(num_heads: int, l_q: int, l_k: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """(1, H, Lq, Lk) additive bias -slope_h * |i - j|, query position i
    aligned to the end of the key axis."""
    slopes = alibi_slopes(num_heads, device)
    qpos = torch.arange(l_q, device=device) + (l_k - l_q)
    kpos = torch.arange(l_k, device=device)
    dist = (qpos[:, None] - kpos[None, :]).abs().float()
    return (-slopes[:, None, None] * dist)[None].to(dtype)


def masked_scores(q, k, causal, sm_scale, bias, window=None, segment_ids=None, keep=None):
    """f32 (B, H, Lq, Lk) scores q k^T * sm_scale + bias, -inf where masked;
    ``keep`` an optional (Lq, Lk) boolean mask besides."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        scores = scores + bias.float()
    l_q, l_k = scores.shape[-2:]
    if keep is not None:
        scores = scores.masked_fill(~keep, -math.inf)
    if window is not None:
        scores = scores.masked_fill(~window_keep(l_q, l_k, window, q.device), -math.inf)
    elif causal:
        keep = torch.ones(l_q, l_k, dtype=torch.bool, device=q.device).tril(l_k - l_q)
        scores = scores.masked_fill(~keep, -math.inf)
    if segment_ids is not None:
        same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        scores = scores.masked_fill(~same, -math.inf)
    return scores


def mha_reference(q, k, v, causal: bool = True, sm_scale: float | None = None, bias=None,
                  window: int | None = None, segment_ids=None) -> torch.Tensor:
    """O(L^2) softmax attention, f32 scores; the JAX package's oracle. Shapes
    (B, H, L, D); bias broadcastable to (B, H, Lq, Lk), added after the
    scale; window a sliding-window width (implies causal banding);
    segment_ids (B, L) int, tokens attend only within equal ids."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    scores = masked_scores(q, k, causal, sm_scale, bias, window, segment_ids)
    attn = scores.softmax(-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v)


def flash_attn_fwd_plain(q, k, v, causal: bool = True, sm_scale: float | None = None,
                         bias=None, segment_ids=None, keep=None):
    """(o, lse): what ``flash_attn_fwd`` computes, in f32 and cast to v's
    dtype; lse (B, H, L) f32 is the row logsumexp of the masked scores, +inf
    for a row that sees no key (whose output is then 0). ``keep``: an
    optional (L, L) boolean mask besides."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    scores = masked_scores(q, k, causal, sm_scale, bias, segment_ids=segment_ids, keep=keep)
    lse = torch.logsumexp(scores, dim=-1)
    lse = lse.masked_fill(lse == -math.inf, math.inf)
    p = torch.exp(scores - lse[..., None])
    return (p @ v.float()).to(v.dtype), lse


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(do * o), f32 (B, H, L): the backward's softmax correction."""
    return (do.float() * o.float()).sum(-1)


def flash_attn_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                         sm_scale: float | None = None, bias=None, segment_ids=None,
                         bias_grad: bool = False, delta=None, keep=None):
    """(dq, dk, dv, ds): the explicit softmax backward from the forward's
    output o and row logsumexp lse, with p = exp(s - lse), dp = do v^T and
    ds = p (dp - rowsum(do o)); dq = ds k * sm_scale, dk = ds^T q * sm_scale,
    dv = p^T do, each at its input's dtype. ds (B, H, L, L) f32 is the grad
    of the bias broadcast to that shape, returned when ``bias_grad`` (else
    None). ``delta`` may be given in place of o; ``keep`` is an optional
    (L, L) boolean mask besides."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if delta is None:
        delta = attention_delta(o, do)
    scores = masked_scores(q, k, causal, sm_scale, bias, segment_ids=segment_ids, keep=keep)
    p = torch.exp(scores - lse[..., None])
    dof = do.float()
    dv = p.transpose(-1, -2) @ dof
    ds = p * (dof @ v.float().transpose(-1, -2) - delta[..., None])
    dq = (ds @ k.float()) * sm_scale
    dk = (ds.transpose(-1, -2) @ q.float()) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds if bias_grad else None


def splash_attn_fwd_plain(q, k, v, keep, sm_scale: float | None = None):
    """(o, lse): what ``splash_attn_fwd`` computes under the (L, L) boolean
    mask ``keep`` (``SplashMask.dense()``): o 0 and lse +inf on a row that
    sees no key."""
    return flash_attn_fwd_plain(q, k, v, False, sm_scale, keep=keep)


def splash_attn_bwd_plain(q, k, v, o, lse, do, keep, sm_scale: float | None = None,
                          delta=None):
    """(dq, dk, dv): what ``splash_attn_bwd_dq`` and ``splash_attn_bwd_dkv``
    compute under ``keep``; ``delta`` may be given in place of o."""
    return flash_attn_bwd_plain(q, k, v, o, lse, do, False, sm_scale, delta=delta,
                                keep=keep)[:3]


# The JAX package's TPU kernels take L >= 256 with L and head_dim multiples
# of 128 (its _flash_ok); its 'auto' runs the plain version elsewhere.
_TPU_MIN_FLASH_LEN = 256


def _auto_runs_plain(q, k, v) -> bool:
    """Whether ``impl='auto'`` runs the plain version on these CUDA tensors:
    where the kernels refuse them (``attention_cuda.kernels_take``) and the
    JAX package's 'auto' would not run its TPU kernel either. A call that
    its TPU kernel takes and these kernels refuse (head_dim above 512, q and k
    of different shapes) goes to the kernels and raises."""
    from flashfftconv_tpu_torch.ops.attention_cuda import kernels_take

    if kernels_take(q, k, v) or q.ndim != 4:
        return False
    _, _, l, d = q.shape
    return not (l >= _TPU_MIN_FLASH_LEN and l % 128 == 0 and d % 128 == 0)


def flash_mha(q, k, v, causal: bool = True, sm_scale: float | None = None, impl: str = "auto",
              bias=None, window: int | None = None, segment_ids=None) -> torch.Tensor:
    """Fused multi-head attention, shapes (B, num_heads, L, head_dim).

    impl: 'auto' (the flash-attention kernels on CUDA tensors they take,
    ``mha_reference`` on other CUDA tensors the JAX package's 'auto' runs
    in XLA too (``_auto_runs_plain``), the kernels' plain versions on CPU
    tensors), 'flash' (the kernels; raises on CPU tensors and where the
    kernels refuse), 'xla' (the plain ``mha_reference`` wherever the tensors
    are).
    bias: additive bias broadcastable to (B, H, L, L), e.g. ``alibi_bias``,
    added after the sm_scale multiply; differentiable.
    window: sliding-window width (causal implied): the splash kernels, which
    skip the tiles outside the window (see above).
    segment_ids: (B, L) int; tokens attend only within equal ids, the packed
    form of variable-length batches (``pack_sequences`` builds them).
    """
    if impl not in ("auto", "flash", "xla"):
        raise ValueError(f"impl must be 'auto', 'flash' or 'xla', got {impl!r}")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    cpu = on_cpu(q, k, v, bias, segment_ids)
    if impl == "xla":
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale, bias=bias,
                             window=window, segment_ids=segment_ids)
    if impl == "flash" and cpu:
        raise ValueError("impl='flash' runs the CUDA kernels and needs CUDA tensors; "
                         "impl='auto' runs the plain version on CPU tensors")
    from flashfftconv_tpu_torch.ops.attention_cuda import FlashAttnFunction, SplashAttnFunction

    masked = window is not None and (bias is not None or segment_ids is not None)
    if cpu:
        plain = masked or q.shape != k.shape
    else:
        plain = impl == "auto" and _auto_runs_plain(q, k, v)
        if masked and not plain:
            raise NotImplementedError(
                "flash_mha(window=...) with a bias or segment ids: the splash kernels "
                "take neither (as on a TPU); use impl='xla'")
    if plain:
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale, bias=bias,
                             window=window, segment_ids=segment_ids)
    if window is not None:
        return SplashAttnFunction.apply(q, k, v, SplashMask.local(q.shape[2], window),
                                        float(sm_scale))
    return FlashAttnFunction.apply(q, k, v, bias, segment_ids, causal, float(sm_scale))


def pack_sequences(seqs, pack_len: int, pad_id: int = 0):
    """Pack variable-length sequences into fixed (rows, pack_len) buffers with
    per-token segment ids, greedy first fit. seqs: list of (l_i, ...) arrays.
    Returns (packed (rows, pack_len, ...) zero-padded, segment_ids (rows,
    pack_len) int32 with 1-based ids per sequence and ``pad_id`` in pad
    slots, index {sequence: (row, start)}). Numpy in, numpy out."""
    rows: list[list] = []
    space: list[int] = []
    for i, s in enumerate(seqs):
        li = s.shape[0]
        if li > pack_len:
            raise ValueError(f"sequence {i} length {li} > pack_len {pack_len}")
        for r in range(len(rows)):
            if space[r] >= li:
                rows[r].append((i, s))
                space[r] -= li
                break
        else:
            rows.append([(i, s)])
            space.append(pack_len - li)

    first = np.asarray(seqs[0])
    packed = np.zeros((len(rows), pack_len, *first.shape[1:]), first.dtype)
    seg = np.full((len(rows), pack_len), pad_id, np.int32)
    index: dict[int, tuple[int, int]] = {}
    for r, row in enumerate(rows):
        off = 0
        for i, s in row:
            li = s.shape[0]
            packed[r, off : off + li] = np.asarray(s)
            seg[r, off : off + li] = i + 1
            index[i] = (r, off)
            off += li
    return packed, seg, index


def blocksparse_mha(q, k, v, blockmask, block_size: int = 256, causal: bool = False,
                    sm_scale: float | None = None, impl: str = "auto") -> torch.Tensor:
    """Block-sparse attention: blockmask is a static (L / block_size,
    L / block_size) 0/1 array; block (r, c) == 0 hides keys of column block c
    from queries of row block r, and causal also lower-triangularises within
    the kept blocks. A row that sees no key gives zeros.

    impl: 'auto' (the splash kernels, which skip the hidden tiles, on CUDA
    tensors they take, the dense-mask softmax on other CUDA tensors the
    JAX package's 'auto' runs in XLA too; the kernels' plain versions on
    CPU tensors), 'flash' (the kernels; raises on
    CPU tensors and where the kernels refuse), 'xla' (the plain dense-mask
    softmax anywhere)."""
    if impl not in ("auto", "flash", "xla"):
        raise ValueError(f"impl must be 'auto', 'flash' or 'xla', got {impl!r}")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    l = q.shape[2]
    blockmask = np.asarray(blockmask, bool)
    nr, nc = blockmask.shape
    if nr * block_size != l or nc * block_size != l:
        raise ValueError(f"blockmask {blockmask.shape} x block_size {block_size} "
                         f"does not tile L={l}")
    from flashfftconv_tpu_torch.ops.attention_cuda import SplashAttnFunction

    mask = SplashMask.blocks(blockmask, block_size, causal)
    cpu = on_cpu(q, k, v)
    if impl == "xla" or (impl == "auto" and not cpu and _auto_runs_plain(q, k, v)):
        keep = mask.dense(q.device)
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
        attn = scores.masked_fill(~keep, -math.inf).softmax(-1)
        attn = attn.masked_fill(~keep.any(1)[:, None], 0.0)
        return torch.einsum("bhqk,bhkd->bhqd", attn.to(v.dtype), v)
    if impl == "flash" and cpu:
        raise ValueError("impl='flash' runs the CUDA kernels and needs CUDA tensors; "
                         "impl='auto' runs the plain version on CPU tensors")
    return SplashAttnFunction.apply(q, k, v, mask, float(sm_scale))
