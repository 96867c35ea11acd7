"""Multi-head attention ops of the JAX package's ``ops/attention.py`` (PyTorch).

Layout is (B, num_heads, L, head_dim) throughout, as in the JAX package.

``flash_mha`` is fused softmax attention. On CUDA tensors it runs the
hand-written flash-attention kernels (``ops/attention_cuda.py``:
``flash_attn_fwd``, and ``flash_attn_bwd_dkv`` and ``flash_attn_bwd_dq`` in
the backward) through ``FlashAttnFunction``, for every shape they take (q,
k, v of one shape, head_dim 64 or 128, f32 or bf16) and raises for any
other; the JAX package's TPU limits (L and head_dim multiples of 128) do
not apply here. On CPU tensors the same Function runs the plain versions
below. ``impl="xla"`` asks for the plain ``mha_reference`` on any device,
under the JAX package's name for it.

The sliding window (``window=``) and ``blocksparse_mha`` run JAX's splash
attention kernel on a TPU, which is not ported yet: on CUDA tensors they
raise NotImplementedError (unless ``impl="xla"`` asks for the plain
version), and on CPU tensors they run their plain versions, as the JAX
package does off-TPU.

The plain versions: ``mha_reference`` (the oracle, differentiated by
autograd), ``flash_attn_fwd_plain`` (the output and the row logsumexp the
forward kernel writes) and ``flash_attn_bwd_plain`` (the explicit softmax
backward, the CPU backward of ``FlashAttnFunction``). The bias convention
is flash_mha's: an additive f32 bias broadcastable to (B, H, L, L), added
after the ``sm_scale`` multiply.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from flashfftconv_tpu_torch.ops.monarch_cuda import on_cpu


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


def _window_mask(l_q: int, l_k: int, window: int, device=None) -> torch.Tensor:
    """Boolean (Lq, Lk) sliding-window causal mask: query i (aligned to the
    end of the key axis) sees keys (i - window, i]."""
    qpos = torch.arange(l_q, device=device)[:, None] + (l_k - l_q)
    kpos = torch.arange(l_k, device=device)[None, :]
    return (kpos <= qpos) & (kpos > qpos - window)


def masked_scores(q, k, causal, sm_scale, bias, window=None, segment_ids=None):
    """f32 (B, H, Lq, Lk) scores q k^T * sm_scale + bias, -inf where masked."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        scores = scores + bias.float()
    l_q, l_k = scores.shape[-2:]
    if window is not None:
        scores = scores.masked_fill(~_window_mask(l_q, l_k, window, q.device), -math.inf)
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
                         bias=None, segment_ids=None):
    """(o, lse): what ``flash_attn_fwd`` computes, in f32 and cast to v's
    dtype; lse (B, H, L) f32 is the row logsumexp of the masked scores, +inf
    for a row that sees no key (whose output is then 0)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    scores = masked_scores(q, k, causal, sm_scale, bias, segment_ids=segment_ids)
    lse = torch.logsumexp(scores, dim=-1)
    lse = lse.masked_fill(lse == -math.inf, math.inf)
    p = torch.exp(scores - lse[..., None])
    return (p @ v.float()).to(v.dtype), lse


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(do * o), f32 (B, H, L): the backward's softmax correction."""
    return (do.float() * o.float()).sum(-1)


def flash_attn_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                         sm_scale: float | None = None, bias=None, segment_ids=None,
                         bias_grad: bool = False, delta=None):
    """(dq, dk, dv, ds): the explicit softmax backward from the forward's
    output o and row logsumexp lse, with p = exp(s - lse), dp = do v^T and
    ds = p (dp - rowsum(do o)); dq = ds k * sm_scale, dk = ds^T q * sm_scale,
    dv = p^T do, each at its input's dtype. ds (B, H, L, L) f32 is the grad
    of the bias broadcast to that shape, returned when ``bias_grad`` (else
    None). ``delta`` may be given in place of o."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if delta is None:
        delta = attention_delta(o, do)
    scores = masked_scores(q, k, causal, sm_scale, bias, segment_ids=segment_ids)
    p = torch.exp(scores - lse[..., None])
    dof = do.float()
    dv = p.transpose(-1, -2) @ dof
    ds = p * (dof @ v.float().transpose(-1, -2) - delta[..., None])
    dq = (ds @ k.float()) * sm_scale
    dk = (ds.transpose(-1, -2) @ q.float()) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds if bias_grad else None


def _splash_not_ported(what: str):
    return NotImplementedError(
        f"{what} runs JAX's splash-attention kernel on a TPU, which is not ported to CUDA "
        "yet; pass CPU tensors or impl='xla' for the plain version"
    )


def flash_mha(q, k, v, causal: bool = True, sm_scale: float | None = None, impl: str = "auto",
              bias=None, window: int | None = None, segment_ids=None) -> torch.Tensor:
    """Fused multi-head attention, shapes (B, num_heads, L, head_dim).

    impl: 'auto' (the flash-attention kernels on CUDA tensors, their plain
    versions on CPU tensors), 'flash' (the kernels; raises on CPU tensors),
    'xla' (the plain ``mha_reference`` wherever the tensors are).
    bias: additive bias broadcastable to (B, H, L, L), e.g. ``alibi_bias``,
    added after the sm_scale multiply; differentiable.
    window: sliding-window width (the splash kernel on a TPU; see above).
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
    if window is not None or q.shape != k.shape:
        if not cpu:
            if window is not None:
                raise _splash_not_ported("flash_mha(window=...)")
            raise ValueError(f"the flash-attention kernels take q, k, v of one shape, got "
                             f"{tuple(q.shape)}, {tuple(k.shape)}")
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale, bias=bias,
                             window=window, segment_ids=segment_ids)
    from flashfftconv_tpu_torch.ops.attention_cuda import FlashAttnFunction

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
    the kept blocks. A row that sees no key gives zeros. The plain dense-mask
    version; the splash kernel that skips zero blocks on a TPU is not ported
    yet (see the module docstring)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    l = q.shape[2]
    blockmask = np.asarray(blockmask, bool)
    nr, nc = blockmask.shape
    if nr * block_size != l or nc * block_size != l:
        raise ValueError(f"blockmask {blockmask.shape} x block_size {block_size} "
                         f"does not tile L={l}")
    if impl != "xla" and not on_cpu(q, k, v):
        raise _splash_not_ported("blocksparse_mha")
    dense = np.kron(blockmask, np.ones((block_size, block_size), bool))
    if causal:
        dense &= np.tril(np.ones((l, l), bool))
    keep = torch.from_numpy(dense).to(q.device)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    attn = scores.masked_fill(~keep, -math.inf).softmax(-1)
    attn = attn.masked_fill(~keep.any(1)[:, None], 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", attn.to(v.dtype), v)
