"""Sequence-sharded FFT convolution over a ``torch.distributed`` mesh.

Port of the JAX package's ``parallel/seq_conv.py`` (context parallelism).
Write N = P * N2 with P the size of the mesh dimension ``axis``; then

  FFT_N(x)[m2*P + m1] = DFT_{N2, n2->m2}( W_N^{m1*n2} * DFT_{P, n1->m1}(x[n1*N2+n2]) )

Rank e holds chunk e of the sequence, (..., H, N2). ``_scatter`` and
``_gather`` are the distributed-FFT transpose (an ``all_to_all_single`` over
equal splits), the P-point outer DFT and the twiddle run on every rank, and
each rank convolves its band m1 = e, a general complex signal of N2 points,
with the band's slice of the kernel's spectrum (``_band_spectrum``). Then
the conjugate twiddle, the outer inverse DFT and the gather give back the
rank's chunk of y; the imaginary part is dropped before the last gather.
Gates act locally.

The band conv routes by N2:
  - 16 <= N2 <= 16384: ``BandConvFunction``, the ``band_conv`` kernel
    (csrc/band_conv.cu, the TPU kernel ``_conv_tiles``' complex contract)
    forward and for db, its dk_f through the Monarch matmul chain;
  - N2 >= 32768: a row of N2 complex points no longer fits one block, and
    the band conv is four real circular convs at FFT size N2 through
    ``FftConvFunction``: with the band kernel in time k = kr + i ki,
    conv(b, k) = conv(br, kr) - conv(bi, ki) + i (conv(br, ki) + conv(bi, kr)),
    on ``monarch_conv`` at 32768 and the long kernels from 65536 up, with
    their backward kernels.
On CPU tensors every kernel wrapper runs its plain version. The band conv
computes in f32 whatever the input's dtype (the JAX package's
``compute_dtype`` and ``impl`` have no counterpart here).

Every collective is differentiable: the adjoint of an all-to-all is the
all-to-all with the send and receive splits swapped. ``seq_fft_conv_padded``
redistributes the chunks of u (L/P samples a rank) into the chunks of the
zero-padded length-N array and back (the JAX package lets GSPMD pad the
sharded array). ``seq_halo`` hands each rank the last samples of the
previous rank's chunk, for the short causal conv.

The mesh is a ``DeviceMesh`` with a named dimension, as
``init_device_mesh("cuda", (P,), mesh_dim_names=("sp",))`` builds it; every
rank passes and receives its own chunk.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from flashfftconv_tpu_torch.ops import monarch
from flashfftconv_tpu_torch.ops.monarch_cuda import (
    BAND_CONV_MAX,
    BandConvFunction,
    FftConvFunction,
)
from flashfftconv_tpu_torch.ops.plan import get_plan


def _axis(mesh, axis: str):
    """(process group, P, this rank's index e) of the mesh dimension."""
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def _all_to_all(x: torch.Tensor, send, recv, group) -> torch.Tensor:
    """``all_to_all_single`` along dim 0: send[r] rows to rank r, recv[s]
    rows from rank s, in rank order; complex tensors travel as real pairs."""
    x = x.contiguous()
    real = torch.view_as_real(x) if x.is_complex() else x
    out = real.new_empty((sum(recv), *real.shape[1:]))
    dist.all_to_all_single(out, real, list(recv), list(send), group=group)
    return torch.view_as_complex(out) if x.is_complex() else out


class _AllToAll(torch.autograd.Function):
    """``_all_to_all`` with its adjoint, the same exchange with the splits
    swapped."""

    @staticmethod
    def forward(ctx, x, send, recv, group):
        ctx.send, ctx.recv, ctx.group = send, recv, group
        return _all_to_all(x, send, recv, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.recv, ctx.send, ctx.group), None, None, None


def _block_transpose(x: torch.Tensor, group, p: int) -> torch.Tensor:
    """(..., P, Q): block j of axis -2 goes to rank j; on return block d of
    axis -2 is what rank d sent (a tiled all_to_all over axis -2)."""
    y = _AllToAll.apply(x.movedim(-2, 0), [1] * p, [1] * p, group)
    return y.movedim(0, -2)


def _scatter(x: torch.Tensor, group, p: int) -> torch.Tensor:
    """(..., N2) -> (..., P, Q) with axis -2 indexing the *source* rank: on
    entry every rank holds one chunk (or band) of the sequence; on exit it
    holds every chunk's (or band's) j-block e, e = this rank."""
    return _block_transpose(x.reshape(*x.shape[:-1], p, x.shape[-1] // p), group, p)


def _gather(x: torch.Tensor, group, p: int) -> torch.Tensor:
    """(..., P, Q) with axis -2 the chunk (or band) index -> (..., N2): rank d
    ends up holding the full-length row d (the inverse of ``_scatter``)."""
    y = _block_transpose(x, group, p)
    return y.reshape(*y.shape[:-2], y.shape[-2] * y.shape[-1])


def _outer_dft_matrices(p: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, Winv): the P-point DFT across chunks and its inverse (1/P folded
    in), complex64, exact integer-mod phases."""
    idx = np.arange(p, dtype=np.int64)
    w = np.exp(-2j * np.pi * ((idx[:, None] * idx[None, :]) % p) / p)
    as_c64 = lambda a: torch.from_numpy(a.astype(np.complex64)).to(device)
    return as_c64(w), as_c64(w.conj().T / p)


def _outer_mm(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Complex matmul along axis -2 (the chunk or band axis): x (..., P, Q)."""
    return torch.einsum("mn,...nq->...mq", w, x.to(torch.complex64))


@functools.lru_cache(maxsize=16)
def _twiddle(p: int, q: int, n: int, e: int, conj: bool, device) -> torch.Tensor:
    """W_N^{m1 * n2} for m1 in [0, P), n2 = e*Q + j, j in [0, Q): (P, Q)
    complex64, phases exact integer products reduced mod N. Kept per
    (shape, rank, direction, device), as a constant of a jitted JAX step is:
    each table is a host pass over N2 points (4M in the ultra-long CLI) and
    a layer's conv reads three a step."""
    m1 = np.arange(p, dtype=np.int64)[:, None]
    n2 = e * q + np.arange(q, dtype=np.int64)[None, :]
    tw = np.exp((2j if conj else -2j) * np.pi * ((m1 * n2) % n) / n)
    return torch.from_numpy(tw.astype(np.complex64)).to(device)


def _band_kernel(k_loc, group, p, q, n, e, w) -> torch.Tensor:
    """This rank's band m1 = e of the kernel, in time: the kernel chunk
    through the same scatter -> outer DFT -> twiddle -> gather as the input.
    Complex64 (H, N2); its N2-point DFT is the band of the kernel's N-point
    spectrum."""
    ks = _outer_mm(w, _scatter(k_loc.float(), group, p))
    return _gather(ks * _twiddle(p, q, n, e, False, k_loc.device), group, p)


def _band_spectrum(k_loc, plan2, group, p, q, n, e, w) -> torch.Tensor:
    """This rank's band of the kernel's N-point spectrum, natural order: the
    inner DFT (the plan's Monarch chain) of ``_band_kernel``."""
    return monarch.cfft_plain(plan2, _band_kernel(k_loc, group, p, q, n, e, w))


def _band_conv_composed(b: torch.Tensor, kt: torch.Tensor) -> torch.Tensor:
    """ifft_N2(fft_N2(b) * fft_N2(kt)) for complex b (..., H, N2) and the
    complex band kernel in time kt (H, N2), as four real circular convs at
    FFT size N2 through ``FftConvFunction`` (two calls over (br, bi))."""
    plan = get_plan(b.shape[-1], torch.float32, b.device)
    x = torch.stack((b.real, b.imag))
    by_kr = FftConvFunction.apply(plan, x, kt.real.contiguous(), None, None)
    by_ki = FftConvFunction.apply(plan, x, kt.imag.contiguous(), None, None)
    return torch.complex(by_kr[0] - by_ki[1], by_ki[0] + by_kr[1])


def seq_fft_conv(
    u: torch.Tensor,
    k: torch.Tensor,
    mesh,
    axis: str = "sp",
    pregate: torch.Tensor | None = None,
    postgate: torch.Tensor | None = None,
) -> torch.Tensor:
    """Circular FFT conv of size N = P * N2 with the sequence sharded over
    ``mesh[axis]``: ``out = postgate * ifft(fft(pregate * u) * fft(k)).real``
    of the global signals, each rank holding chunk e of u, k and the gates.

    Args:
      u: (..., H, N2) this rank's chunk of the real input.
      k: (H, N2) this rank's chunk of the full-length (N) real kernel.
      mesh: a DeviceMesh whose ``axis`` dimension (size P) carries the
        sequence. N2 a power of two >= 16 and N2 % P == 0.
      pregate/postgate: optional (..., H, N2) chunks of the gates.

    Returns (..., H, N2): this rank's chunk of the output, at u's dtype.
    """
    group, p, e = _axis(mesh, axis)
    n2 = u.shape[-1]
    n = p * n2
    if k.shape[-1] != n2:
        raise ValueError(f"kernel chunk length {k.shape[-1]} != input chunk length {n2}; "
                         f"pad the kernel to seqlen {n} first")
    if n % p != 0 or (n // p) % p != 0:
        raise ValueError(f"seqlen {n} not tileable over {p} devices")
    if n2 & (n2 - 1) or n2 < 16:
        raise ValueError(f"per-device length {n2} must be a power of two >= 16")
    q = n2 // p
    w, w_inv = _outer_dft_matrices(p, u.device)
    out_dtype = u.dtype
    if pregate is not None:
        u = u * pregate
    xs = _scatter(u.float(), group, p)  # (..., P=n1, Q)
    a = _outer_mm(w, xs) * _twiddle(p, q, n, e, False, u.device)  # DFT across chunks
    b = _gather(a, group, p)  # band m1 = e, full N2
    if n2 > BAND_CONV_MAX:
        d = _band_conv_composed(b, _band_kernel(k, group, p, q, n, e, w))
    else:
        plan2 = get_plan(2 * n2, torch.float32, u.device)  # inner complex length N2
        d = BandConvFunction.apply(plan2, b, _band_spectrum(k, plan2, group, p, q, n, e, w))
    d = _scatter(d, group, p) * _twiddle(p, q, n, e, True, u.device)  # (..., P=m1, Q)
    # the inverse DFT across bands (with 1/P); the imaginary part is ~0 for a
    # real input and is dropped before the gather
    out = _gather(_outer_mm(w_inv, d).real, group, p)  # chunk n1 = e of y
    if postgate is not None:
        out = out * postgate.float()
    return out.to(out_dtype)


def _overlap(a0: int, alen: int, b0: int, blen: int, end: int) -> int:
    return max(0, min(a0 + alen, b0 + blen, end) - max(a0, b0))


def _rechunk(x: torch.Tensor, dst: int, valid: int, group, p: int, e: int) -> torch.Tensor:
    """(..., src) chunks of a sequence, chunk e on rank e, -> (..., dst)
    chunks of the same positions: samples at or past ``valid`` are dropped
    on the way and zero on arrival. Its adjoint is the rechunk back."""
    src = x.shape[-1]
    send = [_overlap(e * src, src, r * dst, dst, valid) for r in range(p)]
    recv = [_overlap(s * src, src, e * dst, dst, valid) for s in range(p)]
    y = _AllToAll.apply(x[..., : sum(send)].movedim(-1, 0), send, recv, group).movedim(0, -1)
    return F.pad(y, (0, dst - sum(recv)))


def seq_fft_conv_padded(
    u: torch.Tensor,
    k: torch.Tensor,
    mesh,
    seqlen: int | None = None,
    axis: str = "sp",
    pregate: torch.Tensor | None = None,
    postgate: torch.Tensor | None = None,
) -> torch.Tensor:
    """Linear (causal) conv at L < N via zero-padding, sequence-sharded.

    The length-L chunks of u and the gates (L/P samples a rank) are
    redistributed into the chunks of the zero-padded length-N arrays (N/P
    samples a rank: u's samples where they exist, zeros elsewhere), the
    circular ``seq_fft_conv`` runs at size N, and the first L samples go back
    as chunks of L/P.

    Args:
      u: (..., H, L/P) this rank's chunk of the real input; L = P * L/P, and
        seqlen defaults to 2L (the model layers' convention for making the
        circular conv linear).
      k: (H, k_len) the full real kernel, the same on every rank, k_len <=
        seqlen; each rank takes its chunk of the zero-padded kernel.
      pregate/postgate: optional (..., H, L/P) chunks of the gates.
    Returns (..., H, L/P): this rank's chunk of the output.
    """
    group, p, e = _axis(mesh, axis)
    chunk = u.shape[-1]
    length = p * chunk
    n = seqlen or 2 * length
    if length > n:
        raise ValueError(f"input length {length} > seqlen {n}")
    if n % p != 0:
        raise ValueError(f"seqlen {n} not tileable over {p} devices")
    if k.shape[-1] > n:
        raise ValueError(f"kernel length {k.shape[-1]} > seqlen {n}")
    c = n // p

    def padded(x):
        return None if x is None else _rechunk(x, c, length, group, p, e)

    k_loc = F.pad(k, (0, n - k.shape[-1]))[..., e * c : (e + 1) * c]
    out = seq_fft_conv(padded(u), k_loc, mesh, axis=axis, pregate=padded(pregate),
                       postgate=padded(postgate))
    return _rechunk(out, chunk, length, group, p, e)


def seq_halo(x_last: torch.Tensor, mesh, axis: str = "sp") -> torch.Tensor:
    """The previous rank's ``x_last`` (its chunk's last K - 1 columns, (...,
    K - 1)), zeros on rank 0: the history of a causal short conv over the
    sharded sequence. Differentiable: the halo's grad goes back to the rank
    that sent it."""
    group, p, e = _axis(mesh, axis)
    k1 = x_last.shape[-1]
    if p == 1:
        return torch.zeros_like(x_last)
    send = [k1 if r == e + 1 else 0 for r in range(p)]
    recv = [k1 if s == e - 1 else 0 for s in range(p)]
    x = x_last[..., : sum(send)].movedim(-1, 0)
    y = _AllToAll.apply(x, send, recv, group).movedim(0, -1)
    return F.pad(y, (k1 - sum(recv), 0))


def seq_group(model: torch.nn.Module):
    """The process group of the sequence mesh a model's mixers run on, or
    None when no module of the model has a ``seq_mesh``."""
    for module in model.modules():
        mesh = getattr(module, "seq_mesh", None)
        if mesh is not None:
            return mesh.get_group(module.seq_axis)
    return None


def seq_backward(model: torch.nn.Module, loss: torch.Tensor, n_local: int, group) -> torch.Tensor:
    """The backward of a train step whose sequence is sharded over ``group``.

    ``loss`` is the mean over this rank's ``n_local`` tokens. The global mean
    is the sum over ranks of each rank's local sum over the global token
    count: each rank runs the backward of its share, then the grads of the
    replicated parameters are summed over the group, so that every rank
    holds the global mean's grads and takes the same optimizer step.
    Returns the global mean loss, detached, the same on every rank."""
    count = torch.tensor(float(n_local), device=loss.device)
    dist.all_reduce(count, group=group)
    share = loss * (n_local / count)
    share.backward()
    total = share.detach().clone()
    dist.all_reduce(total, group=group)
    for prm in model.parameters():
        if prm.grad is not None:
            dist.all_reduce(prm.grad, group=group)
    return total


__all__ = ["seq_fft_conv", "seq_fft_conv_padded", "seq_halo", "seq_group", "seq_backward"]
