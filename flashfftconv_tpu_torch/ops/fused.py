"""Fused elementwise ops of the JAX package's ``ops/fused.py`` (PyTorch).

The JAX module gives named forms of the reference's fused CUDA extensions
(dense + GELU, dropout + residual + LayerNorm or RMSNorm, scaled masked
softmax, rotary embedding, cross entropy) as plain XLA compositions, not
Pallas kernels; here they are plain torch with the same semantics: f32
inside, the result in the input's dtype. The dropout ops take a
``torch.Generator`` where the JAX ones take an ``rng`` key, so their masks
are another draw of the same distribution. ``vocab_parallel_cross_entropy``
is the cross entropy over logits split on the vocabulary over a mesh
dimension, with explicit collectives where the JAX one runs under
``shard_map``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


def dense_bias_gelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """gelu(x @ w + b), w (in, out) as the JAX function takes it: the product
    in x's dtype, the bias and flax's (tanh) GELU in f32, the result in x's
    dtype."""
    y = (x @ w.to(x.dtype)).float() + b.float()
    return F.gelu(y, approximate="tanh").to(x.dtype)


def _dropout_add(x, residual, dropout_rate, generator, deterministic):
    """f32 dropout(x) (+ residual): the pre-norm residual of the norm ops."""
    h = x.float()
    if not deterministic and dropout_rate > 0:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - dropout_rate
        h = torch.where(keep, h / (1.0 - dropout_rate), 0.0)
    return h if residual is None else h + residual.float()


def dropout_add_layer_norm(x, residual, weight, bias, dropout_rate: float,
                           generator: torch.Generator | None = None,
                           deterministic: bool = True, eps: float = 1e-5,
                           prenorm: bool = False):
    """LayerNorm(dropout(x) + residual) * weight + bias in f32, returned in
    x's dtype; with ``prenorm`` also the f32 pre-norm residual. ``residual``
    may be None. Dropout draws its keep mask from ``generator`` unless
    ``deterministic``."""
    res = _dropout_add(x, residual, dropout_rate, generator, deterministic)
    out = F.layer_norm(res, res.shape[-1:], weight.float(), bias.float(), eps).to(x.dtype)
    return (out, res) if prenorm else out


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x / sqrt(mean(x^2) + eps) * weight in f32 (no mean subtraction, no
    bias), returned in x's dtype."""
    h = x.float()
    ms = (h * h).mean(-1, keepdim=True)
    return (h * torch.rsqrt(ms + eps) * weight.float()).to(x.dtype)


def dropout_add_rms_norm(x, residual, weight, dropout_rate: float,
                         generator: torch.Generator | None = None,
                         deterministic: bool = True, eps: float = 1e-5,
                         prenorm: bool = False):
    """``rms_norm(dropout(x) + residual)``, as ``dropout_add_layer_norm``."""
    res = _dropout_add(x, residual, dropout_rate, generator, deterministic)
    out = rms_norm(res, weight, eps=eps).to(x.dtype)
    return (out, res) if prenorm else out


def scaled_masked_softmax(scores: torch.Tensor, mask: torch.Tensor | None = None,
                          scale: float = 1.0) -> torch.Tensor:
    """softmax(scores * scale) over the last dim in f32, -1e9 where the
    boolean ``mask`` is False; returned in scores' dtype."""
    s = scores.float() * scale
    if mask is not None:
        s = torch.where(mask, s, -1e9)
    return s.softmax(-1).to(scores.dtype)


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary position embedding over the last dim of x (..., L, D): its two
    halves (non-interleaved, GPT-NeoX style) rotate by the angles whose
    cos/sin tables are (L, D/2). Computed in f32, returned in x's dtype."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2 :].float()
    cos, sin = cos.float(), sin.float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean NLL over the positions whose label is not ``ignore_index``, f32
    inside; with ``label_smoothing`` s each position's loss is (1 - s) NLL +
    s times the mean of -log p over the vocabulary."""
    logp = logits.float().log_softmax(-1)
    nll = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    if label_smoothing > 0:
        nll = (1 - label_smoothing) * nll + label_smoothing * -logp.mean(-1)
    mask = (labels != ignore_index).float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mesh,
                                 axis: str = "tp", ignore_index: int = -100,
                                 label_smoothing: float = 0.0) -> torch.Tensor:
    """``cross_entropy_loss`` over logits split on the vocabulary, without
    gathering it: ``logits`` (..., V/P) is this rank's slice (rank r of the P
    ranks of ``axis`` holds columns [r V/P, (r+1) V/P)), ``labels`` (...) the
    same on every rank. Each rank takes the log-sum-exp of its slice; the
    shift is the maximum of the ranks' maxima (an all-gather), and the sum of
    exponentials and the target logit each take one all-reduce, label
    smoothing one more for the mean logit. Returns the loss, the same on
    every rank; the gradient of each rank's slice is its slice of the whole
    logits' gradient, computed with no collective. As ``utils.metrics.
    cross_entropy`` does, the backward rebuilds softmax(logits) from the
    saved logits in one f32 buffer, so no f32 copy of the logits outlives
    the forward."""
    return _VocabParallelCE.apply(logits, labels, mesh.get_group(axis), ignore_index,
                                  label_smoothing)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, group, ignore_index, smoothing):
        p, r = dist.get_world_size(group), dist.get_rank(group)
        vloc = logits.shape[-1]
        lg = logits.float()
        lse_loc = torch.logsumexp(lg, -1)
        lse = lse_loc
        if p > 1:
            maxima = [torch.empty_like(lse) for _ in range(p)]
            dist.all_gather(maxima, logits.amax(-1).float().contiguous(), group=group)
            gmax = torch.stack(maxima).amax(0)
            se = torch.exp(lse_loc - gmax)
            dist.all_reduce(se, group=group)
            lse = se.log() + gmax
        tgt = labels.clamp(min=0) - r * vloc
        in_range = (tgt >= 0) & (tgt < vloc)
        tgt = torch.where(in_range, tgt, 0)
        tl = torch.where(in_range, lg.gather(-1, tgt[..., None])[..., 0], 0.0)
        if p > 1:
            dist.all_reduce(tl, group=group)
        nll = lse - tl
        if smoothing > 0:
            total = lg.sum(-1)
            if p > 1:
                dist.all_reduce(total, group=group)
            nll = (1 - smoothing) * nll + smoothing * (lse - total / (p * vloc))
        del lg
        mask = (labels != ignore_index).float()
        count = mask.sum().clamp(min=1.0)
        ctx.smoothing, ctx.vocab, ctx.split = smoothing, p * vloc, p > 1
        ctx.save_for_backward(logits, tgt, in_range, mask, count, lse_loc, lse)
        return (nll * mask).sum() / count

    @staticmethod
    def backward(ctx, g):
        logits, tgt, in_range, mask, count, lse_loc, lse = ctx.saved_tensors
        s = ctx.smoothing
        # d nll / d logits = softmax - (1 - s) onehot - s / V, this rank's columns
        d = torch.softmax(logits.float(), dim=-1)
        if ctx.split:  # the local softmax, rescaled to the whole vocabulary's
            d.mul_(torch.exp(lse_loc - lse)[..., None])
        d.scatter_add_(-1, tgt[..., None], -(1 - s) * in_range.float()[..., None])
        if s > 0:
            d.sub_(s / ctx.vocab)
        d.mul_((g * mask / count)[..., None])
        return d.to(logits.dtype), None, None, None, None
