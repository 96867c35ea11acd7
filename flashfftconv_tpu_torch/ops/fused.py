"""Fused elementwise ops of the JAX package's ``ops/fused.py`` (PyTorch).

The JAX module gives named forms of the reference's fused CUDA extensions
(dense + GELU, dropout + residual + LayerNorm or RMSNorm, scaled masked
softmax, rotary embedding, cross entropy) as plain XLA compositions, not
Pallas kernels; here they are plain torch with the same semantics: f32
inside, the result in the input's dtype. The dropout ops take a
``torch.Generator`` where the JAX ones take an ``rng`` key, so their masks
are another draw of the same distribution. ``vocab_parallel_cross_entropy``
needs a tensor-parallel mesh and is not ported.
"""

from __future__ import annotations

import torch
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
