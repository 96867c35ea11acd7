"""Training metrics and monitors (PyTorch).

Port of the JAX package's ``utils/metrics.py``: cross-entropy with a
recompute-in-backward gradient, perplexity, accuracy, token counts,
parameter and gradient norms, a step-rate tracker and parameter counts.
"""

from __future__ import annotations

import time

import torch
from torch import nn


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token NLL in f32; targets outside [0, V) (ignored tokens) read
    class 0, which the caller masks."""
    x = logits.float()
    idx = targets.clamp(0, x.shape[-1] - 1)[..., None]
    return torch.logsumexp(x, dim=-1) - x.gather(-1, idx)[..., 0]


def _mean(values: torch.Tensor, targets: torch.Tensor, ignore_index: int | None) -> torch.Tensor:
    if ignore_index is None:
        return values.mean()
    mask = (targets != ignore_index).float()
    return (values * mask).sum() / mask.sum().clamp(min=1.0)


class _CrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, ignore_index):
        ctx.ignore_index = ignore_index
        ctx.save_for_backward(logits, targets)
        return _mean(_nll(logits, targets), targets, ignore_index)

    @staticmethod
    def backward(ctx, g):
        logits, targets = ctx.saved_tensors
        ignore_index = ctx.ignore_index
        # d = (softmax(logits) - onehot) * weight, built in place in one f32 buffer
        d = torch.softmax(logits.float(), dim=-1)
        if ignore_index is None:
            d.scatter_add_(-1, targets[..., None], torch.full(
                targets.shape + (1,), -1.0, device=d.device))
            d.mul_(g / targets.numel())
        else:
            mask = (targets != ignore_index).float()
            idx = targets.clamp(0, d.shape[-1] - 1)[..., None]
            d.scatter_add_(-1, idx, -mask[..., None])
            d.mul_((g * mask / mask.sum().clamp(min=1.0))[..., None])
        return d.to(logits.dtype), None, None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  ignore_index: int | None = None) -> torch.Tensor:
    """Mean token NLL whose backward recomputes the softmax.

    Autograd of ``log_softmax`` keeps the f32 log-probabilities of every
    token alive from the head's forward until the loss's backward (6.6 GB at
    B=4, L=8192, V=50264); this Function saves only the logits, an
    activation that exists anyway, and rebuilds softmax(logits) - onehot in
    one buffer inside its own backward. The gradient is exact.
    """
    return _CrossEntropy.apply(logits, targets, ignore_index)


def perplexity(logits, targets, ignore_index: int | None = None) -> torch.Tensor:
    return torch.exp(cross_entropy(logits, targets, ignore_index))


def accuracy(logits, targets, ignore_index: int | None = None) -> torch.Tensor:
    correct = (logits.argmax(-1) == targets).float()
    return _mean(correct, targets, ignore_index)


def num_tokens(targets, ignore_index: int | None = None) -> torch.Tensor:
    if ignore_index is None:
        return torch.tensor(targets.numel())
    return (targets != ignore_index).sum()


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over tensors (an iterable or a dict of them), in f32."""
    if isinstance(tensors, dict):
        tensors = tensors.values()
    squares = [t.detach().float().square().sum() for t in tensors if t is not None]
    return torch.stack(squares).sum().sqrt()


def param_and_grad_norms(model: nn.Module) -> dict[str, torch.Tensor]:
    params = list(model.parameters())
    return {"param_norm": global_norm(params), "grad_norm": global_norm(p.grad for p in params)}


class SpeedMonitor:
    """Wall-clock step and throughput tracker (the reference's SpeedMonitor
    callback). The caller synchronises the device before ``step`` when it
    times device work."""

    def __init__(self):
        self._last = None

    def step(self, n_items: int = 0) -> dict[str, float]:
        now = time.perf_counter()
        out = {}
        if self._last is not None:
            dt = now - self._last
            out["step_time_ms"] = dt * 1e3
            if n_items:
                out["items_per_sec"] = n_items / dt
        self._last = now
        return out


def param_counts(model: nn.Module) -> dict[str, int]:
    """Total and per-top-level-module parameter counts (every parameter is
    trainable, as in the JAX package)."""
    counts = {"total": sum(p.numel() for p in model.parameters())}
    for name, child in model.named_children():
        counts[name] = sum(p.numel() for p in child.parameters())
    return counts
