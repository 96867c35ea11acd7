"""Optimizer construction with per-parameter groups, schedules and EMA (PyTorch).

Port of the JAX package's ``utils/optim.py``. The JAX package labels each
leaf of the flax parameter tree ('special' for conv-kernel parameters,
'default' otherwise) and gives each label its own optax AdamW. The port
labels each parameter by its flax path (``jax_weights.flax_paths``, the
inverse of the weight-import key map), never by its PyTorch name: a flax
Dense ``kernel`` and a LayerNorm ``scale`` are both ``.weight`` here.

The schedules are optax's, as functions of the update count (0 for the
first update); ``lr_lambda`` turns one into a ``LambdaLR`` factor, so the
first ``optimizer.step()`` runs at ``schedule(0)``, as optax's does.
``torch.optim.AdamW`` with betas (0.9, 0.999) and eps 1e-8 is optax's
``adamw``: the decay is decoupled and scaled by the learning rate.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from flashfftconv_tpu_torch.utils import jax_weights


def linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """optax.linear_schedule: init -> end over transition_steps, then end."""

    def f(step: int) -> float:
        if transition_steps <= 0:
            return end_value
        frac = 1.0 - min(max(step, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return f


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0):
    """optax.cosine_decay_schedule: init * ((1 - alpha) * cosine + alpha)."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def f(step: int) -> float:
        cosine = 0.5 * (1 + math.cos(math.pi * min(step, decay_steps) / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return f


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule: linear warmup to the peak, then a
    cosine decay over the remaining decay_steps - warmup_steps."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)
    return lambda step: warm(step) if step < warmup_steps else decay(step - warmup_steps)


def lr_lambda(schedule, base_lr: float):
    """The ``LambdaLR`` factor that makes a group of base lr ``base_lr``
    follow ``schedule``."""
    return lambda step: 0.0 if base_lr == 0.0 else schedule(step) / base_lr


def kernel_label_fn(path: tuple[str, ...]) -> bool:
    """True for long-conv kernel parameters (the reference's ``_optim``
    params): every flax leaf named ``kernel``, as the JAX package marks them."""
    return any(n == "kernel" for n in path)


def label_params(model: nn.Module, is_special: Callable = kernel_label_fn) -> dict[str, str]:
    """'special' or 'default' for each parameter name, from its flax path."""
    paths = jax_weights.flax_paths(model)
    return {name: "special" if is_special(paths[name]) else "default"
            for name, _ in model.named_parameters()}


def make_optimizer(
    model: nn.Module,
    lr: float = 1e-3,
    weight_decay: float = 0.05,
    special_lr: float | None = 1e-3,
    epochs: int | None = None,
    steps_per_epoch: int | None = None,
    warmup_steps: int = 0,
    is_special: Callable = kernel_label_fn,
):
    """AdamW with a no-weight-decay group for kernel params and an optional
    (warmup +) cosine schedule, as the JAX package's ``make_optimizer``.
    Returns (optimizer, scheduler); call ``scheduler.step()`` after each
    ``optimizer.step()``. Group 0 is 'default', group 1 'special'."""

    def sched(base):
        if epochs is None or steps_per_epoch is None:
            if not warmup_steps:
                return lambda step: base
            return linear_schedule(0.0, base, warmup_steps)
        total = epochs * steps_per_epoch
        if not warmup_steps:
            return cosine_decay_schedule(base, total)
        return warmup_cosine_decay_schedule(0.0, base, warmup_steps,
                                            max(total, warmup_steps + 1))

    labels = label_params(model, is_special)
    special_lr = special_lr if special_lr is not None else lr
    groups = [
        {"params": [p for n, p in model.named_parameters() if labels[n] == label],
         "lr": group_lr, "weight_decay": wd}
        for label, group_lr, wd in (("default", lr, weight_decay), ("special", special_lr, 0.0))
    ]
    opt = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        opt, [lr_lambda(sched(lr), lr), lr_lambda(sched(special_lr), special_lr)])
    return opt, scheduler


@torch.no_grad()
def ema_init(model: nn.Module) -> dict[str, torch.Tensor]:
    """EMA of parameters (the reference harness's EMACallback): an f32
    shadow copy by name."""
    return {n: p.detach().float().clone() for n, p in model.named_parameters()}


@torch.no_grad()
def ema_update(ema: dict[str, torch.Tensor], model: nn.Module, decay: float = 0.999):
    """One EMA step in place: shadow <- decay * shadow + (1 - decay) * params."""
    for n, p in model.named_parameters():
        ema[n].mul_(decay).add_(p.detach().float(), alpha=1.0 - decay)
    return ema


def ema_swap(ema: dict[str, torch.Tensor], model: nn.Module) -> dict[str, torch.Tensor]:
    """The shadow params at the live params' dtypes, for
    ``model.load_state_dict(..., strict=False)`` before an eval."""
    return {n: ema[n].to(p.dtype) for n, p in model.named_parameters()}
