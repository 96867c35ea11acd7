"""Training steps for the port's models (PyTorch).

Port of the train and eval steps of the JAX package's ``utils/train.py``
and of the ``examples/lm/train.py`` recipe: clip the gradients' global norm,
then AdamW on every parameter under a linear-warmup cosine schedule that
starts at 0. On the card every long and short conv's gradient comes from
the backward kernels (``FftConvFunction``, ``DepthwiseFunction``).

    model = ConvLMHeadModel(...)                      # on "cuda" by default
    opt, sched = lm_optimizer(model, lr=3e-4, weight_decay=0.1, warmup=20, steps=200)
    step = make_train_step(model, opt, sched, clip=1.0)
    metrics = step(x, y)                              # x, y (B, L) token ids

``dna_optimizer`` is the ``examples/hyena_dna`` recipe: the same clip, then
AdamW at a constant lr 6e-4 with weight decay 0.1, no schedule
(``make_train_step(model, dna_optimizer(model))``). ``bert_optimizer`` is
the ``examples/bert`` recipe: clip 1.0, AdamW at lr 8e-4 with weight decay
1e-5 on every parameter, with ``mlm_loss``, the masked-LM loss and
accuracy over the masked positions only (``make_train_step(model,
bert_optimizer(model), loss_fn=mlm_loss)``).

A model whose Hyena mixers run on a sequence mesh (``seq_mesh`` in
``mixer_kwargs``) takes the same step on every rank of the mesh, each on its
chunk of the sequence: ``parallel.seq_conv.seq_backward`` runs the backward
of the global mean loss and sums the replicated parameters' grads over the
mesh before the clip, so every rank takes the same optimizer step.

The orbax checkpoints, ``auto_save_on_exception`` and ``ProgressiveResizing``
of the JAX module are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from flashfftconv_tpu_torch.parallel.seq_conv import seq_backward, seq_group
from flashfftconv_tpu_torch.utils.metrics import accuracy, cross_entropy
from flashfftconv_tpu_torch.utils.optim import lr_lambda, warmup_cosine_decay_schedule


def lm_optimizer(model: nn.Module, lr: float = 3e-4, weight_decay: float = 0.1,
                 warmup: int = 20, steps: int = 200):
    """The ``examples/lm`` optimizer: AdamW (betas 0.9/0.999, eps 1e-8,
    decoupled decay scaled by lr) on every parameter, with lr following
    ``warmup_cosine_decay_schedule(0, lr, warmup', max(steps, warmup' + 1))``
    where warmup' = min(warmup, max(steps // 2, 1)), as the script clamps it.
    Returns (optimizer, scheduler); the first update runs at lr = 0."""
    warmup = min(warmup, max(steps // 2, 1))
    schedule = warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1))
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda(schedule, lr))


def dna_optimizer(model: nn.Module, lr: float = 6e-4, weight_decay: float = 0.1):
    """The ``examples/hyena_dna`` optimizer: AdamW (betas 0.9/0.999, eps 1e-8,
    decoupled decay scaled by lr) on every parameter at a constant lr."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def bert_optimizer(model: nn.Module, lr: float = 8e-4, weight_decay: float = 1e-5):
    """The ``examples/bert`` optimizer after its clip: optax's ``adamw`` (betas
    0.9/0.999, eps 1e-8, decoupled decay scaled by lr) at a constant lr,
    decaying every parameter, biases and norms included."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100):
    """The ``examples/bert`` masked-LM loss: (cross-entropy, {"accuracy"}),
    each the mean over the positions whose label is not ``ignore_index``."""
    return (cross_entropy(logits, labels, ignore_index),
            {"accuracy": accuracy(logits.detach(), labels, ignore_index)})


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, scheduler=None,
                    clip: float = 1.0, loss_fn: Callable = cross_entropy):
    """Returns step(x, y) -> {"loss", "grad_norm"} (device tensors, not
    synchronised): forward, ``loss_fn(logits, y)``, backward, clip the
    gradients' global norm to ``clip``, optimizer step, schedule step. The
    caller picks ``model.train()`` (dropout on) or ``eval()``. A ``loss_fn``
    that returns (loss, metrics), as ``mlm_loss`` does, adds its metrics to
    the result. Under a sequence mesh x and y are the rank's chunks and
    "loss" is the global mean over every rank's tokens."""
    group = seq_group(model)

    def step(x: torch.Tensor, y: torch.Tensor) -> dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(x), y)
        loss, metrics = loss if isinstance(loss, tuple) else (loss, {})
        if group is None:
            loss.backward()
        else:
            loss = seq_backward(model, loss, y.numel(), group)
        grad_norm = torch.nn.utils.clip_grad_norm_(
            [p for p in model.parameters() if p.grad is not None], clip)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return {"loss": loss.detach(), "grad_norm": grad_norm, **metrics}

    return step


def make_eval_step(model: nn.Module):
    """Returns the classification eval step(batch) for ``batch = (x, y)`` or
    ``(x, y, w)``, y (B,) labels and ``w`` a 0/1 weight per row masking
    padded rows out of the counts: {"loss", "correct", "total"}, with
    dropout off, as the JAX package's ``make_eval_step`` with
    ``deterministic=True``."""

    @torch.no_grad()
    def step(batch) -> dict[str, torch.Tensor]:
        x, y, *rest = batch
        w = rest[0].float() if rest else torch.ones(y.shape[0], device=y.device)
        was_training = model.training
        model.eval()
        try:
            logits = model(x).float()
        finally:
            model.train(was_training)
        nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, y[..., None])[..., 0]
        return {
            "loss": (nll * w).sum() / w.sum().clamp(min=1.0),
            "correct": ((logits.argmax(-1) == y).float() * w).sum(),
            "total": w.sum(),
        }

    return step
