"""Task bundles: a loss and named metrics per task kind (PyTorch).

Port of the JAX package's ``utils/tasks.py``: a task is a named bundle of
functions over (logits or predictions, targets), with the
``SequenceDecoder`` mode it conventionally pairs with. Every metric is a
one-shot reduction; an epoch's value is the mean of its steps' values.

    task = get_task("classification")
    loss = task.loss(logits, labels)
    metrics = {k: f(logits, labels) for k, f in task.metrics.items()}
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from flashfftconv_tpu_torch.utils import metrics as M


@dataclass(frozen=True)
class Task:
    """A loss plus named metric reductions; ``decoder_mode`` is the
    SequenceDecoder mode the task conventionally pairs with."""

    loss: Callable
    metrics: dict[str, Callable] = field(default_factory=dict)
    decoder_mode: str = "last"


def _mse(pred, target):
    return torch.mean((pred.float() - target.float()) ** 2)


def _mae(pred, target):
    return torch.mean(torch.abs(pred.float() - target.float()))


def _shifted_xent(logits, targets, ignore_index: int = -100):
    """Next-token LM loss: predict targets[t+1] from logits[t]."""
    return M.cross_entropy(logits[:, :-1], targets[:, 1:], ignore_index)


def _multilabel_loss(logits, targets):
    """Binary cross-entropy with logits, in the log1p(exp(-|x|)) form."""
    return torch.mean(logits.clamp(min=0) - logits * targets
                      + torch.log1p(torch.exp(-logits.abs())))


TASKS: dict[str, Task] = {
    # Autoregressive LM over pre-shifted (input, target) pairs.
    "lm": Task(loss=M.cross_entropy, metrics={"ppl": M.perplexity, "acc": M.accuracy},
               decoder_mode="full"),
    # LM where the batch is a single token stream (shift internally).
    "lm-shift": Task(
        loss=_shifted_xent,
        metrics={"ppl": lambda lg, tg: M.perplexity(lg[:, :-1], tg[:, 1:]),
                 "acc": lambda lg, tg: M.accuracy(lg[:, :-1], tg[:, 1:])},
        decoder_mode="full",
    ),
    "classification": Task(loss=M.cross_entropy, metrics={"acc": M.accuracy},
                           decoder_mode="mean"),
    "multilabel": Task(
        loss=_multilabel_loss,
        metrics={"acc": lambda lg, tg: torch.mean(((lg > 0) == (tg > 0.5)).float())},
        decoder_mode="mean",
    ),
    "regression": Task(loss=_mse, metrics={"mse": _mse, "mae": _mae}, decoder_mode="last"),
    # Multi-horizon forecasting: predictions (B, l_output, D) vs targets.
    "forecasting": Task(loss=_mse, metrics={"mse": _mse, "mae": _mae}, decoder_mode="pool"),
}


def get_task(name: str) -> Task:
    try:
        return TASKS[name]
    except KeyError:
        raise KeyError(f"unknown task {name!r}; known: {sorted(TASKS)}") from None
