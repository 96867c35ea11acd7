"""Batches for the port's training entry points.

Port of ``lm_batches`` of the JAX package's ``utils/data.py`` and of
``mlm_batch`` of its ``examples/bert/train.py``: the same numpy generator
gives the same batches in both packages.
"""

from __future__ import annotations

import numpy as np


def lm_batches(tokens: np.ndarray, batch_size: int, seq_len: int, rng: np.random.Generator):
    """Random contiguous (input, target) LM batches from a flat token array:
    an endless iterator of numpy pairs (x, y), both (batch_size, seq_len),
    y the tokens one position after x's."""
    max_start = len(tokens) - seq_len - 1
    while True:
        starts = rng.integers(0, max_start, batch_size)
        x = np.stack([tokens[s : s + seq_len] for s in starts])
        y = np.stack([tokens[s + 1 : s + seq_len + 1] for s in starts])
        yield x, y


MASK_ID = 256  # the byte-level [MASK] id of examples/bert (vocabulary 257 and up)


def mlm_batches(tokens: np.ndarray, batch_size: int, seq_len: int, rng: np.random.Generator,
                mask_prob: float = 0.15, mask_id: int = MASK_ID, ignore_index: int = -100):
    """Masked-LM batches from a flat token array: an endless iterator of numpy
    pairs (x, labels), both (batch_size, seq_len), from random windows. Each
    position is masked with probability ``mask_prob``: x holds ``mask_id``
    there and labels the true id; labels are ``ignore_index`` elsewhere."""
    while True:
        starts = rng.integers(0, len(tokens) - seq_len, batch_size)
        x = np.stack([tokens[s : s + seq_len] for s in starts])
        mask = rng.random(x.shape) < mask_prob
        yield np.where(mask, mask_id, x), np.where(mask, x, ignore_index)
