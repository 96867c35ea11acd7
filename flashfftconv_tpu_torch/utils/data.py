"""Batches for the port's training entry points.

Port of ``lm_batches`` of the JAX package's ``utils/data.py``: the same
numpy generator gives the same windows in both packages.
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
