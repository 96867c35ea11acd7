"""The benchmark's input generators.

``synthetic_genome`` and ``lm_batches`` are frozen copies of
``flashfftconv_tpu_torch/models/dna.synthetic_genome`` and
``flashfftconv_tpu_torch/utils/data.lm_batches``. ``WindowFeed`` gives the
same random contiguous windows as ``lm_batches`` (the tests hold it to
that), but gathers them on the device, so a unit's input costs one small
kernel and no copy from the host.
"""

from __future__ import annotations

import numpy as np
import torch


def synthetic_genome(seed: int = 0, n: int = 2_000_000) -> np.ndarray:
    """Random ACGT with 2000 planted copies of one 64-base motif, so that a
    model has long-range structure to learn; int32 ids, from ``seed``."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.int32)
    motif = rng.integers(0, 4, 64).astype(np.int32)
    for start in rng.integers(0, n - 64, 2000):
        g[start : start + 64] = motif
    return g


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


def flat_tokens(spec: dict, seed: int, device) -> torch.Tensor:
    """The flat token array a cell's windows are cut from: ``uniform`` ids
    over ``vocab`` drawn on the device, or the ``genome`` of the seed."""
    if spec["kind"] == "uniform":
        gen = torch.Generator(device=device).manual_seed(seed)
        return torch.randint(0, spec["vocab"], (spec["length"],), generator=gen, device=device)
    if spec["kind"] == "genome":
        return torch.from_numpy(synthetic_genome(seed, spec["length"]).astype(np.int64)).to(device)
    raise ValueError(f"unknown token source {spec['kind']!r}")


class WindowFeed:
    """Unit i's (x, y): ``batch`` windows of ``length`` + 1 tokens, at the
    starts ``lm_batches`` draws from the same generator (the i-th batch of
    ``lm_batches(tokens, batch, length, np.random.default_rng(seed))``),
    gathered on the device; the same seed gives the same windows."""

    def __init__(self, tokens: torch.Tensor, batch: int, length: int, seed: int,
                 units: int = 4096):
        rng = np.random.default_rng(seed)
        max_start = tokens.numel() - length - 1
        starts = np.stack([rng.integers(0, max_start, batch) for _ in range(units)])
        self.tokens = tokens
        self.starts = torch.from_numpy(starts).to(tokens.device)
        self.offsets = torch.arange(length + 1, device=tokens.device)

    def __call__(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        xy = self.tokens[self.starts[i % len(self.starts)][:, None] + self.offsets]
        return xy[:, :-1], xy[:, 1:]
