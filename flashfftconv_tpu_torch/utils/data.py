"""Samplers, batches and synthetic tasks for the port's training entry points.

Port of the JAX package's ``utils/data.py`` and of ``mlm_batch`` of its
``examples/bert/train.py``. Everything here is numpy: the same seed gives
the same indices, batches and arrays, bit for bit, in both packages. The
samplers' state (epoch, consumed counter, seed) is checkpointable, so a
resumed run continues mid-epoch without replaying data.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class FaultTolerantSampler:
    """Shuffled index sampler whose state (epoch seed + consumed counter) is
    checkpointable; on restore, iteration continues exactly where it left off."""

    num_samples: int
    seed: int = 0
    epoch: int = 0
    counter: int = 0
    shuffle: bool = True

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "counter": self.counter, "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self.counter = int(state["counter"])
        self.seed = int(state.get("seed", self.seed))

    def _order(self) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.num_samples)
        rng = np.random.default_rng((self.seed, self.epoch))
        return rng.permutation(self.num_samples)

    def __iter__(self) -> Iterator[int]:
        order = self._order()
        while self.counter < len(order):
            idx = int(order[self.counter])
            self.counter += 1
            yield idx
        self.counter = 0
        self.epoch += 1

    def batches(self, batch_size: int, drop_last: bool = True):
        buf = []
        for idx in self:
            buf.append(idx)
            if len(buf) == batch_size:
                yield np.asarray(buf)
                buf = []
        if buf and not drop_last:
            yield np.asarray(buf)


@dataclasses.dataclass
class ShardedSampler(FaultTolerantSampler):
    """FaultTolerantSampler restricted to one data-parallel shard: rank r of
    world_size takes the r-th equal slice of each epoch's order."""

    rank: int = 0
    world_size: int = 1

    def _order(self) -> np.ndarray:
        order = super()._order()
        per = len(order) // self.world_size
        return order[self.rank * per : (self.rank + 1) * per]


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


# Synthetic in-context-learning tasks, integer tokens; token 0 is reserved as
# the copy-prefix / trigger symbol.

COPY_PREFIX = 0


def generate_induction_head(rng: np.random.Generator, input_seq_len: int, vocab_size: int,
                            induction_len: int = 1, num_triggers: int = 1):
    """One induction-head example: the trigger token (COPY_PREFIX) is planted
    num_triggers times, each followed by the same ``induction_len`` tokens; the
    model must emit those tokens after the final trigger. Returns (inputs,
    targets) with targets = -1 everywhere except the copied positions."""
    seq = rng.integers(1, vocab_size, input_seq_len + 1 + induction_len)
    seq[input_seq_len] = COPY_PREFIX
    if rng.uniform() < 0.5:
        num_triggers = 1
    pos = np.sort(rng.integers(0, input_seq_len - (1 + induction_len), num_triggers))
    pos_filtered = [pos[0]]
    for p in pos[1:]:
        if p - pos_filtered[-1] > induction_len:
            pos_filtered.append(p)
    to_copy = seq[pos_filtered[0] + 1 : pos_filtered[0] + 1 + induction_len].copy()
    for p in pos_filtered:
        seq[p] = COPY_PREFIX
        seq[p + 1 : p + 1 + induction_len] = to_copy
    seq[input_seq_len + 1 :] = to_copy
    inputs = seq[:-1]
    targets = np.full_like(inputs, -1)
    targets[input_seq_len:] = to_copy
    return inputs, targets


def generate_assoc_recall(rng: np.random.Generator, input_seq_len: int, vocab_size: int,
                          num_keys: int = 1):
    """One associative-recall example: (key, value) pairs fill the context;
    after the copy prefix a seen key is repeated and its value must be
    recalled. Keys come from the lower half of the vocabulary, values from
    the upper half."""
    half = (vocab_size - 1) // 2
    keys = np.arange(1, 1 + half)
    values = np.arange(1 + half, vocab_size)
    n_pairs = input_seq_len // (num_keys + 1)
    kv: dict[tuple, int] = {}
    seq = []
    for _ in range(n_pairs):
        k = tuple(rng.choice(keys, num_keys))
        if k not in kv:
            kv[k] = int(rng.choice(values))
        seq += list(k) + [kv[k]]
    query = list(rng.choice(list(kv.keys())))
    answer = kv[tuple(query)]
    seq += [COPY_PREFIX] + query + [answer]
    inputs = np.asarray(seq[:-1])
    targets = np.full_like(inputs, -1)
    targets[-1] = answer
    return inputs, targets


def icl_batches(task: str, batch_size: int, input_seq_len: int, vocab_size: int,
                seed: int = 0, **task_kwargs):
    """Endless (x, y) batches of a synthetic ICL task ("induction_head" or
    "assoc_recall")."""
    gen = {"induction_head": generate_induction_head,
           "assoc_recall": generate_assoc_recall}[task]
    rng = np.random.default_rng(seed)
    while True:
        pairs = [gen(rng, input_seq_len, vocab_size, **task_kwargs) for _ in range(batch_size)]
        yield np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


@dataclasses.dataclass
class ArrayDataset:
    """(inputs, labels) arrays with fault-tolerant shuffled batching: inputs
    (N, L) tokens or (N, L, C) flattened images."""

    inputs: np.ndarray
    labels: np.ndarray
    sampler: FaultTolerantSampler = None  # type: ignore[assignment]

    def __post_init__(self):
        if len(self.inputs) != len(self.labels):
            raise ValueError(f"{len(self.inputs)} inputs but {len(self.labels)} labels")
        if self.sampler is None:
            self.sampler = FaultTolerantSampler(num_samples=len(self.inputs))

    @classmethod
    def from_npz(cls, path: str, x_key: str = "x", y_key: str = "y"):
        z = np.load(path, allow_pickle=False)
        return cls(z[x_key], z[y_key])

    def batches(self, batch_size: int, drop_last: bool = True):
        for idx in self.sampler.batches(batch_size, drop_last=drop_last):
            yield self.inputs[idx], self.labels[idx]

    def state_dict(self):
        return self.sampler.state_dict()

    def load_state_dict(self, state):
        self.sampler.load_state_dict(state)


def grayscale_sequence(images: np.ndarray) -> np.ndarray:
    """(N, H, W, C) uint8 images -> (N, H*W) f32 sequences in [0, 1], the
    channels averaged (the sequential-CIFAR flattening)."""
    x = images.astype(np.float32) / 255.0
    if x.ndim == 4:
        x = x.mean(-1)
    return x.reshape(len(x), -1)
