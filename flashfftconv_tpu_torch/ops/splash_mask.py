"""The masks of the splash-attention kernels (csrc/splash_attn*.cu) and their tile tables.

The counterpart of JAX's splash ``MaskInfo`` (jax 0.9.0,
``pallas/ops/tpu/splash_attention/splash_attention_mask_info.py``), whose
``block_mask`` marks each (query block, key block) empty (0), partial (1)
or full (2) and whose ``data_next`` and ``mask_next`` list the blocks a grid
step loads; here for the kernels' 64 x 64 tiles (``TILE``). The JAX package
gives every head the same mask, so one table serves every (batch, head).

A ``SplashMask`` is one of two masks over an (L, L) score matrix:

- ``SplashMask.local(L, W)``, ``flash_mha(window=W)`` (splash's
  ``LocalMask((L, L), (W - 1, 0), 0)``): query i sees keys i - W < j <= i,
  causal whatever ``causal`` says. Query tile t visits key tiles
  max(0, 64 t - W + 1) // 64 .. t and key tile t query tiles
  t .. min(n - 1, (64 t + 62 + W) // 64); tile (tq, tk) is full when
  tk < tq and 64 tk >= 64 tq + 64 - W. The kernels compute these ranges;
  there is no table. W >= L is the causal mask.
- ``SplashMask.blocks(blockmask, block_size, causal)``, ``blocksparse_mha``:
  block (r, c) == 0 hides keys of column block c from queries of row block
  r, and causal keeps j <= i within the kept blocks. ``block_size`` need not
  be a multiple of 64, so a tile that is not full reads the mask itself (a
  device copy of ``blockmask``, one byte a block). The table (``table``,
  cached by (L, block_size, mask bytes, causal)) lists for each query tile
  the key tiles that hold a kept element and for each key tile the query
  tiles, each entry 2 * tile + full.

A row that sees no key gives output 0 and adds 0 to every grad.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

TILE = 64  # kTile of csrc/flash_attn_common.cuh


def window_keep(l_q: int, l_k: int, window: int, device=None) -> torch.Tensor:
    """Boolean (Lq, Lk) sliding-window causal mask: query i (aligned to the
    end of the key axis) sees keys (i - window, i]."""
    qpos = torch.arange(l_q, device=device)[:, None] + (l_k - l_q)
    kpos = torch.arange(l_k, device=device)[None, :]
    return (kpos <= qpos) & (kpos > qpos - window)


@functools.lru_cache(maxsize=64)
def _block_table(length: int, block_size: int, mask_bytes: bytes, causal: bool) -> np.ndarray:
    """The int32 table [fwd_ptr (n + 1), fwd_idx, bwd_ptr (n + 1), bwd_idx]
    of a block mask, n = ceil(L / 64) tiles. The mask is constant on cells
    of g = gcd(block_size, 64) elements a side (but for the diagonal cells
    under causal), so the tiles' states come from cells, not elements."""
    nb = length // block_size
    blockmask = np.frombuffer(mask_bytes, np.uint8).reshape(nb, nb).astype(bool)
    g = math.gcd(block_size, TILE)
    rep, per, n = block_size // g, TILE // g, -(-length // TILE)
    kept = np.kron(blockmask, np.ones((rep, rep), bool))  # (L / g, L / g) cells
    state = np.where(kept, 2, 0).astype(np.int8)  # 0 empty, 1 partial, 2 full
    if causal:
        state = np.tril(state)
        # a diagonal cell keeps j <= i of its g x g elements: full only if g == 1
        np.fill_diagonal(state, np.where(kept.diagonal(), 2 if g == 1 else 1, 0))
    cells = np.zeros((n * per, n * per), np.int8)  # cells past L stay empty
    cells[: state.shape[0], : state.shape[1]] = state
    cells = cells.reshape(n, per, n, per)
    visit = (cells > 0).any(axis=(1, 3))
    full = (cells == 2).all(axis=(1, 3))
    rows, cols = np.nonzero(visit)
    fwd_ptr = np.concatenate([[0], np.cumsum(visit.sum(1))])
    fwd_idx = 2 * cols + full[rows, cols]
    cols_t, rows_t = np.nonzero(visit.T)
    bwd_ptr = np.concatenate([[0], np.cumsum(visit.sum(0))])
    bwd_idx = 2 * rows_t + full[rows_t, cols_t]
    table = np.concatenate([fwd_ptr, fwd_idx, bwd_ptr, bwd_idx]).astype(np.int32)
    table.setflags(write=False)
    return table


@functools.lru_cache(maxsize=64)
def _device_tables(length: int, block_size: int, mask_bytes: bytes, causal: bool,
                   device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Device copies of a block mask's table and of its bytes."""
    table = _block_table(length, block_size, mask_bytes, causal)
    blocks = np.frombuffer(mask_bytes, np.uint8)
    return (torch.from_numpy(table.copy()).to(device),
            torch.from_numpy(blocks.copy()).to(device))


class SplashMask:
    """A window or block mask over an (L, L) score matrix; see the module
    docstring. Build with ``SplashMask.local`` or ``SplashMask.blocks``."""

    def __init__(self, length: int, window: int | None = None, blockmask=None,
                 block_size: int = 0, causal: bool = False):
        if length < 1:
            raise ValueError(f"length must be >= 1, got {length}")
        self.length, self.causal = length, bool(causal)
        self.n_tiles = -(-length // TILE)
        if window is not None:
            if int(window) < 1:
                raise ValueError(f"window must be >= 1, got {window}")
            self.window = min(int(window), length)  # W >= L keeps the causal half
            self.blockmask, self.block_size = None, 0
            return
        self.window = None
        self.blockmask = np.ascontiguousarray(np.asarray(blockmask, bool))
        self.block_size = int(block_size)
        nr, nc = self.blockmask.shape
        if nr != nc or nr * self.block_size != length:
            raise ValueError(f"blockmask {self.blockmask.shape} x block_size {block_size} "
                             f"does not tile L={length}")

    @classmethod
    def local(cls, length: int, window: int) -> "SplashMask":
        return cls(length, window=window)

    @classmethod
    def blocks(cls, blockmask, block_size: int, causal: bool = False) -> "SplashMask":
        nr = np.asarray(blockmask).shape[0]
        return cls(nr * block_size, blockmask=blockmask, block_size=block_size, causal=causal)

    def dense(self, device=None) -> torch.Tensor:
        """The (L, L) boolean mask, True where a score is kept."""
        if self.window is not None:
            return window_keep(self.length, self.length, self.window, device)
        dense = np.kron(self.blockmask, np.ones((self.block_size, self.block_size), bool))
        if self.causal:
            dense &= np.tril(np.ones((self.length, self.length), bool))
        return torch.from_numpy(dense).to(device)

    def table(self) -> np.ndarray | None:
        """The block mask's int32 tile table (None for a window)."""
        if self.window is not None:
            return None
        return _block_table(self.length, self.block_size, self._bytes(), self.causal)

    def tiles(self) -> tuple[list, list]:
        """(fwd, bwd): for each query tile the (key tile, full) pairs it
        visits, and for each key tile the (query tile, full) pairs, in the
        kernels' order."""
        n = self.n_tiles
        if self.window is not None:
            w = self.window

            def full(tq, tk):
                return tk < tq and TILE * tk >= TILE * tq + TILE - w

            fwd = [[(tk, full(tq, tk)) for tk in range(max(0, TILE * tq - w + 1) // TILE, tq + 1)]
                   for tq in range(n)]
            bwd = [[(tq, full(tq, tk))
                    for tq in range(tk, min(n - 1, (TILE * tk + TILE - 2 + w) // TILE) + 1)]
                   for tk in range(n)]
            return fwd, bwd
        t = self.table()
        fwd_ptr, rest = t[: n + 1], t[n + 1 :]
        fwd_idx, rest = rest[: fwd_ptr[-1]], rest[fwd_ptr[-1] :]
        bwd_ptr, bwd_idx = rest[: n + 1], rest[n + 1 :]

        def lists(ptr, idx):
            return [[(int(e) >> 1, bool(e & 1)) for e in idx[ptr[i] : ptr[i + 1]]]
                    for i in range(n)]

        return lists(fwd_ptr, fwd_idx), lists(bwd_ptr, bwd_idx)

    def kernel_args(self, device) -> tuple[torch.Tensor | None, torch.Tensor | None, list[int]]:
        """(table, blockmask bytes, [window, block_size, n_blocks, n_entries,
        causal]) as the kernels take them: device copies of the table and of
        the block mask (cached with the table; None for a window)."""
        if self.window is not None:
            return None, None, [self.window, 0, 0, 0, 0]
        key = (self.length, self.block_size, self._bytes(), self.causal)
        table, blocks = _device_tables(*key, str(torch.device(device)))
        n_entries = int(_block_table(*key)[self.n_tiles])
        return table, blocks, [0, self.block_size, self.blockmask.shape[0], n_entries,
                               int(self.causal)]

    def _bytes(self) -> bytes:
        return self.blockmask.astype(np.uint8).tobytes()
