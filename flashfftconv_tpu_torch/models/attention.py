"""Multi-head self-attention mixer of the JAX package's ``models/attention.py``
(PyTorch).

``MHAOperator`` projects (B, L, D) activations to q, k, v with one Dense
(no dtype, so bf16 activations meet f32 weights and q, k, v come out f32, as
flax promotes them), splits the heads, applies rotary embedding to the first
``rotary_dim`` channels of q and k, and attends through ``ops.attention.
flash_mha``: on the card the hand-written flash-attention kernels, forward
and backward, or with ``window=W`` the splash-attention kernels, which skip
the tiles outside the window. With ``dropout > 0`` in training mode the
probabilities are dropped out, which needs the materialised (L, L) matrix:
that branch is plain torch, as it is XLA in the JAX package. ALiBi, a
sliding window and ``segment_ids`` (packed variable-length rows) are options
of the call; a window with ALiBi or segment ids raises on the card, as the
JAX package's kernel path does.

``step`` and ``init_cache`` decode one token at a time against a KV cache
(B, H, max_length, head_dim): a plain f32 softmax over the cache, as the JAX
package leaves it to XLA. The port writes the new key and value into the
cache in place and returns the same dict.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from flashfftconv_tpu_torch.models.layers import Dense
from flashfftconv_tpu_torch.ops.attention import alibi_bias, alibi_slopes, flash_mha, masked_scores
from flashfftconv_tpu_torch.ops.fused import apply_rotary_emb
from flashfftconv_tpu_torch.ops.plan import resolve_device


def rotary_tables(l: int, dim: int, base: float = 10000.0, device=None):
    """cos, sin tables (L, dim/2) of GPT-NeoX rotary embedding, inv_freq =
    base^(-2i/dim), in f32."""
    inv_freq = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    freqs = torch.outer(torch.arange(l, dtype=torch.float32, device=device), inv_freq)
    return freqs.cos(), freqs.sin()


class MHAOperator(nn.Module):
    def __init__(self, d_model, l_max=0, num_heads=8, causal=True, dropout=0.0, impl="auto",
                 alibi=False, window=None, rotary_dim=0, rotary_base=10000.0, device="cuda",
                 generator=None):
        super().__init__()
        del l_max  # signature parity with the conv mixers
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is no multiple of num_heads {num_heads}")
        device = resolve_device(device)
        self.d_model, self.num_heads = d_model, num_heads
        self.causal, self.dropout, self.impl = causal, dropout, impl
        self.alibi, self.window = alibi, window
        self.rotary_dim, self.rotary_base = rotary_dim, rotary_base
        self.qkv_proj = Dense(d_model, 3 * d_model, device=device, generator=generator)
        self.out_proj = Dense(d_model, d_model, device=device, generator=generator)
        self.drop = nn.Dropout(dropout)

    def _split_heads(self, x):
        b, l, d = x.shape
        return x.reshape(b, l, self.num_heads, d // self.num_heads).transpose(1, 2)

    def _rotate(self, q, k, cos, sin):
        """Rotary on the first rotary_dim channels of q and k (B, H, L, hd);
        the rows of cos and sin match the L axis."""
        r = self.rotary_dim
        q = torch.cat([apply_rotary_emb(q[..., :r], cos, sin), q[..., r:]], dim=-1)
        k = torch.cat([apply_rotary_emb(k[..., :r], cos, sin), k[..., r:]], dim=-1)
        return q, k

    def forward(self, u, segment_ids=None):
        """u (B, L, D); segment_ids optional (B, L) int for packed rows."""
        b, l, d = u.shape
        hd = d // self.num_heads
        q, k, v = map(self._split_heads, self.qkv_proj(u).chunk(3, dim=-1))
        if self.rotary_dim:
            q, k = self._rotate(q, k, *rotary_tables(l, self.rotary_dim, self.rotary_base,
                                                     u.device))
        bias = alibi_bias(self.num_heads, l, l, device=u.device) if self.alibi else None
        if self.dropout > 0.0 and self.training:
            scores = masked_scores(q, k, self.causal, hd**-0.5, bias, self.window, segment_ids)
            attn = self.drop(scores.softmax(-1))
            out = torch.einsum("bhqk,bhkd->bhqd", attn.to(v.dtype), v)
        else:
            out = flash_mha(q, k, v, causal=self.causal, impl=self.impl, bias=bias,
                            window=self.window, segment_ids=segment_ids)
        return self.out_proj(out.transpose(1, 2).reshape(b, l, d))

    def step(self, u_t, cache, pos: int):
        """One KV-cached decode step: u_t (B, 1, D) is the token at position
        ``pos``; attends to cache slots 0..pos. Returns (y_t (B, 1, D), cache)."""
        b, _, d = u_t.shape
        hd = d // self.num_heads
        q, k, v = map(self._split_heads, self.qkv_proj(u_t).chunk(3, dim=-1))
        max_len = cache["k"].shape[2]
        if self.rotary_dim:
            cos, sin = rotary_tables(max_len, self.rotary_dim, self.rotary_base, u_t.device)
            q, k = self._rotate(q, k, cos[pos : pos + 1], sin[pos : pos + 1])
        cache["k"][:, :, pos] = k[:, :, 0].to(cache["k"].dtype)
        cache["v"][:, :, pos] = v[:, :, 0].to(cache["v"].dtype)
        kpos = torch.arange(max_len, device=u_t.device)
        valid = kpos <= pos
        if self.window is not None:
            valid &= kpos > pos - self.window
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                              cache["k"].to(q.dtype).float()) * (hd**-0.5)
        if self.alibi:
            dist = (pos - kpos).abs().float()
            scores = scores + (-alibi_slopes(self.num_heads, u_t.device)[:, None, None]
                               * dist[None, :])[None]
        attn = scores.masked_fill(~valid, -math.inf).softmax(-1).to(v.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, cache["v"].to(v.dtype))
        return self.out_proj(out.transpose(1, 2).reshape(b, 1, d)), cache

    def init_cache(self, batch: int, max_length: int, dtype=torch.float32):
        """KV cache of one layer: zero keys and values (B, H, max_length,
        head_dim) on the module's device."""
        shape = (batch, self.num_heads, max_length, self.d_model // self.num_heads)
        dev = self.qkv_proj.weight.device
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}
