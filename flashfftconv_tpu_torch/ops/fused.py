"""Fused elementwise ops of the JAX package's ``ops/fused.py`` (PyTorch).

Only ``apply_rotary_emb``, which the attention mixer runs, is ported so
far; the JAX module's fused dense, norm, softmax and cross-entropy ops
follow in a later slice.
"""

from __future__ import annotations

import torch


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary position embedding over the last dim of x (..., L, D): its two
    halves (non-interleaved, GPT-NeoX style) rotate by the angles whose
    cos/sin tables are (L, D/2). Computed in f32, returned in x's dtype."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2 :].float()
    cos, sin = cos.float(), sin.float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
