"""Vision Transformer (PyTorch).

Port of the JAX package's ``models/vit.py``: a stride-p patch embedding,
a cls token or mean pooling, pre-norm blocks of ``MHAOperator``
(non-causal: on the card the flash-attention kernels, forward and backward)
and ``Mlp`` with exact-erf GELU, a final LayerNorm and a classification
head. Images come as (B, H, W, C), the JAX layout. The patch embedding is a
strided convolution, which the JAX package leaves to XLA: here
``F.conv2d`` in the model's dtype, its weight in PyTorch's (d_model, C, p, p)
layout. The JAX model learns its input channels and token count from the
first images; here ``img_size`` and ``in_chans`` say them at construction.

Dtypes follow flax: the patch embedding, the tokens and the MLP run in
``dtype``, the residual stream, the LayerNorms and the head in f32, and the
attention's Dense layers (no dtype) promote bf16 tokens to their f32
weights, so q, k and v, and the attention kernels, are f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from flashfftconv_tpu_torch.models.attention import MHAOperator
from flashfftconv_tpu_torch.models.layers import Dense, LayerNorm, normal, zeros
from flashfftconv_tpu_torch.models.lm import Mlp
from flashfftconv_tpu_torch.ops.plan import resolve_device


class ViTBlock(nn.Module):
    """LN -> non-causal MHA -> +res; LN -> MLP (exact GELU) -> +res, the
    residual in f32 and the output in the input's dtype."""

    def __init__(self, d_model, d_inner, num_heads, dropout=0.0, device="cuda", generator=None):
        super().__init__()
        self.norm1 = LayerNorm(d_model, device=device)
        self.mixer = MHAOperator(d_model, num_heads=num_heads, causal=False, dropout=dropout,
                                 device=device, generator=generator)
        self.norm2 = LayerNorm(d_model, device=device)
        self.mlp = Mlp(d_inner, d_model, activation="gelu_exact", device=device,
                       generator=generator)

    def forward(self, x):
        res = x.float()
        res = res + self.mixer(self.norm1(res).to(x.dtype)).float()
        return (res + self.mlp(self.norm2(res).to(x.dtype)).float()).to(x.dtype)


class PatchEmbed(nn.Module):
    """The stride-p, p x p convolution of (B, H, W, C) images into (B, H/p *
    W/p, d_model) tokens in ``dtype``, row-major over the patch grid (flax's
    ``Conv`` with ``strides=(p, p)`` and a reshape)."""

    def __init__(self, in_chans, d_model, patch_size, dtype, device="cuda", generator=None):
        super().__init__()
        self.patch_size, self.dtype = patch_size, dtype
        fan_in = in_chans * patch_size * patch_size  # lecun_normal, flax's Conv init
        self.weight = normal((d_model, in_chans, patch_size, patch_size),
                             1.0 / math.sqrt(fan_in), generator, device)
        self.bias = zeros((d_model,), device)

    def forward(self, images):
        x = F.conv2d(images.permute(0, 3, 1, 2).to(self.dtype), self.weight.to(self.dtype),
                     self.bias.to(self.dtype), stride=self.patch_size)
        return x.flatten(2).transpose(1, 2)


class VisionTransformer(nn.Module):
    """ViT classifier: forward(images (B, H, W, C)) -> f32 logits (B,
    num_classes). ``global_pool="token"`` classifies a cls token, ``"avg"``
    the mean of the patch tokens."""

    def __init__(self, num_classes, img_size=224, in_chans=3, patch_size=16, d_model=384,
                 n_layer=12, num_heads=6, mlp_ratio=4, dropout=0.0, global_pool="token",
                 dtype=torch.bfloat16, device="cuda", generator=None):
        super().__init__()
        if img_size % patch_size:
            raise ValueError(f"image size {img_size} is no multiple of patch size {patch_size}")
        if global_pool not in ("token", "avg"):
            raise ValueError(f"global_pool must be 'token' or 'avg', got {global_pool!r}")
        device = resolve_device(device)
        self.img_size, self.global_pool = img_size, global_pool
        mk = dict(device=device, generator=generator)
        self.patch_embed = PatchEmbed(in_chans, d_model, patch_size, dtype, **mk)
        n_tok = (img_size // patch_size) ** 2
        if global_pool == "token":
            self.cls_token = normal((1, 1, d_model), 0.02, generator, device)
            n_tok += 1
        self.pos_embeddings = normal((n_tok, d_model), 0.02, generator, device)
        self.drop = nn.Dropout(dropout)
        self.blocks = nn.ModuleList(
            ViTBlock(d_model, mlp_ratio * d_model, num_heads, dropout=dropout, **mk)
            for _ in range(n_layer))
        self.ln_f = LayerNorm(d_model, device=device)
        self.head = Dense(d_model, num_classes, dtype=torch.float32, **mk)

    def forward(self, images):
        b, h, w, _ = images.shape
        if (h, w) != (self.img_size, self.img_size):
            raise ValueError(f"images of {h} x {w}, the model takes {self.img_size} squared")
        x = self.patch_embed(images)
        if self.global_pool == "token":
            x = torch.cat([self.cls_token.expand(b, 1, -1).to(x.dtype), x], dim=1)
        x = self.drop(x + self.pos_embeddings.to(x.dtype))
        for block in self.blocks:
            x = block(x)
        x = self.ln_f(x.float())
        return self.head(x[:, 0] if self.global_pool == "token" else x.mean(1))
