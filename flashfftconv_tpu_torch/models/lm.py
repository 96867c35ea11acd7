"""Causal language model over the Hyena mixer (PyTorch).

Port of the JAX package's ``models/lm.py`` for the hyena mixer with a tied
head: word embeddings -> n_layer pre-norm blocks (mixer + MLP, residuals in
f32) -> final LayerNorm in f32 -> logits in f32 against the embedding table.
The JAX modules' other mixers and memory levers (block scan, remat, chunked
or block-diagonal MLPs, MoE) are not ported: setting one raises
NotImplementedError.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from flashfftconv_tpu_torch.models.hyena import HyenaOperator
from flashfftconv_tpu_torch.models.layers import Dense, Embed, LayerNorm
from flashfftconv_tpu_torch.ops.plan import resolve_device

_ACTIVATIONS = {
    # flax's nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def _not_ported(**options) -> None:
    for name, is_set in options.items():
        if is_set:
            raise NotImplementedError(f"{name} is not ported yet")


class Mlp(nn.Module):
    """fc2(act(fc1(x))) with both Dense layers in x's dtype and the
    activation in f32."""

    def __init__(self, d_inner, d_model, nblocks=0, activation="gelu", device="cuda",
                 generator=None):
        super().__init__()
        _not_ported(mlp_nblocks=nblocks > 0)
        self.activation = _ACTIVATIONS[activation]
        self.fc1 = Dense(d_model, d_inner, device=device, generator=generator)
        self.fc2 = Dense(d_inner, d_model, device=device, generator=generator)

    def forward(self, x):
        y = self.fc1(x, dtype=x.dtype)
        y = self.activation(y.float()).to(x.dtype)
        return self.fc2(y, dtype=x.dtype)


class Block(nn.Module):
    """Pre-norm block: LN -> mixer -> dropout -> +res; LN -> MLP -> dropout
    -> +res, with the residual stream in f32 unless residual_f32=False."""

    def __init__(self, d_model, d_inner, mixer="hyena", mixer_kwargs=None, resid_dropout=0.0,
                 mlp_nblocks=0, moe_kwargs=None, mlp_activation="gelu", mlp_l_chunks=0,
                 residual_f32=True, inner_remat=False, device="cuda", generator=None):
        super().__init__()
        _not_ported(**{
            f"mixer={mixer!r}": mixer != "hyena",
            "moe_kwargs": bool(moe_kwargs),
            "mlp_l_chunks": mlp_l_chunks > 1,
            "inner_remat": inner_remat,
        })
        self.residual_f32 = residual_f32
        self.norm1 = LayerNorm(d_model, device=device)
        self.mixer = HyenaOperator(d_model=d_model, **(mixer_kwargs or {}), device=device,
                                   generator=generator)
        self.norm2 = LayerNorm(d_model, device=device)
        self.mlp = Mlp(d_inner, d_model, nblocks=mlp_nblocks, activation=mlp_activation,
                       device=device, generator=generator)
        self.drop = nn.Dropout(resid_dropout)

    def forward(self, x):
        dtype = x.dtype
        res = x.float() if self.residual_f32 else x
        h = self.drop(self.mixer(self.norm1(res).to(dtype)))
        res = res + h.to(res.dtype)
        h = self.drop(self.mlp(self.norm2(res).to(dtype)))
        res = res + h.to(res.dtype)
        return res.to(dtype)


class LMBackbone(nn.Module):
    """n_layer Blocks and the final LayerNorm over embedded tokens. The
    embedding table belongs to the head (``ConvLMHeadModel``), which ties it
    to the logits; ``forward`` takes the embedded (B, L, D) activations."""

    def __init__(self, d_model, n_layer, d_inner, vocab_size, l_max, mixer="hyena",
                 mixer_kwargs=None, embed_dropout=0.1, resid_dropout=0.0, mlp_nblocks=0,
                 mlp_l_chunks=0, residual_f32=True, inner_remat=False, ln_f_f32=True,
                 moe_kwargs=None, remat=False, scan_blocks=False, dtype=torch.bfloat16,
                 device="cuda", generator=None):
        super().__init__()
        _not_ported(remat=remat, scan_blocks=scan_blocks)
        del vocab_size
        self.dtype = dtype
        mixer_kwargs = dict(mixer_kwargs or {})
        mixer_kwargs.setdefault("l_max", l_max)
        self.embed_drop = nn.Dropout(embed_dropout)
        self.blocks = nn.ModuleList(
            Block(d_model, d_inner, mixer=mixer, mixer_kwargs=mixer_kwargs,
                  resid_dropout=resid_dropout, mlp_nblocks=mlp_nblocks, moe_kwargs=moe_kwargs,
                  mlp_l_chunks=mlp_l_chunks, residual_f32=residual_f32,
                  inner_remat=inner_remat, device=device, generator=generator)
            for _ in range(n_layer)
        )
        self.ln_f = LayerNorm(d_model, dtype=torch.float32 if ln_f_f32 else dtype, device=device)

    def forward(self, x):
        x = self.embed_drop(x)
        for block in self.blocks:
            x = block(x)
        return self.ln_f(x)


class ConvLMHeadModel(nn.Module):
    """LM with tied embedding / LM-head weights; forward(input_ids (B, L))
    returns f32 logits (B, L, padded vocab)."""

    def __init__(self, d_model, n_layer, d_inner, vocab_size, l_max, mixer="hyena",
                 mixer_kwargs=None, embed_dropout=0.1, resid_dropout=0.0, mlp_nblocks=0,
                 mlp_l_chunks=0, residual_f32=True, inner_remat=False, ln_f_f32=True,
                 moe_kwargs=None, remat=False, scan_blocks=False, pad_vocab_size_multiple=8,
                 dtype=torch.bfloat16, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        vocab = vocab_size
        if vocab % pad_vocab_size_multiple:
            vocab += pad_vocab_size_multiple - vocab % pad_vocab_size_multiple
        self.vocab_size = vocab
        self.embeddings = Embed(vocab, d_model, dtype=dtype, device=device, generator=generator)
        self.backbone = LMBackbone(
            d_model, n_layer, d_inner, vocab, l_max, mixer=mixer, mixer_kwargs=mixer_kwargs,
            embed_dropout=embed_dropout, resid_dropout=resid_dropout, mlp_nblocks=mlp_nblocks,
            mlp_l_chunks=mlp_l_chunks, residual_f32=residual_f32, inner_remat=inner_remat,
            ln_f_f32=ln_f_f32, moe_kwargs=moe_kwargs, remat=remat, scan_blocks=scan_blocks,
            dtype=dtype, device=device, generator=generator,
        )

    def forward(self, input_ids):
        h = self.backbone(self.embeddings(input_ids))
        return self.embeddings.attend(h).float()
