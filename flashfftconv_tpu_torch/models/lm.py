"""Causal language model over long-conv and attention mixers (PyTorch).

Port of the JAX package's ``models/lm.py`` with a tied head: word
embeddings -> n_layer pre-norm blocks (mixer + MLP, residuals in f32) ->
final LayerNorm in f32 -> logits in f32 against the embedding table.

Mixers by name (``MIXERS``, the JAX package's ``get_mixer_cls``):
``"hyena"`` (``HyenaOperator``), ``"m2"`` (``MonarchMixerSequenceMixing``),
``"h3"`` (``models.h3.H3Operator``), ``"long-conv"``
(``models.long_conv.LongConvOperator``) and ``"mha"``
(``models.attention.MHAOperator``, the flash-attention kernels on the card);
``Block.step`` decodes one token through a mixer with a KV cache (the
``"mha"`` mixer has one). ``mlp_nblocks`` > 0 makes the MLP's two layers
block-diagonal (``BlockdiagLinear``), as in M2.

The memory levers of the JAX package's 1M-base train step: ``remat``
(each block under ``torch.utils.checkpoint``, which keeps only the block's
input and replays the block, dropout's random state included, in the
backward), ``inner_remat`` (mixer and MLP as separate checkpoint regions
inside the block), ``mlp_l_chunks`` (``ChunkedMlp``: the MLP in L-chunks
with a backward of its own that keeps only its input) and ``scan_blocks``.
``moe_kwargs`` replaces a block's MLP by ``models.moe.MoEMlp`` (the
keywords go to it; ``mlp_activation`` then plays no part).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from flashfftconv_tpu_torch.models.attention import MHAOperator
from flashfftconv_tpu_torch.models.h3 import H3Operator
from flashfftconv_tpu_torch.models.hyena import HyenaOperator
from flashfftconv_tpu_torch.models.layers import ACTIVATIONS, Dense, Embed, LayerNorm
from flashfftconv_tpu_torch.models.long_conv import LongConvOperator
from flashfftconv_tpu_torch.models.m2_bert import BlockdiagLinear, MonarchMixerSequenceMixing
from flashfftconv_tpu_torch.models.moe import MoEMlp
from flashfftconv_tpu_torch.ops.plan import resolve_device
from flashfftconv_tpu_torch.parallel.comm import copy_to, reduce_from

# The mixer registry of the JAX package's get_mixer_cls.
MIXERS = {"hyena": HyenaOperator, "m2": MonarchMixerSequenceMixing, "h3": H3Operator,
          "mha": MHAOperator, "long-conv": LongConvOperator}


class Mlp(nn.Module):
    """fc2(act(fc1(x))) with the activation in f32. Dense layers compute in
    x's dtype; with ``nblocks`` > 0 both are ``BlockdiagLinear`` (whose f32
    bias promotes the output to f32, as in the flax module)."""

    def __init__(self, d_inner, d_model, nblocks=0, activation="gelu", device="cuda",
                 generator=None):
        super().__init__()
        self.activation = ACTIVATIONS[activation]
        self.nblocks = nblocks
        mk = dict(device=device, generator=generator)
        if nblocks:
            self.fc1 = BlockdiagLinear(d_model, d_inner, nblocks=nblocks, **mk)
            self.fc2 = BlockdiagLinear(d_inner, d_model, nblocks=nblocks, **mk)
        else:
            self.fc1 = Dense(d_model, d_inner, **mk)
            self.fc2 = Dense(d_inner, d_model, **mk)

    def _layer(self, layer, x):
        return layer(x) if self.nblocks else layer(x, dtype=x.dtype)

    def forward(self, x):
        y = self._layer(self.fc1, x)
        y = self.activation(y.float()).to(x.dtype)
        return self._layer(self.fc2, y)


class _MlpChunked(torch.autograd.Function):
    """fc2(act(fc1(x))) on x (rows, d) in ``c`` row chunks (the JAX package's
    ``_mlp_chunked``): the forward keeps one chunk's fc1 output at a time and
    saves only x and the weights; the backward recomputes fc1 per chunk and
    accumulates the weight grads in f32. Weights are (out, in) and come at
    x's dtype, so their grads leave at that dtype, as in the JAX function.
    b2 may be None (the tensor-parallel form adds it after the sum)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, c, act):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.c, ctx.act, ctx.has_b2 = c, act, b2 is not None
        y = x.new_empty(x.shape[0], w2.shape[0])
        for xc, yc in zip(x.chunk(c), y.chunk(c)):
            hc = act(F.linear(xc, w1, b1).float()).to(x.dtype)
            if b2 is None:
                torch.mm(hc, w2.T, out=yc)
            else:
                torch.addmm(b2, hc, w2.T, out=yc)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2 = ctx.saved_tensors
        dx = torch.empty_like(x)
        dw1, db1, dw2 = (torch.zeros(t.shape, dtype=torch.float32, device=x.device)
                         for t in (w1, b1, w2))
        db2 = torch.zeros(w2.shape[0], dtype=torch.float32, device=x.device)
        for xc, dyc, dxc in zip(x.chunk(ctx.c), dy.chunk(ctx.c), dx.chunk(ctx.c)):
            with torch.enable_grad():
                pre = F.linear(xc, w1, b1).float().requires_grad_()
                hc = ctx.act(pre)
            dh = (dyc @ w2).float()
            dpre = torch.autograd.grad(hc, pre, dh)[0].to(x.dtype)
            hc = hc.detach().to(x.dtype)
            torch.mm(dpre, w1, out=dxc)
            dw1 += (dpre.T @ xc).float()
            db1 += dpre.float().sum(0)
            dw2 += (dyc.T @ hc).float()
            db2 += dyc.float().sum(0)
        db2 = db2.to(b1.dtype) if ctx.has_b2 else None
        return dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2, None, None


class ChunkedMlp(Mlp):
    """``Mlp`` with the L-chunked body and backward of ``_MlpChunked``; same
    parameters. B * L must be a multiple of ``l_chunks``.

    Under tensor parallelism (``parallel.mesh.shard_parameters`` makes fc1
    column- and fc2 row-parallel over one group, Megatron's pair) each rank
    holds fc1's (d_inner / P, d) weight and bias and fc2's (d, d_inner / P)
    weight, and fc2's whole bias: x enters through ``copy_to`` (its grad
    summed over the group), ``_MlpChunked`` runs on the shards without fc2's
    bias, so the split hidden activation never leaves the rank and the
    Function still saves only x and the weights, and its (B * L, d) output
    is summed once by ``reduce_from`` before the bias is added once."""

    def __init__(self, d_inner, d_model, l_chunks=4, activation="gelu", device="cuda",
                 generator=None):
        super().__init__(d_inner, d_model, activation=activation, device=device,
                         generator=generator)
        self.l_chunks = l_chunks

    def forward(self, x):
        b, l, d = x.shape
        if (b * l) % self.l_chunks:
            raise ValueError(f"B * L = {b * l} is no multiple of l_chunks = {self.l_chunks}")
        dt, tp = x.dtype, self.fc1.tp
        x, b2 = x.reshape(b * l, d), self.fc2.bias.to(dt)
        if tp is not None:
            x = copy_to(x, tp.group)
        y = _MlpChunked.apply(x, self.fc1.weight.to(dt), self.fc1.bias.to(dt),
                              self.fc2.weight.to(dt), None if tp else b2, self.l_chunks,
                              self.activation)
        if tp is not None:
            y = reduce_from(y, tp.group) + b2
        return y.reshape(b, l, -1)


class Block(nn.Module):
    """Pre-norm block: LN -> mixer -> dropout -> +res; LN -> MLP -> dropout
    -> +res, with the residual stream in f32 unless residual_f32=False.
    ``inner_remat`` puts the mixer and the MLP under a checkpoint each, so
    that in the backward of a rematerialised block their recomputed working
    sets never coexist, for one more forward of each."""

    def __init__(self, d_model, d_inner, mixer="hyena", mixer_kwargs=None, resid_dropout=0.0,
                 mlp_nblocks=0, moe_kwargs=None, mlp_activation="gelu", mlp_l_chunks=0,
                 residual_f32=True, inner_remat=False, device="cuda", generator=None):
        super().__init__()
        if mixer not in MIXERS:
            raise ValueError(f"unknown mixer {mixer!r}; have {sorted(MIXERS)}")
        self.residual_f32 = residual_f32
        self.inner_remat = inner_remat
        self.norm1 = LayerNorm(d_model, device=device)
        self.mixer = MIXERS[mixer](d_model=d_model, **(mixer_kwargs or {}), device=device,
                                   generator=generator)
        self.norm2 = LayerNorm(d_model, device=device)
        if moe_kwargs:
            self.mlp = MoEMlp(d_model, d_inner, **moe_kwargs, device=device, generator=generator)
        elif mlp_l_chunks > 1 and not mlp_nblocks:
            self.mlp = ChunkedMlp(d_inner, d_model, l_chunks=mlp_l_chunks,
                                  activation=mlp_activation, device=device, generator=generator)
        else:
            self.mlp = Mlp(d_inner, d_model, nblocks=mlp_nblocks, activation=mlp_activation,
                           device=device, generator=generator)
        self.drop = nn.Dropout(resid_dropout)

    def _part(self, module, h):
        if self.inner_remat and torch.is_grad_enabled():
            return checkpoint(module, h, use_reentrant=False)
        return module(h)

    def forward(self, x):
        dtype = x.dtype
        res = x.float() if self.residual_f32 else x
        h = self.drop(self._part(self.mixer, self.norm1(res).to(dtype)))
        res = res + h.to(res.dtype)
        h = self.drop(self._part(self.mlp, self.norm2(res).to(dtype)))
        res = res + h.to(res.dtype)
        return res.to(dtype)

    def step(self, x_t, cache, pos: int):
        """One KV-cached decode step through the mixer's ``step`` (residual in
        f32, no dropout). Returns (x_t at the next layer, cache)."""
        dtype = x_t.dtype
        res = x_t.float()
        h, cache = self.mixer.step(self.norm1(res).to(dtype), cache, pos)
        res = res + h.float()
        res = res + self.mlp(self.norm2(res).to(dtype)).float()
        return res.to(dtype), cache


class LMBackbone(nn.Module):
    """n_layer Blocks and the final LayerNorm over embedded tokens. The
    embedding table belongs to the head (``ConvLMHeadModel``), which ties it
    to the logits; ``forward`` takes the embedded (B, L, D) activations.

    ``remat`` runs every block under ``torch.utils.checkpoint``
    (non-reentrant; the random state is saved, so dropout replays): only the
    (B, L, D) block inputs stay live across layers. ``scan_blocks`` is
    accepted and changes nothing here: the JAX package needs ``lax.scan`` to
    make XLA run the backward one block at a time, while PyTorch's backward
    already frees a block's recomputed activations before it reaches the
    next. ``utils.jax_weights`` reads the stacked parameter tree that option
    gives the flax model."""

    def __init__(self, d_model, n_layer, d_inner, vocab_size, l_max, mixer="hyena",
                 mixer_kwargs=None, embed_dropout=0.1, resid_dropout=0.0, mlp_nblocks=0,
                 mlp_l_chunks=0, residual_f32=True, inner_remat=False, ln_f_f32=True,
                 moe_kwargs=None, remat=False, scan_blocks=False, dtype=torch.bfloat16,
                 device="cuda", generator=None):
        super().__init__()
        del vocab_size
        self.dtype = dtype
        self.scan_blocks = scan_blocks  # the flax tree's layout (parallel.mesh.param_shardings)
        self.remat = remat
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
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
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
