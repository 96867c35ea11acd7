"""GPT and OPT language models of the JAX package's ``models/gpt.py`` (PyTorch).

``GPTLMHeadModel``: word embeddings plus learned position embeddings, then
n_layer pre-norm ``lm.Block``s with the ``"mha"`` mixer (attention through
the flash-attention kernels on the card), a final LayerNorm in f32 and the
head tied to the embedding table. OPT widths whose ``embed_dim`` differs
from ``d_model`` project the embedding in (before the positions are added)
and the final hidden state out. ``remat`` runs each block under
``torch.utils.checkpoint``. ``step`` and ``init_cache`` decode one token at a
time against per-layer KV caches (``utils.generation.generate_kv``).

GPT-2 124M is ``GPTLMHeadModel(d_model=768, n_layer=12, d_inner=3072,
vocab_size=50257, l_max=1024, num_heads=12)``; ``utils.checkpoint_import.
import_gpt2_state_dict`` maps HuggingFace's ``gpt2`` keys onto it.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from flashfftconv_tpu_torch.models.layers import Dense, Embed, LayerNorm, normal
from flashfftconv_tpu_torch.models.lm import Block
from flashfftconv_tpu_torch.ops.plan import resolve_device


class GPTLMHeadModel(nn.Module):
    """forward(input_ids (B, L)) -> f32 logits (B, L, padded vocab)."""

    def __init__(self, d_model, n_layer, d_inner, vocab_size, l_max, num_heads=8,
                 embed_dropout=0.1, resid_dropout=0.0, pad_vocab_size_multiple=8,
                 embed_dim=None, mlp_activation="gelu", dtype=torch.bfloat16, mixer_kwargs=None,
                 remat=False, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        vocab = vocab_size
        if vocab % pad_vocab_size_multiple:
            vocab += pad_vocab_size_multiple - vocab % pad_vocab_size_multiple
        self.vocab_size = vocab
        self.d_model = d_model
        self.embed_dim = embed_dim or d_model
        self.dtype = dtype
        self.remat = remat
        self.embeddings = Embed(vocab, self.embed_dim, dtype=dtype, device=device,
                                generator=generator)
        self.pos_embeddings = normal((l_max, d_model), 0.02, generator, device)
        if self.embed_dim != d_model:
            self.project_in = Dense(self.embed_dim, d_model, bias=False, dtype=dtype,
                                    device=device, generator=generator)
            self.project_out = Dense(d_model, self.embed_dim, bias=False, dtype=dtype,
                                     device=device, generator=generator)
        mk = {"num_heads": num_heads, "causal": True, **(mixer_kwargs or {})}
        self.blocks = nn.ModuleList(
            Block(d_model, d_inner, mixer="mha", mixer_kwargs=mk, resid_dropout=resid_dropout,
                  mlp_activation=mlp_activation, layer=i, device=device, generator=generator)
            for i in range(n_layer)
        )
        self.ln_f = LayerNorm(d_model, device=device)
        self.embed_drop = nn.Dropout(embed_dropout)

    def _embed(self, ids, positions):
        x = self.embeddings(ids)
        if self.embed_dim != self.d_model:
            x = self.project_in(x)
        return x + positions.to(self.dtype)

    def _head(self, x):
        h = self.ln_f(x.float())
        if self.embed_dim != self.d_model:
            h = self.project_out(h.to(self.dtype))
        return self.embeddings.attend(h).float()

    def forward(self, input_ids):
        x = self.embed_drop(self._embed(input_ids, self.pos_embeddings[: input_ids.shape[1]]))
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        return self._head(x)

    def init_cache(self, batch: int, max_length: int, dtype=None):
        """One KV cache a layer, keys and values (B, H, max_length, head_dim)
        in ``dtype`` (the model's by default, as in the JAX package)."""
        return [blk.mixer.init_cache(batch, max_length, dtype or self.dtype)
                for blk in self.blocks]

    def step(self, token_t, caches, pos: int):
        """One decode step: token_t (B, 1) ids at position ``pos``. Returns
        (logits (B, 1, V) f32, caches), the caches updated in place."""
        x = self._embed(token_t, self.pos_embeddings[pos : pos + 1][None])
        for i, blk in enumerate(self.blocks):
            x, caches[i] = blk.step(x, caches[i], pos)
        return self._head(x), caches


def opt_lm(vocab_size: int, l_max: int, width: str = "125m", **kwargs) -> GPTLMHeadModel:
    """OPT configurations (125m, 350m, 1.3b): ReLU MLPs, and at 350m a 512-wide
    embedding projected to d_model 1024."""
    cfgs = {
        "125m": dict(d_model=768, n_layer=12, num_heads=12, embed_dim=None),
        "350m": dict(d_model=1024, n_layer=24, num_heads=16, embed_dim=512),
        "1.3b": dict(d_model=2048, n_layer=24, num_heads=32, embed_dim=None),
    }
    cfg = cfgs[width]
    return GPTLMHeadModel(
        d_model=cfg["d_model"], n_layer=cfg["n_layer"], d_inner=4 * cfg["d_model"],
        vocab_size=vocab_size, l_max=l_max, num_heads=cfg["num_heads"],
        embed_dim=cfg["embed_dim"], mlp_activation=kwargs.pop("mlp_activation", "relu"),
        **kwargs,
    )
