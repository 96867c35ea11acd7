"""M2-BERT: Monarch Mixer BERT encoder and MLM head (PyTorch).

Port of the M2 part of the JAX package's ``models/bert.py``
(``M2BertLayer``, ``M2BertModel``, ``M2BertForMaskedLM``) over the
``MonarchMixerSequenceMixing`` token mixer and dense or block-diagonal
MLPs, with the JAX modules' dtype semantics: bf16 activations, LayerNorms in
f32, the MLM head in f32. ``PRESETS`` holds the example's configuration
(``examples/bert/train.py``: ``base-110M``), ``build_model`` builds it and
``fill_mask`` answers a masked-LM request. A train step is
``utils.train.make_train_step`` over ``utils.train.bert_optimizer`` with
``loss_fn=utils.train.mlm_loss`` on batches from ``utils.data.mlm_batches``.

The attention BERT classes of the same JAX module follow the M2 ones:
``BertLayer`` (post-norm: LN(x + MHA(x)), LN(x + MLP(x)), exact-erf GELU,
no attention dropout, so training runs the flash-attention kernels),
``BertModel`` (word, position and token-type embeddings; ``alibi=True``
drops the position table for an ALiBi bias in every layer; the 0/1
``attention_mask`` becomes int segment ids, so padded positions attend only
to padded ones and valid ones only to valid ones; an optional tanh pooler
over the first token), ``BertForMaskedLM`` (the MLM decoder tied to the word
embeddings, with a bias of its own), ``BertForSequenceClassification`` and
``BertForPreTraining`` (MLM and next-sentence logits). The word embeddings
live in ``bert.word_embeddings`` (the flax tree keeps a tied table at its
top; ``utils.jax_weights.bert_state_dict`` moves it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from flashfftconv_tpu_torch.models.attention import MHAOperator
from flashfftconv_tpu_torch.models.layers import Dense, Embed, LayerNorm, zeros
from flashfftconv_tpu_torch.models.m2_bert import BlockdiagLinear, MonarchMixerSequenceMixing
from flashfftconv_tpu_torch.ops.plan import resolve_device


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu default


class M2BertLayer(nn.Module):
    """Mixer -> dropout -> +res -> LayerNorm; MLP (dense or block-diagonal,
    optionally a GLU) -> dropout -> +res -> LayerNorm. ``ref_structure``
    reproduces the reference BertLayer: no residual, dropout or LayerNorm
    around the mixer, whose output feeds the MLP directly."""

    def __init__(self, d_model, d_inner, l_max, mlp_nblocks=4, dropout=0.1, bidirectional=True,
                 residual_long_conv=True, use_glu_mlp=False, ref_structure=False,
                 conv_dtype=torch.bfloat16, impl="auto", device="cuda", generator=None):
        super().__init__()
        self.use_glu_mlp = use_glu_mlp
        self.ref_structure = ref_structure
        self.mixer = MonarchMixerSequenceMixing(
            d_model, l_max=l_max, bidirectional=bidirectional,
            residual_long_conv=residual_long_conv, conv_dtype=conv_dtype, impl=impl,
            device=device, generator=generator)
        if not ref_structure:
            self.norm1 = LayerNorm(d_model, device=device)
        fc1_out = 2 * d_inner if use_glu_mlp else d_inner
        if mlp_nblocks:
            self.mlp_fc1 = BlockdiagLinear(d_model, fc1_out, nblocks=mlp_nblocks, device=device,
                                           generator=generator)
            self.mlp_fc2 = BlockdiagLinear(d_inner, d_model, nblocks=mlp_nblocks, device=device,
                                           generator=generator)
        else:
            self.mlp_fc1 = Dense(d_model, fc1_out, device=device, generator=generator)
            self.mlp_fc2 = Dense(d_inner, d_model, device=device, generator=generator)
        self.norm2 = LayerNorm(d_model, device=device)
        self.drop = nn.Dropout(dropout)

    def _dense(self, layer, x):
        return layer(x) if isinstance(layer, BlockdiagLinear) else layer(x, dtype=x.dtype)

    def forward(self, x):
        h = self.mixer(x)
        if self.ref_structure:
            x = h
        else:
            x = self.norm1((x + self.drop(h)).float()).to(x.dtype)
        m = self._dense(self.mlp_fc1, x)
        if self.use_glu_mlp:
            gate, val = m.chunk(2, dim=-1)
            m = (_gelu(gate.float()) * val.float()).to(x.dtype)
        else:
            m = _gelu(m.float()).to(x.dtype)
        m = self.drop(self._dense(self.mlp_fc2, m))
        return self.norm2((x + m).float()).to(x.dtype)


class M2BertModel(nn.Module):
    """Word, position and token-type embeddings, their LayerNorm (f32) and
    dropout, then n_layer ``M2BertLayer``s; ``attention_mask`` (B, L) zeroes
    the padded positions after the embeddings and after every layer."""

    def __init__(self, vocab_size, d_model=768, n_layer=12, d_inner=3072, l_max=128,
                 type_vocab_size=2, mlp_nblocks=4, dropout=0.1, use_glu_mlp=False,
                 ref_structure=False, conv_dtype=torch.bfloat16, impl="auto", device="cuda",
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = conv_dtype
        emb = lambda n: Embed(n, d_model, dtype=conv_dtype, device=device, generator=generator)
        self.word_embeddings = emb(vocab_size)
        self.position_embeddings = emb(l_max)
        self.token_type_embeddings = emb(type_vocab_size)
        self.embed_norm = LayerNorm(d_model, device=device)
        self.drop = nn.Dropout(dropout)
        self.layer = nn.ModuleList(
            M2BertLayer(d_model, d_inner, l_max, mlp_nblocks=mlp_nblocks, dropout=dropout,
                        use_glu_mlp=use_glu_mlp, ref_structure=ref_structure,
                        conv_dtype=conv_dtype, impl=impl, device=device, generator=generator)
            for _ in range(n_layer))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.word_embeddings(input_ids)
        x = x + self.position_embeddings(torch.arange(input_ids.shape[1],
                                                      device=input_ids.device))[None]
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        x = self.drop(self.embed_norm(x.float()).to(self.dtype))
        mask = None if attention_mask is None else attention_mask[..., None].to(x.dtype)
        if mask is not None:
            x = x * mask
        for layer in self.layer:
            x = layer(x)
            if mask is not None:
                x = x * mask
        return x


class M2BertForMaskedLM(nn.Module):
    """``M2BertModel`` and the MLM head: Dense (f32) -> GELU -> LayerNorm ->
    logits (B, L, vocab) in f32, through the word-embedding table plus a bias
    with ``tie_mlm_head`` (as the reference ties its decoder), else through
    an untied Dense."""

    def __init__(self, vocab_size, d_model=768, n_layer=12, d_inner=3072, l_max=128,
                 mlp_nblocks=4, dropout=0.1, use_glu_mlp=False, ref_structure=False,
                 tie_mlm_head=False, conv_dtype=torch.bfloat16, impl="auto", device="cuda",
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.tie_mlm_head = tie_mlm_head
        self.vocab_size = vocab_size
        self.bert = M2BertModel(
            vocab_size, d_model=d_model, n_layer=n_layer, d_inner=d_inner, l_max=l_max,
            mlp_nblocks=mlp_nblocks, dropout=dropout, use_glu_mlp=use_glu_mlp,
            ref_structure=ref_structure, conv_dtype=conv_dtype, impl=impl, device=device,
            generator=generator)
        self.mlm_transform = Dense(d_model, d_model, dtype=torch.float32, device=device,
                                   generator=generator)
        self.mlm_norm = LayerNorm(d_model, device=device)
        if tie_mlm_head:
            self.mlm_bias = zeros((vocab_size,), device)
        else:
            self.mlm_head = Dense(d_model, vocab_size, dtype=torch.float32, device=device,
                                  generator=generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        h = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.mlm_norm(_gelu(self.mlm_transform(h.float())))
        if self.tie_mlm_head:
            return self.bert.word_embeddings.attend(h).float() + self.mlm_bias
        return self.mlm_head(h)


# The examples/bert/train.py preset: 12 layers, hidden 768, max_seq_len 128,
# batch 128, dense MLP, the bert-base-uncased vocabulary, tied MLM decoder.
PRESETS = {
    "base-110M": dict(d_model=768, n_layer=12, d_inner=3072, l_max=128, batch_size=128,
                      mlp_nblocks=0, vocab_size=30522, tie_mlm_head=True),
}


def build_model(name: str = "base-110M", dtype: torch.dtype = torch.bfloat16, device="cuda",
                generator: torch.Generator | None = None, **overrides) -> M2BertForMaskedLM:
    """The ``M2BertForMaskedLM`` of preset ``name`` (its ``batch_size`` is the
    example's, not a model field); ``overrides`` replace preset fields or
    set any other constructor argument."""
    cfg = {**PRESETS[name], **overrides}
    cfg.pop("batch_size")
    return M2BertForMaskedLM(conv_dtype=dtype, device=device, generator=generator, **cfg)


def fill_mask(model: M2BertForMaskedLM, ids: torch.Tensor, labels: torch.Tensor,
              ignore_index: int = -100) -> dict[str, torch.Tensor]:
    """Answer fill-mask requests ids (B, L) whose masked positions carry their
    true ids in ``labels`` (``ignore_index`` elsewhere), with one forward in
    eval mode (dropout off; the model's mode is restored), no grad.

    Returns ``top1`` (B, L) int64, the most likely token at every position;
    ``accuracy`` (B,) f32, the share of each request's masked positions whose
    top-1 token is the true one; and ``finite``, a scalar bool that is True
    when every logit is finite."""
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            logits = model(ids)
            top1 = logits.argmax(dim=-1)
            masked = (labels != ignore_index).float()
            hits = (top1 == labels).float() * masked
            return {"top1": top1, "accuracy": hits.sum(1) / masked.sum(1).clamp(min=1.0),
                    "finite": torch.isfinite(logits).all()}
    finally:
        model.train(was_training)


# --- the attention BERT ------------------------------------------------------

def _gelu_exact(x):
    return F.gelu(x.float())


class BertLayer(nn.Module):
    """Post-norm encoder layer: LN(x + dropout(MHA(x))); LN(x +
    dropout(fc2(gelu(fc1(x))))). The non-causal ``MHAOperator`` gets no
    attention dropout, so it runs the flash kernels in training too."""

    def __init__(self, d_model, d_inner, num_heads, dropout=0.1, impl="auto", alibi=False,
                 device="cuda", generator=None):
        super().__init__()
        mk = dict(device=device, generator=generator)
        self.mixer = MHAOperator(d_model, num_heads=num_heads, causal=False, impl=impl,
                                 alibi=alibi, **mk)
        self.norm1 = LayerNorm(d_model, device=device)
        self.fc1 = Dense(d_model, d_inner, **mk)
        self.fc2 = Dense(d_inner, d_model, **mk)
        self.norm2 = LayerNorm(d_model, device=device)
        self.drop = nn.Dropout(dropout)

    def forward(self, x, segment_ids=None):
        h = self.drop(self.mixer(x, segment_ids=segment_ids))
        x = self.norm1((x + h).float()).to(x.dtype)
        m = _gelu_exact(self.fc1(x, dtype=x.dtype)).to(x.dtype)
        m = self.drop(self.fc2(m, dtype=x.dtype))
        return self.norm2((x + m).float()).to(x.dtype)


class BertModel(nn.Module):
    """Embeddings, their LayerNorm (f32) and dropout, n_layer ``BertLayer``s.
    forward(input_ids, token_type_ids=None, attention_mask=None) -> (x (B, L,
    d_model) in ``dtype``, pooled (B, d_model) f32 or None): token types
    default to 0; ``attention_mask`` (B, L) of 1/0 is passed to every layer
    as segment ids; the pooler is tanh(Dense(x[:, 0])) in f32."""

    def __init__(self, vocab_size, d_model=768, n_layer=12, d_inner=3072, num_heads=12,
                 l_max=512, type_vocab_size=2, dropout=0.1, with_pooler=True, impl="auto",
                 alibi=False, dtype=torch.float32, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        mk = dict(device=device, generator=generator)
        self.word_embeddings = Embed(vocab_size, d_model, dtype=dtype, **mk)
        self.position_embeddings = None if alibi else Embed(l_max, d_model, dtype=dtype, **mk)
        self.token_type_embeddings = Embed(type_vocab_size, d_model, dtype=dtype, **mk)
        self.embed_norm = LayerNorm(d_model, device=device)
        self.drop = nn.Dropout(dropout)
        self.layer = nn.ModuleList(
            BertLayer(d_model, d_inner, num_heads, dropout=dropout, impl=impl, alibi=alibi, **mk)
            for _ in range(n_layer))
        self.pooler = Dense(d_model, d_model, dtype=torch.float32, **mk) if with_pooler else None

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.word_embeddings(input_ids)
        if self.position_embeddings is not None:
            x = x + self.position_embeddings(torch.arange(input_ids.shape[1],
                                                          device=input_ids.device))[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + self.token_type_embeddings(token_type_ids)
        x = self.drop(self.embed_norm(x.float()).to(self.dtype))
        seg = None if attention_mask is None else attention_mask.to(torch.int32)
        for layer in self.layer:
            x = layer(x, segment_ids=seg)
        pooled = None if self.pooler is None else torch.tanh(self.pooler(x[:, 0].float()))
        return x, pooled


class _MlmHead(nn.Module):
    """Dense (f32) -> exact GELU -> LayerNorm -> the word-embedding table
    (in its dtype) plus a bias: the tied MLM decoder, f32 logits."""

    def __init__(self, d_model, vocab_size, device, generator):
        super().__init__()
        self.mlm_transform = Dense(d_model, d_model, dtype=torch.float32, device=device,
                                   generator=generator)
        self.mlm_norm = LayerNorm(d_model, device=device)
        self.mlm_bias = zeros((vocab_size,), device)

    def mlm_logits(self, h, embed):
        h = self.mlm_norm(_gelu_exact(self.mlm_transform(h.float())))
        return embed.attend(h).float() + self.mlm_bias


class BertForMaskedLM(_MlmHead):
    """``BertModel`` (no pooler) and the tied MLM head: forward -> (B, L,
    vocab) f32 logits."""

    def __init__(self, vocab_size, d_model=768, n_layer=12, d_inner=3072, num_heads=12,
                 l_max=512, type_vocab_size=2, dropout=0.1, impl="auto", dtype=torch.float32,
                 device="cuda", generator=None):
        device = resolve_device(device)
        super().__init__(d_model, vocab_size, device, generator)
        self.vocab_size = vocab_size
        self.bert = BertModel(vocab_size, d_model=d_model, n_layer=n_layer, d_inner=d_inner,
                              num_heads=num_heads, l_max=l_max, type_vocab_size=type_vocab_size,
                              dropout=dropout, with_pooler=False, impl=impl, dtype=dtype,
                              device=device, generator=generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        h, _ = self.bert(input_ids, token_type_ids, attention_mask)
        return self.mlm_logits(h, self.bert.word_embeddings)


class BertForSequenceClassification(nn.Module):
    """``BertModel`` with its pooler, dropout and a Dense classifier (f32):
    forward -> (B, num_labels) logits."""

    def __init__(self, num_labels, vocab_size, d_model=768, n_layer=12, d_inner=3072,
                 num_heads=12, l_max=512, type_vocab_size=2, dropout=0.1, alibi=False,
                 impl="auto", dtype=torch.float32, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        self.bert = BertModel(vocab_size, d_model=d_model, n_layer=n_layer, d_inner=d_inner,
                              num_heads=num_heads, l_max=l_max, type_vocab_size=type_vocab_size,
                              dropout=dropout, with_pooler=True, impl=impl, alibi=alibi,
                              dtype=dtype, device=device, generator=generator)
        self.drop = nn.Dropout(dropout)
        self.classifier = Dense(d_model, num_labels, dtype=torch.float32, device=device,
                                generator=generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.drop(pooled))


class BertForPreTraining(_MlmHead):
    """``BertModel`` with its pooler, the tied MLM head and a next-sentence
    head (Dense to 2, f32): forward -> (mlm logits (B, L, vocab), nsp
    logits (B, 2))."""

    def __init__(self, vocab_size, d_model=768, n_layer=12, d_inner=3072, num_heads=12,
                 l_max=512, type_vocab_size=2, dropout=0.1, impl="auto", dtype=torch.float32,
                 device="cuda", generator=None):
        device = resolve_device(device)
        super().__init__(d_model, vocab_size, device, generator)
        self.vocab_size = vocab_size
        self.bert = BertModel(vocab_size, d_model=d_model, n_layer=n_layer, d_inner=d_inner,
                              num_heads=num_heads, l_max=l_max, type_vocab_size=type_vocab_size,
                              dropout=dropout, with_pooler=True, impl=impl, dtype=dtype,
                              device=device, generator=generator)
        self.nsp_head = Dense(d_model, 2, dtype=torch.float32, device=device, generator=generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        h, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.mlm_logits(h, self.bert.word_embeddings), self.nsp_head(pooled)
