"""Parity of the port's attention encoders with the flax modules: ViT
(``models/vit.py``), the attention BERT classes of ``models/bert.py``, the
HuggingFace-key imports ``import_vit_state_dict`` and
``import_bert_state_dict``, and ``interpolate_pos_embedding``.

The flax modules are initialised from a JAX key and run on the CPU (their
``impl="auto"`` attention is XLA's ``mha_reference`` there); their
parameters go to the port through ``utils.jax_weights``; the port runs on
the CPU, its attention the flash kernels' plain versions. Inputs come from
numpy with a seed. Widths differ from each other (d_model 48, d_inner 96,
patch 8, 3 channels; BERT d_model 32, d_inner 48) so that a wrong axis fails
on its shape. Tolerances: f32 outputs at atol 1e-4, grads at 1e-4 of each
parameter's largest |grad|; a bf16 ViT at 1e-2 (both round the same
activations to bf16, the products' summation orders differ).

The import tests build state dicts in memory under HuggingFace's key names
(``ViTForImageClassification``, ``BertForMaskedLM``): the JAX package's
import and the port's take the same tensors, and the two models must then
give the same logits. ``transformers`` is not needed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashfftconv_tpu_torch as tff
from flashfftconv_tpu.models import bert as jbert
from flashfftconv_tpu.models.vit import VisionTransformer as JViT
from flashfftconv_tpu.utils import checkpoint_import as jci
from flashfftconv_tpu_torch.utils import checkpoint_import as tci
from flashfftconv_tpu_torch.utils import jax_weights

VIT = dict(num_classes=10, patch_size=8, d_model=48, n_layer=2, num_heads=4, mlp_ratio=2)
BERT = dict(vocab_size=40, d_model=32, n_layer=2, d_inner=48, num_heads=4, l_max=32)


def _np(x):
    return np.array(x, np.float32)


def _grads_close(got: dict, ref: dict, rel=1e-4):
    assert set(got) == set(ref)
    for name, r in ref.items():
        g = got[name]
        assert g is not None and tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, atol=rel * max(float(np.abs(r).max()), 1e-12),
                                   err_msg=name)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _check(jm, params, tm, state_dict, args, targs, loss_of, tloss_of):
    """Outputs at atol 1e-4 and the grads of a loss of them at 1e-4 of each
    parameter's largest |grad|."""
    tm.load_state_dict(state_dict(_tree_np(params)), strict=True)
    tm.eval()
    ref = jax.jit(jm.apply)({"params": params}, *args)
    got = tm(*targs)
    for g, r in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(g.detach().numpy(), _np(r), atol=1e-4)
    gref = jax.jit(jax.grad(lambda p: loss_of(jm.apply({"params": p}, *args))))(params)
    tloss_of(got).backward()
    ref = {k: v.numpy() for k, v in state_dict(_tree_np(gref)).items()}
    _grads_close({n: p.grad for n, p in tm.named_parameters()}, ref)


def _images(seed, b=2, side=32):
    return np.random.default_rng(seed).standard_normal((b, side, side, 3)).astype(np.float32)


@pytest.mark.parametrize("global_pool", ["token", "avg"])
def test_vit_matches_flax(global_pool):
    """Logits and every parameter's grad (f32): 16 patches of 8 x 8 x 3, with
    a cls token 17 tokens."""
    imgs = _images(0)
    jm = JViT(**VIT, global_pool=global_pool, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(imgs))["params"]
    tm = tff.VisionTransformer(**VIT, img_size=32, in_chans=3, global_pool=global_pool,
                               dtype=torch.float32, device="cpu")
    assert ("cls_token" in dict(tm.named_parameters())) == (global_pool == "token")
    w = np.random.default_rng(1).standard_normal((2, 10)).astype(np.float32)
    _check(jm, params, tm, jax_weights.vit_state_dict, (jnp.asarray(imgs),),
           (torch.from_numpy(imgs),), lambda y: jnp.sum(y * w),
           lambda y: (y * torch.from_numpy(w)).sum())


def test_vit_bf16_matches_flax():
    """The default bf16 ViT (f32 residual, norms, attention and head)."""
    imgs = _images(2)
    jm = JViT(**VIT)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(imgs))["params"]
    tm = tff.VisionTransformer(**VIT, img_size=32, device="cpu")
    tm.load_state_dict(jax_weights.vit_state_dict(_tree_np(params)), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(imgs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(jm.apply({"params": params},
                                                         jnp.asarray(imgs))), atol=1e-2)


def _bert_inputs(seed, b=2, length=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, BERT["vocab_size"], (b, length))
    mask = np.ones((b, length), np.int32)
    mask[1, 10:] = 0  # a padded tail on row 1
    types = np.zeros((b, length), np.int64)
    types[:, length // 2 :] = 1
    labels = np.where(rng.random((b, length)) < 0.3, ids, -100)
    labels[1, 10:] = -100
    return ids, types, mask, labels


def _masked_nll(logits, labels, xp):
    """Mean NLL over labels != -100, in jnp or torch."""
    if xp is jnp:
        logp = jax.nn.log_softmax(logits, -1)
        nll = -jnp.take_along_axis(logp, jnp.maximum(labels, 0)[..., None], -1)[..., 0]
        m = (labels != -100).astype(jnp.float32)
        return (nll * m).sum() / m.sum()
    return torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                             labels.reshape(-1), ignore_index=-100)


def test_bert_for_masked_lm_matches_flax():
    """Logits at every position (pads attend only to pads on both sides) and
    the masked-LM grads of every parameter, the tied decoder included."""
    ids, types, mask, labels = _bert_inputs(0)
    jm = jbert.BertForMaskedLM(**BERT, dropout=0.0)
    args = tuple(jnp.asarray(a) for a in (ids, types, mask))
    params = jm.init(jax.random.PRNGKey(0), *args)["params"]
    tm = tff.BertForMaskedLM(**BERT, dropout=0.0, device="cpu")
    tl = torch.from_numpy(labels)
    _check(jm, params, tm, jax_weights.bert_state_dict, args,
           tuple(torch.from_numpy(a) for a in (ids, types, mask)),
           lambda y: _masked_nll(y, jnp.asarray(labels), jnp),
           lambda y: _masked_nll(y, tl, torch))


def test_bert_model_alibi_matches_flax():
    """BertModel with ALiBi (no position table) and a padded row: the hidden
    states, the pooled output, and the grads of a loss of both."""
    ids, types, mask, _ = _bert_inputs(1)
    jm = jbert.BertModel(**BERT, dropout=0.0, alibi=True)
    args = (jnp.asarray(ids), None, jnp.asarray(mask))
    params = jm.init(jax.random.PRNGKey(1), *args)["params"]
    tm = tff.BertModel(**BERT, dropout=0.0, alibi=True, device="cpu")
    assert tm.position_embeddings is None
    w = np.random.default_rng(2).standard_normal((2, 16, 32)).astype(np.float32)
    _check(jm, params, tm, jax_weights.bert_state_dict, args,
           (torch.from_numpy(ids), None, torch.from_numpy(mask)),
           lambda o: jnp.sum(o[0] * w) + jnp.sum(o[1]),
           lambda o: (o[0] * torch.from_numpy(w)).sum() + o[1].sum())


@pytest.mark.parametrize("alibi", [False, True])
def test_bert_for_sequence_classification_matches_flax(alibi):
    ids, types, mask, _ = _bert_inputs(2)
    jm = jbert.BertForSequenceClassification(num_labels=3, **BERT, dropout=0.0, alibi=alibi)
    args = tuple(jnp.asarray(a) for a in (ids, types, mask))
    params = jm.init(jax.random.PRNGKey(2), *args)["params"]
    tm = tff.BertForSequenceClassification(3, **BERT, dropout=0.0, alibi=alibi, device="cpu")
    w = np.random.default_rng(3).standard_normal((2, 3)).astype(np.float32)
    _check(jm, params, tm, jax_weights.bert_state_dict, args,
           tuple(torch.from_numpy(a) for a in (ids, types, mask)),
           lambda y: jnp.sum(y * w), lambda y: (y * torch.from_numpy(w)).sum())


def test_bert_for_pretraining_matches_flax():
    """MLM and next-sentence logits, and the grads of their two losses."""
    ids, types, mask, labels = _bert_inputs(3)
    nsp = np.array([0, 1])
    jm = jbert.BertForPreTraining(**BERT, dropout=0.0)
    args = tuple(jnp.asarray(a) for a in (ids, types, mask))
    params = jm.init(jax.random.PRNGKey(3), *args)["params"]
    tm = tff.BertForPreTraining(**BERT, dropout=0.0, device="cpu")
    tl = torch.from_numpy(labels)

    def jloss(o):
        return _masked_nll(o[0], jnp.asarray(labels), jnp) + _masked_nll(
            o[1][:, None], jnp.asarray(nsp)[:, None], jnp)

    def tloss(o):
        return _masked_nll(o[0], tl, torch) + _masked_nll(o[1][:, None],
                                                          torch.from_numpy(nsp)[:, None], torch)

    _check(jm, params, tm, jax_weights.bert_state_dict, args,
           tuple(torch.from_numpy(a) for a in (ids, types, mask)), jloss, tloss)


def _hf_vit_state(seed, d=48, f=96, c=3, p=8, n_tok=17, n_layer=2, classes=10):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.1).astype(np.float32))  # noqa: E731
    sd = {"vit.embeddings.cls_token": t(1, 1, d),
          "vit.embeddings.position_embeddings": t(1, n_tok, d),
          "vit.embeddings.patch_embeddings.projection.weight": t(d, c, p, p),
          "vit.embeddings.patch_embeddings.projection.bias": t(d),
          "vit.layernorm.weight": 1 + t(d), "vit.layernorm.bias": t(d),
          "classifier.weight": t(classes, d), "classifier.bias": t(classes)}
    for i in range(n_layer):
        pre = f"vit.encoder.layer.{i}."
        for n in ("query", "key", "value"):
            sd[f"{pre}attention.attention.{n}.weight"] = t(d, d)
            sd[f"{pre}attention.attention.{n}.bias"] = t(d)
        sd.update({f"{pre}attention.output.dense.weight": t(d, d),
                   f"{pre}attention.output.dense.bias": t(d),
                   f"{pre}intermediate.dense.weight": t(f, d),
                   f"{pre}intermediate.dense.bias": t(f),
                   f"{pre}output.dense.weight": t(d, f), f"{pre}output.dense.bias": t(d),
                   f"{pre}layernorm_before.weight": 1 + t(d), f"{pre}layernorm_before.bias": t(d),
                   f"{pre}layernorm_after.weight": 1 + t(d), f"{pre}layernorm_after.bias": t(d)})
    return sd


def test_import_vit_state_dict_matches_jax_import():
    """The same HF-keyed tensors through both imports: the same logits, and
    every key used."""
    sd = _hf_vit_state(0)
    jparams, jrep = jci.import_vit_state_dict(sd, n_layer=2)
    tensors, rep = tff.import_vit_state_dict(sd, n_layer=2)
    keys = sorted(k.removeprefix("vit.") for k in sd)
    assert rep.skipped == [] and sorted(rep.used) == sorted(jrep.used) == keys
    tm = tff.VisionTransformer(**VIT, img_size=32, dtype=torch.float32, device="cpu").eval()
    tci.load_into(tm, tensors, rep)
    assert rep.missing == []
    imgs = _images(5)
    ref = JViT(**VIT, dtype=jnp.float32).apply({"params": jparams}, jnp.asarray(imgs))
    with torch.no_grad():
        got = tm(torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-4)


def _hf_bert_state(seed, v=40, d=32, f=48, l_max=32, n_layer=2):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.1).astype(np.float32))  # noqa: E731
    sd = {"bert.embeddings.word_embeddings.weight": t(v, d),
          "bert.embeddings.position_embeddings.weight": t(l_max, d),
          "bert.embeddings.token_type_embeddings.weight": t(2, d),
          "bert.embeddings.LayerNorm.weight": 1 + t(d), "bert.embeddings.LayerNorm.bias": t(d),
          "bert.embeddings.position_ids": torch.arange(l_max)[None],
          "cls.predictions.bias": t(v),
          "cls.predictions.transform.dense.weight": t(d, d),
          "cls.predictions.transform.dense.bias": t(d),
          "cls.predictions.transform.LayerNorm.weight": 1 + t(d),
          "cls.predictions.transform.LayerNorm.bias": t(d)}
    sd["cls.predictions.decoder.weight"] = sd["bert.embeddings.word_embeddings.weight"]
    sd["cls.predictions.decoder.bias"] = sd["cls.predictions.bias"]
    for i in range(n_layer):
        pre = f"bert.encoder.layer.{i}."
        for n in ("query", "key", "value"):
            sd[f"{pre}attention.self.{n}.weight"] = t(d, d)
            sd[f"{pre}attention.self.{n}.bias"] = t(d)
        for name, shape in (("attention.output.dense", (d, d)), ("intermediate.dense", (f, d)),
                            ("output.dense", (d, f))):
            sd[f"{pre}{name}.weight"] = t(*shape)
            sd[f"{pre}{name}.bias"] = t(shape[0])
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{pre}{name}.weight"] = 1 + t(d)
            sd[f"{pre}{name}.bias"] = t(d)
    return sd


def test_import_bert_state_dict_matches_jax_import():
    """The same HF-keyed tensors through both imports: the tied decoder and
    the position_ids buffer skipped as in the JAX import, the same logits
    on a padded batch."""
    sd = _hf_bert_state(1)
    jparams, jrep = jci.import_bert_state_dict(sd, n_layer=2)
    tensors, rep = tff.import_bert_state_dict(sd, n_layer=2)
    assert sorted(rep.used) == sorted(jrep.used)
    assert sorted(rep.skipped) == sorted(jrep.skipped) == [
        "bert.embeddings.position_ids", "cls.predictions.decoder.bias",
        "cls.predictions.decoder.weight"]
    tm = tff.BertForMaskedLM(**BERT, dropout=0.0, device="cpu").eval()
    tci.load_into(tm, tensors, rep)
    assert rep.missing == []
    ids, types, mask, _ = _bert_inputs(6)
    ref = jbert.BertForMaskedLM(**BERT, dropout=0.0).apply(
        {"params": jparams}, *(jnp.asarray(a) for a in (ids, types, mask)))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (ids, types, mask)))
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-4)


@pytest.mark.parametrize("out_seqlen,interleave", [(8, False), (12, False), (16, True)])
def test_interpolate_pos_embedding_matches_jax(out_seqlen, interleave):
    emb = np.random.default_rng(out_seqlen).standard_normal((1, 4, 3)).astype(np.float32)
    ref = jci.interpolate_pos_embedding(emb, out_seqlen, interleave=interleave)
    got = tff.interpolate_pos_embedding(torch.from_numpy(emb), out_seqlen, interleave=interleave)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_interpolate_pos_embedding_refuses_what_jax_refuses():
    emb = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError):
        tff.interpolate_pos_embedding(emb, 10)
    with pytest.raises(ValueError):
        tff.interpolate_pos_embedding(emb, 32, interleave=True)
