"""M2-BERT on the port against the flax modules: the M2 mixer, the MLM model's
logits and grads, the checkpoint import, the example's train steps and
batches. Helpers and tolerances are those of ``test_torch_bert.py``, whose
docstring states them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flashfftconv_tpu.models import bert as jbert
from flashfftconv_tpu.models import m2_bert as jm2
from flashfftconv_tpu.utils import checkpoint_import as jci
from flashfftconv_tpu_torch.models import bert as tbert
from flashfftconv_tpu_torch.models import m2_bert as tm2
from flashfftconv_tpu_torch.utils import checkpoint_import as tci
from flashfftconv_tpu_torch.utils import data, jax_weights, metrics, optim, train
import importlib.util
from pathlib import Path
from test_torch_bert import CPU, _np

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)


ROOT = Path(__file__).resolve().parent.parent


def _init(model, *args, **kw):
    params = model.init(jax.random.PRNGKey(0), *args, **kw)["params"]
    return params, jax.tree_util.tree_map(np.asarray, params)


def _assert_grads_match(jax_grads: dict, model, tol=1e-4):
    """Every parameter's grad against jax's; a parameter that the forward
    never reads (the filters' skip bias, which only the Hyena operator uses;
    an unused token-type table) has no grad here and a zero one there."""
    assert set(jax_grads) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        ref = jax_grads[name].numpy()
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        err = float(np.abs(grad.numpy() - ref).max())
        assert err <= tol * float(np.abs(ref).max()) + 1e-7, (name, err, float(np.abs(ref).max()))


LM = dict(vocab_size=64, d_model=32, n_layer=2, d_inner=64, l_max=128)


LM_CASES = {
    "untied_blockdiag": dict(mlp_nblocks=4),
    "tied_dense": dict(mlp_nblocks=0, tie_mlm_head=True),
    "ref_structure": dict(mlp_nblocks=4, ref_structure=True),
    "glu_dense": dict(mlp_nblocks=0, use_glu_mlp=True, tie_mlm_head=True),
    "attention_mask": dict(mlp_nblocks=0),
}


MIXER = dict(d_model=32, l_max=128)


def _lm_pair(case):
    kw = LM_CASES[case]
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 64, (2, 128))
    extra = {}
    if case == "attention_mask":
        mask = np.ones((2, 128), np.int32)
        mask[1, 100:] = 0
        extra = dict(token_type_ids=rng.integers(0, 2, (2, 128)), attention_mask=mask)
    jm = jbert.M2BertForMaskedLM(**LM, **kw, dropout=0.0, conv_dtype=jnp.float32, impl="pallas")
    params, pnp = _init(jm, jnp.asarray(ids), **{k: jnp.asarray(v) for k, v in extra.items()})
    tm = tbert.M2BertForMaskedLM(**LM, **kw, conv_dtype=torch.float32, device=CPU).eval()
    sd = jax_weights.m2_bert_state_dict(pnp)
    if "token_type_ids" not in extra:  # a table the flax model never used has no params
        sd["bert.token_type_embeddings.weight"] = tm.bert.token_type_embeddings.weight.detach()
    tm.load_state_dict(sd, strict=True)
    return jm, params, tm, ids, extra


def _example_module():
    """examples/bert/train.py as a module (its PRESETS and mlm_batch)."""
    spec = importlib.util.spec_from_file_location("examples_bert_train",
                                                  ROOT / "examples" / "bert" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_m2_state(rng, n_layer=2, d=16, d_inner=32, vocab=40, l_max=32, order=16,
                        nblocks=4):
    """A state dict shaped like the reference M2-BERT checkpoint (bidirectional
    filters, residual long conv, block-diagonal MLP), random values."""
    r = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    state = {
        "bert.embeddings.word_embeddings.weight": r(vocab, d),
        "bert.embeddings.position_embeddings.weight": r(l_max, d),
        "bert.embeddings.token_type_embeddings.weight": r(2, d),
        "bert.embeddings.LayerNorm.weight": r(d), "bert.embeddings.LayerNorm.bias": r(d),
        "bert.embeddings.position_ids": torch.arange(l_max)[None],
        "bert.pooler.dense.weight": r(d, d),
        "cls.predictions.transform.dense.weight": r(d, d),
        "cls.predictions.transform.dense.bias": r(d),
        "cls.predictions.transform.LayerNorm.weight": r(d),
        "cls.predictions.transform.LayerNorm.bias": r(d),
        "cls.predictions.decoder.weight": r(vocab, d), "cls.predictions.bias": r(vocab),
    }
    for i in range(n_layer):
        a = f"model.bert.encoder.layer.{i}.attention"
        state.update({f"{a}.in_linear.weight": r(3 * d, d), f"{a}.in_linear.bias": r(3 * d),
                      f"{a}.short_filter.weights": r(3 * d, 3), f"{a}.short_filter.bias": r(3 * d),
                      f"{a}.out_linear.weight": r(d, d), f"{a}.out_linear.bias": r(d)})
        for fn in ("filter_fn", "filter_fn2"):
            state.update({f"{a}.{fn}.bias": r(d), f"{a}.{fn}.modulation.deltas": r(1, 1, d),
                          f"{a}.{fn}.pos_emb.z": r(1, l_max, 5),
                          f"{a}.{fn}.pos_emb.t": r(1, l_max, 1)})
            for seq in ("implicit_filter", "implicit_filter_rev"):
                shapes = [(order, 5), None, (order, order), None, (order, order), None, (d, order)]
                for j, shape in enumerate(shapes):
                    key = f"{a}.{fn}.{seq}.{j}"
                    if shape is None:
                        state[f"{key}.freq"] = r(1, order)
                    else:
                        state[f"{key}.weight"] = r(*shape)
                        if j < 6:
                            state[f"{key}.bias"] = r(shape[0])
        m = f"model.bert.encoder.layer.{i}.mlp"
        state.update({f"{m}.gated_layers.weight": r(nblocks, d_inner // nblocks, d // nblocks),
                      f"{m}.gated_layers.bias": r(d_inner),
                      f"{m}.wo.weight": r(nblocks, d // nblocks, d_inner // nblocks),
                      f"{m}.wo.bias": r(d), f"{m}.layernorm.weight": r(d),
                      f"{m}.layernorm.bias": r(d)})
    return state


@pytest.mark.parametrize("nblocks,bias", [(4, True), (2, False)])
def test_blockdiag_linear_matches_flax(nblocks, bias):
    x = np.random.default_rng(nblocks).standard_normal((2, 5, 16)).astype(np.float32)
    jm = jm2.BlockdiagLinear(24, nblocks=nblocks, use_bias=bias)
    params, pnp = _init(jm, jnp.asarray(x))
    dout = np.random.default_rng(1).standard_normal((2, 5, 24)).astype(np.float32)
    ref = _np(jm.apply({"params": params}, jnp.asarray(x)))
    gp = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * dout))(params)
    tm = tm2.BlockdiagLinear(16, 24, nblocks=nblocks, bias=bias, device=CPU)
    tm.load_state_dict({k: torch.from_numpy(_np(v)) for k, v in pnp.items()}, strict=True)
    y = tm(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), ref, atol=1e-5)
    (y * torch.from_numpy(dout)).sum().backward()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(gp[name]), atol=1e-5)
    w = tm.weight.detach()
    dense = torch.block_diag(*w.unbind(0))
    np.testing.assert_allclose(tm2.blockdiag_multiply(torch.from_numpy(x), w).numpy(),
                               x @ dense.numpy().T, atol=1e-5)
    with pytest.raises(ValueError):
        tm2.BlockdiagLinear(10, 24, nblocks=4, device=CPU)


@pytest.mark.parametrize("bidirectional,residual,inference", [
    (b, r, i) for b in (False, True) for r in (False, True) for i in (False, True)])
def test_m2_mixer_matches_flax(bidirectional, residual, inference):
    """Output and every grad of the f32 mixer (the JAX side's convs through
    _direct_fused_io_tiles and its backward in interpret mode)."""
    kw = dict(bidirectional=bidirectional, residual_long_conv=residual, inference_mode=inference)
    jm = jm2.MonarchMixerSequenceMixing(**MIXER, **kw, conv_dtype=jnp.float32, impl="pallas")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 128, 32)).astype(np.float32)
    dout = rng.standard_normal((2, 128, 32)).astype(np.float32)
    params, pnp = _init(jm, jnp.asarray(x))
    ref = _np(jm.apply({"params": params}, jnp.asarray(x)))
    gp, gx = jax.grad(lambda p, a: jnp.sum(jm.apply({"params": p}, a) * dout),
                      argnums=(0, 1))(params, jnp.asarray(x))
    tm = tm2.MonarchMixerSequenceMixing(**MIXER, **kw, conv_dtype=torch.float32, device=CPU)
    sd = jax_weights.m2_mixer_state_dict(pnp)
    tm.load_state_dict(sd, strict=True)
    tx = torch.from_numpy(x).requires_grad_()
    y = tm(tx)
    np.testing.assert_allclose(y.detach().numpy(), ref, atol=1e-4 * float(np.abs(ref).max()))
    (y * torch.from_numpy(dout)).sum().backward()
    _assert_grads_match(
        jax_weights.m2_mixer_state_dict(jax.tree_util.tree_map(np.asarray, gp)), tm)
    gx = _np(gx)
    np.testing.assert_allclose(tx.grad.numpy(), gx, atol=1e-4 * float(np.abs(gx).max()))


@pytest.mark.parametrize("case", list(LM_CASES))
def test_m2_bert_mlm_logits_and_grads_match_flax(case):
    """A 2-layer f32 M2BertForMaskedLM: logits at 2e-3 and the masked-LM
    loss's grads (labels -100 off the masked positions), every parameter at
    5e-4 of its largest |grad| (module docstring)."""
    jm, params, tm, ids, extra = _lm_pair(case)
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}
    ref = _np(jm.apply({"params": params}, jnp.asarray(ids), **jextra))
    logits = tm(torch.from_numpy(ids), **textra)
    assert logits.dtype == torch.float32 and logits.shape == (2, 128, 64)
    np.testing.assert_allclose(logits.detach().numpy(), ref, atol=2e-3)
    labels = np.where(np.random.default_rng(5).random(ids.shape) < 0.15, ids, -100)

    def jloss(p):
        lg = jm.apply({"params": p}, jnp.asarray(ids), **jextra)
        m = (labels >= 0).astype(jnp.float32)
        logp = jax.nn.log_softmax(lg)
        nll = -jnp.take_along_axis(logp, jnp.maximum(labels, 0)[..., None], -1)[..., 0]
        return (nll * m).sum() / jnp.maximum(m.sum(), 1.0)

    loss, grads = jax.value_and_grad(jloss)(params)
    got = metrics.cross_entropy(logits, torch.from_numpy(labels), -100)
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= 1e-5 * float(loss)
    jg = jax_weights.m2_bert_state_dict(jax.tree_util.tree_map(np.asarray, grads))
    if case != "attention_mask":
        jg["bert.token_type_embeddings.weight"] = torch.zeros_like(
            tm.bert.token_type_embeddings.weight)
    _assert_grads_match(jg, tm, tol=5e-4)


@pytest.mark.parametrize("tie", [False, True])
def test_m2_bert_flax_paths_invert_the_key_map(tie):
    """flax_paths(model)[name] leads, in the flax tree, to the leaf that
    m2_bert_state_dict puts under name (transposed for Dense kernels), and
    the optimizer's labels follow the JAX package's."""
    from flashfftconv_tpu.utils import optim as joptim

    jm = jbert.M2BertForMaskedLM(**LM, tie_mlm_head=tie, conv_dtype=jnp.float32, impl="xla")
    ids = jnp.zeros((1, 128), jnp.int32)
    _, pnp = _init(jm, ids, token_type_ids=ids)
    tm = tbert.M2BertForMaskedLM(**LM, tie_mlm_head=tie, conv_dtype=torch.float32, device=CPU)

    def paths(tree, prefix=()):
        if not isinstance(tree, dict):
            return {prefix: tree}
        return {k: v for name, sub in tree.items() for k, v in paths(sub, prefix + (name,)).items()}

    leaves = paths(pnp)
    sd = jax_weights.m2_bert_state_dict(pnp)
    fp = jax_weights.flax_paths(tm)
    assert set(fp) == set(sd) and sorted(fp.values()) == sorted(leaves)
    for name, path in fp.items():
        leaf = np.asarray(leaves[path], np.float32)
        np.testing.assert_array_equal(leaf.T if path[-1] == "kernel" else leaf, sd[name].numpy())
    jlabels = paths(joptim.label_params(pnp, joptim.kernel_label_fn))
    assert {fp[n]: lab for n, lab in optim.label_params(tm).items()} == jlabels


def test_m2_bert_preset_and_fill_mask():
    """base-110M is the example's preset (110M parameters with the tied
    head); fill_mask answers requests in eval mode and restores the mode."""
    ex = _example_module().PRESETS["base-110M"]
    mine = tbert.PRESETS["base-110M"]
    assert {k: mine[k] for k in ex} == ex and mine["d_inner"] == 4 * mine["d_model"]
    with torch.device("meta"):
        big = tbert.M2BertForMaskedLM(**{k: v for k, v in mine.items() if k != "batch_size"},
                                      device="meta")
    assert 109e6 < sum(p.numel() for p in big.parameters()) < 111e6
    model = tbert.build_model("base-110M", dtype=torch.float32, device=CPU, n_layer=1,
                              d_model=32, d_inner=64, vocab_size=300,
                              generator=torch.Generator().manual_seed(0)).train()
    ids = torch.randint(0, 256, (3, 40), generator=torch.Generator().manual_seed(1))
    labels = torch.full_like(ids, -100)
    labels[:, ::5] = ids[:, ::5]
    out = tbert.fill_mask(model, ids.masked_fill(labels >= 0, data.MASK_ID), labels)
    assert model.training and bool(out["finite"])
    assert out["top1"].shape == (3, 40) and out["accuracy"].shape == (3,)
    assert bool(((out["accuracy"] >= 0) & (out["accuracy"] <= 1)).all())


def test_m2_bert_import_matches_the_jax_import():
    """import_m2_bert_state_dict gives, under the port's names, exactly the
    weights that the JAX import puts in the flax tree (mapped by
    m2_bert_state_dict), skips the same keys, loads into
    M2BertForMaskedLM(ref_structure=True) and, through
    blockdiag_to_dense_mlp, into a dense-MLP model as the JAX conversion
    does."""
    state = _reference_m2_state(np.random.default_rng(0))
    jtree, jrep = jci.import_m2_bert_state_dict(state)
    tensors, rep = tci.import_m2_bert_state_dict(state)
    # (the JAX report names a filter's shared keys once for each of its two MLPs)
    assert sorted(rep.skipped) == sorted(set(jrep.skipped))
    assert sorted(rep.used) == sorted(set(jrep.used))
    cfg = dict(vocab_size=40, d_model=16, n_layer=2, d_inner=32, l_max=32, mlp_nblocks=4,
               ref_structure=True, conv_dtype=jnp.float32, impl="xla")
    jm = jbert.M2BertForMaskedLM(**cfg)
    ids = jnp.zeros((1, 32), jnp.int32)
    init = jm.init(jax.random.PRNGKey(0), ids, token_type_ids=ids)["params"]
    merged = jax.tree_util.tree_map(np.asarray, jci.merge_params(init, jtree))
    want = jax_weights.m2_bert_state_dict(merged)
    for name, t in tensors.items():
        if not name.endswith("modulation.deltas"):
            np.testing.assert_array_equal(t.numpy(), want[name].numpy(), err_msg=name)
    tcfg = {**cfg, "conv_dtype": torch.float32}
    del tcfg["impl"]
    model = tbert.M2BertForMaskedLM(**tcfg, device=CPU)
    report = tci.ImportReport()
    tci.load_into(model, tensors, report)
    # only the reverse filters' skip biases, which the mixer never reads
    assert set(report.missing) == {f"bert.layer.{i}.mixer.{f}_rev.bias" for i in range(2)
                                   for f in ("filter", "filter2")}
    dense = tci.blockdiag_to_dense_mlp(tensors)
    jdense = jax_weights.m2_bert_state_dict(
        jax.tree_util.tree_map(np.asarray, jci.blockdiag_to_dense_mlp(merged)))
    for name in ("bert.layer.0.mlp_fc1.weight", "bert.layer.1.mlp_fc2.weight"):
        assert dense[name].ndim == 2
        np.testing.assert_array_equal(dense[name].numpy(), jdense[name].numpy())
    model = tbert.M2BertForMaskedLM(**{**tcfg, "mlp_nblocks": 0}, device=CPU)
    tci.load_into(model, dense)


def test_bert_train_steps_match_the_example_optax_chain():
    """Three steps of the examples/bert chain (clip_by_global_norm(1.0), then
    adamw(8e-4, weight_decay=1e-5) on every parameter), its masked-LM loss
    and accuracy, on mlm_batches of the same seed, dropout off: losses
    within 1e-4 relative, accuracies equal, parameters within 2 * lr * steps."""
    lr, steps = 8e-4, 3
    cfg = dict(vocab_size=260, d_model=32, n_layer=2, d_inner=64, l_max=128, mlp_nblocks=0,
               tie_mlm_head=True)
    jm = jbert.M2BertForMaskedLM(**cfg, dropout=0.0, conv_dtype=jnp.float32, impl="xla")
    tokens = np.random.default_rng(2).integers(0, 256, 20_000).astype(np.int32)
    batches = data.mlm_batches(tokens, 2, 128, np.random.default_rng(5))
    xs = [next(batches) for _ in range(steps)]
    params, pnp = _init(jm, jnp.asarray(xs[0][0]))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr, weight_decay=1e-5))
    opt_state = tx.init(params)

    @jax.jit
    def jstep(params, opt_state, x, labels):
        def loss_fn(p):
            logits = jm.apply({"params": p}, x, deterministic=True)
            m = (labels >= 0).astype(jnp.float32)
            logp = jax.nn.log_softmax(logits.astype(jnp.float32))
            nll = -jnp.take_along_axis(logp, jnp.maximum(labels, 0)[..., None], -1)[..., 0]
            loss = (nll * m).sum() / jnp.maximum(m.sum(), 1.0)
            acc = ((logits.argmax(-1) == labels).astype(jnp.float32) * m).sum() / jnp.maximum(
                m.sum(), 1.0)
            return loss, acc

        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, acc

    jout = []
    for x, y in xs:
        params, opt_state, loss, acc = jstep(params, opt_state, jnp.asarray(x), jnp.asarray(y))
        jout.append((float(loss), float(acc)))
    tm = tbert.M2BertForMaskedLM(**cfg, conv_dtype=torch.float32, device=CPU).eval()
    sd = jax_weights.m2_bert_state_dict(pnp)
    sd["bert.token_type_embeddings.weight"] = tm.bert.token_type_embeddings.weight.detach()
    tm.load_state_dict(sd, strict=True)
    opt = train.bert_optimizer(tm)
    assert opt.defaults["lr"] == lr and opt.defaults["weight_decay"] == 1e-5
    assert len(opt.param_groups) == 1 and len(opt.param_groups[0]["params"]) == len(
        list(tm.parameters()))
    step = train.make_train_step(tm, opt, None, clip=1.0, loss_fn=train.mlm_loss)
    out = [step(torch.from_numpy(x), torch.from_numpy(y)) for x, y in xs]
    np.testing.assert_allclose([float(o["loss"]) for o in out], [j[0] for j in jout], rtol=1e-4)
    np.testing.assert_allclose([float(o["accuracy"]) for o in out], [j[1] for j in jout],
                               atol=1e-6)
    want = jax_weights.m2_bert_state_dict(jax.tree_util.tree_map(np.asarray, params))
    for name, p in tm.named_parameters():
        if name in want:
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       atol=2 * lr * steps, err_msg=name)


@pytest.mark.parametrize("batch,seq_len,prob", [(4, 128, 0.15), (3, 37, 0.5)])
def test_mlm_batches_match_the_example(batch, seq_len, prob):
    """The same generator gives the example's mlm_batch, batch after batch:
    masked positions hold id 256 and their labels the true ids, -100
    elsewhere."""
    ex = _example_module()
    tokens = np.random.default_rng(0).integers(0, 256, 5000).astype(np.int32)
    mine = data.mlm_batches(tokens, batch, seq_len, np.random.default_rng(7), mask_prob=prob)
    rng = np.random.default_rng(7)
    assert data.MASK_ID == ex.MASK_ID
    for _ in range(3):
        x, y = next(mine)
        rx, ry = ex.mlm_batch(tokens, batch, seq_len, prob, rng)
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)
        assert x.shape == (batch, seq_len) and ((x == data.MASK_ID) == (y >= 0)).all()
