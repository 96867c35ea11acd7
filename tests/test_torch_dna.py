"""HyenaDNA on the port against the flax modules and the JAX package's import
and scoring: logits, the checkpoint import, loss and grads under remat, and
the example's optax chain. Helpers and tolerances are those of
``test_torch_models.py``, whose docstring states them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import optax
from flashfftconv_tpu.models.lm import ConvLMHeadModel as JLM
from flashfftconv_tpu.utils import metrics as jmetrics
from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel
from flashfftconv_tpu_torch.utils import data, jax_weights, metrics, train
from test_torch_models import CPU, _assert_grads_match, _init, _np

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)


DNA = dict(d_model=64, n_layer=2, d_inner=256, vocab_size=5, l_max=65536)


def test_hyenadna_logits_match_flax():
    """A 2-layer HyenaDNA (filter emb_dim 5, vocab 5 padded to 8, l_max 65536,
    FFT size 131072): flax params through jax_weights into the port's
    build_model, logits against the flax model (its long convs through
    _long_tiles in interpret mode) at 2e-3, in f32."""
    from flashfftconv_tpu_torch.models import dna

    jm = JLM(**DNA, mixer_kwargs={"impl": "pallas", "conv_dtype": jnp.float32,
                                  "filter_args": {"emb_dim": 5}},
             dtype=jnp.float32, pad_vocab_size_multiple=8)
    ids = dna.synthetic_genome(0, n=DNA["l_max"])[None].astype(np.int64)
    params, pnp = _init(jm, jnp.asarray(ids[:, :256]))
    ref = _np(jm.apply({"params": params}, jnp.asarray(ids)))
    tm = dna.build_model("tiny-1k", d_model=64, n_layer=2, l_max=DNA["l_max"],
                         dtype=torch.float32, mixer_kwargs={"conv_dtype": torch.float32},
                         device=CPU).eval()
    tm.load_state_dict(jax_weights.from_jax_params(pnp), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    assert got.shape == (1, DNA["l_max"], 8) and tm.vocab_size == 8
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-3)


def _hyenadna_state(rng, d=32, d_inner=64, vocab=8, n_layer=2, emb_dim=5, order=64):
    """A synthetic HyenaDNA state dict with the reference loader's key layout:
    a ``model.`` prefix and the ``.mixer.layer`` / ``.mlp.layer`` segments
    that gradient checkpointing injects into layer 1."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    state = {"model.backbone.embeddings.word_embeddings.weight": f(vocab, d)}
    for i in range(n_layer):
        mixer = "mixer.layer" if i == 1 else "mixer"
        mlp = "mlp.layer" if i == 1 else "mlp"
        p = f"model.backbone.layers.{i}"
        state |= {
            f"{p}.{mixer}.in_proj.weight": f(3 * d, d), f"{p}.{mixer}.in_proj.bias": f(3 * d),
            f"{p}.{mixer}.short_filter.weight": f(3 * d, 1, 3),
            f"{p}.{mixer}.short_filter.bias": f(3 * d),
            f"{p}.{mixer}.filter_fn.bias": f(d),
            f"{p}.{mixer}.filter_fn.pos_emb.z": f(1, 128, emb_dim),
            f"{p}.{mixer}.filter_fn.pos_emb.t": f(1, 128, 1),
            f"{p}.{mixer}.filter_fn.modulation.deltas": f(1, 1, d),
            f"{p}.{mixer}.out_proj.weight": f(d, d), f"{p}.{mixer}.out_proj.bias": f(d),
            f"{p}.norm1.weight": f(d), f"{p}.norm1.bias": f(d),
            f"{p}.norm2.weight": f(d), f"{p}.norm2.bias": f(d),
            f"{p}.{mlp}.fc1.weight": f(d_inner, d), f"{p}.{mlp}.fc1.bias": f(d_inner),
            f"{p}.{mlp}.fc2.weight": f(d, d_inner), f"{p}.{mlp}.fc2.bias": f(d),
        }
        for j, (cin, cout) in enumerate([(emb_dim, order), (order, order), (order, order)]):
            state[f"{p}.{mixer}.filter_fn.implicit_filter.{2 * j}.weight"] = f(cout, cin)
            state[f"{p}.{mixer}.filter_fn.implicit_filter.{2 * j}.bias"] = f(cout)
            state[f"{p}.{mixer}.filter_fn.implicit_filter.{2 * j + 1}.freq"] = f(1, order)
        state[f"{p}.{mixer}.filter_fn.implicit_filter.6.weight"] = f(d, order)
    state["model.backbone.ln_f.weight"] = f(d)
    state["model.backbone.ln_f.bias"] = f(d)
    state["model.lm_head.weight"] = f(vocab, d)  # tied: skipped
    return {"state_dict": state}


def test_hyenadna_import_matches_the_jax_import():
    """The port's import_hyenadna gives the weights that the JAX package's
    hyenadna_to_flax -> merge_params -> jax_weights.from_jax_params gives,
    exactly; the reports name the same used keys."""
    from flashfftconv_tpu.utils import checkpoint_import as jci
    from flashfftconv_tpu_torch.utils import checkpoint_import as tci

    state = _hyenadna_state(np.random.default_rng(7))
    kw = dict(d_model=32, n_layer=2, d_inner=64, vocab_size=8, l_max=128)
    jm = JLM(**kw, mixer_kwargs={"impl": "xla", "in_proj_bias": True,
                                 "filter_args": {"emb_dim": 5}}, dtype=jnp.float32)
    init, _ = _init(jm, jnp.zeros((1, 128), jnp.int32))
    imported, jreport = jci.hyenadna_to_flax(state)
    merged = jci.merge_params(jax.tree_util.tree_map(np.asarray, init), imported, jreport)
    want = jax_weights.from_jax_params(jax.tree_util.tree_map(np.asarray, merged))

    tm = ConvLMHeadModel(**kw, mixer_kwargs={"in_proj_bias": True, "filter_args": {"emb_dim": 5}},
                         dtype=torch.float32, device=CPU,
                         generator=torch.Generator().manual_seed(0))
    report = tci.import_hyenadna(tm, state)
    got = tm.state_dict()
    assert set(got) == set(want)
    for name, t in want.items():
        assert torch.equal(got[name], t), name
    assert report.missing == [] and jreport.missing == []
    deltas = [k for k in report.skipped if k.endswith("modulation.deltas")]
    assert len(deltas) == 2  # constants of the port's filter, parameters nowhere
    assert sorted(report.used + deltas) == sorted(jreport.used)
    assert "lm_head.weight" in report.skipped
    assert sum(k.endswith(("pos_emb.z", "pos_emb.t")) for k in report.skipped) == 4


def test_hyenadna_import_reports_and_refuses():
    from flashfftconv_tpu_torch.utils import checkpoint_import as tci

    assert tci.strip_checkpointing_keys("a.mixer.layer.in_proj.weight") == "a.mixer.in_proj.weight"
    state = _hyenadna_state(np.random.default_rng(8))["state_dict"]
    norm = tci.normalize_state_dict({"state_dict": state})
    assert all(not k.startswith("model.") and ".layer." not in k for k in norm)
    tensors, report = tci.hyenadna_state_dict(state, n_layer=1)
    assert not any(k.startswith("backbone.blocks.1.") for k in tensors)
    assert tensors["backbone.blocks.0.mixer.short_filter.weights"].shape == (96, 3)
    assert any(k.startswith("backbone.layers.1.") for k in report.skipped)
    kw = dict(d_model=32, n_layer=2, d_inner=64, vocab_size=8, l_max=128, dtype=torch.float32,
              device=CPU)
    # a model without the in-projection bias leaves the checkpoint's unused
    tm = ConvLMHeadModel(**kw, mixer_kwargs={"filter_args": {"emb_dim": 5}})
    partial = {k: v for k, v in state.items() if "ln_f" not in k}
    report = tci.import_hyenadna(tm, partial)
    assert sorted(report.missing) == ["backbone.ln_f.bias", "backbone.ln_f.weight"]
    assert sum(k.endswith("in_proj.bias") for k in report.skipped) == 2
    with pytest.raises(ValueError, match="shape mismatch"):
        tci.import_hyenadna(ConvLMHeadModel(**{**kw, "d_inner": 128}), state)


def test_dna_score_and_genome():
    """score gives the mean bits per base of positions 1..L-1 and the argmax
    over the five bases after the last one, in eval mode; the synthetic
    genome is the JAX example's; presets are the example's."""
    import importlib.util
    from pathlib import Path

    from flashfftconv_tpu_torch.models import dna

    spec = importlib.util.spec_from_file_location(
        "hyena_dna_train", Path(__file__).resolve().parent.parent / "examples/hyena_dna/train.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    args = type("Args", (), {"fasta": "", "seed": 3})()
    genome = dna.synthetic_genome(3)
    np.testing.assert_array_equal(genome, example.load_genome(args))
    assert dna.MODEL_CONFIGS == example.MODEL_CONFIGS and dna.DNA_VOCAB == example.DNA_VOCAB

    tm = dna.build_model("tiny-1k", dtype=torch.float32, device=CPU,
                         mixer_kwargs={"conv_dtype": torch.float32},
                         generator=torch.Generator().manual_seed(1)).train()
    assert tm.vocab_size == 8 and tm.backbone.blocks[0].mixer.filter.z.shape[-1] == 5
    ids = torch.from_numpy(genome[:2048].reshape(2, 1024).astype(np.int64))
    out = dna.score(tm, ids)
    assert tm.training  # the caller's mode comes back
    with torch.no_grad():
        logits = tm.eval()(ids)
    want = [float(jmetrics.cross_entropy(jnp.asarray(logits[i, :-1].numpy()),
                                         jnp.asarray(ids[i, 1:].numpy()))) / np.log(2)
            for i in range(2)]
    np.testing.assert_allclose(out["bits_per_base"].numpy(), want, rtol=1e-5)
    assert out["next_base"].tolist() == logits[:, -1, :5].argmax(-1).tolist()
    assert bool(out["finite"]) and 1.0 < float(out["bits_per_base"].mean()) < 4.0
    with pytest.raises(ValueError):
        dna.score(tm, ids[0])
    with pytest.raises(NotImplementedError, match="power of two"):
        dna.build_model("medium-160k", device=CPU)


def _hyenadna_pair(l_max, **jax_kw):
    """A 2-layer f32 HyenaDNA (d_model 32, filter emb_dim 5, vocab 5 padded to
    8) as a flax model with remat=True and as the port's build_model with the
    same weights and the same lever, and one batch of l_max bases."""
    from flashfftconv_tpu_torch.models import dna

    jm = JLM(d_model=32, n_layer=2, d_inner=128, vocab_size=5, l_max=l_max, remat=True,
             mixer_kwargs={"conv_dtype": jnp.float32, "filter_args": {"emb_dim": 5}, **jax_kw},
             dtype=jnp.float32, pad_vocab_size_multiple=8)
    genome = dna.synthetic_genome(4, n=4 * l_max)
    x, y = next(data.lm_batches(genome, 1, l_max, np.random.default_rng(4)))
    params, pnp = _init(jm, jnp.asarray(x[:, :256]))
    tm = dna.build_model("tiny-1k", d_model=32, n_layer=2, l_max=l_max, dtype=torch.float32,
                         mixer_kwargs={"conv_dtype": torch.float32}, device=CPU, remat=True)
    tm.load_state_dict(jax_weights.from_jax_params(pnp), strict=True)
    return jm, params, tm.eval(), x.astype(np.int64), y.astype(np.int64)


def test_hyenadna_loss_and_grads_match_flax_with_remat():
    """l_max 32768, so FFT size 65536: the flax model's convs go through
    _long_tiles and the long backward of its custom VJP in interpret mode,
    the port's through the long chain's plain versions, both with every block
    rematerialised. Loss within 1e-5, grads within 1e-4 of each parameter's
    largest |grad|."""
    jm, params, tm, x, y = _hyenadna_pair(32768, impl="pallas")
    loss, grads = jax.value_and_grad(lambda p: jmetrics.cross_entropy(
        jm.apply({"params": p}, jnp.asarray(x), deterministic=True), jnp.asarray(y)))(params)
    got = metrics.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= 1e-5 * float(loss)
    _assert_grads_match(jax_weights.from_jax_params(jax.tree_util.tree_map(np.asarray, grads)), tm)


def test_dna_train_step_matches_the_example_optax_chain():
    """Three steps of the examples/hyena_dna chain (clip_by_global_norm(1.0),
    then adamw(6e-4, weight_decay=0.1), no schedule, deterministic) against
    make_train_step over dna_optimizer, from the same weights on lm_batches'
    windows: losses within 1e-4 relative, parameters within 2 * lr * steps."""
    from flashfftconv_tpu_torch.models import dna

    lr, steps = 6e-4, 3
    jm, params, tm, _, _ = _hyenadna_pair(1024, impl="xla")
    genome = dna.synthetic_genome(5, n=50_000)
    batches = data.lm_batches(genome, 2, 1024, np.random.default_rng(5))
    xs = [tuple(a.astype(np.int64) for a in next(batches)) for _ in range(steps)]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr, weight_decay=0.1))
    opt_state = tx.init(params)

    @jax.jit
    def jstep(params, opt_state, x, y):
        loss, grads = jax.value_and_grad(lambda p: jmetrics.cross_entropy(
            jm.apply({"params": p}, x, deterministic=True), y))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    jlosses = []
    for x, y in xs:
        params, opt_state, loss = jstep(params, opt_state, jnp.asarray(x), jnp.asarray(y))
        jlosses.append(float(loss))
    opt = train.dna_optimizer(tm)
    assert opt.defaults["lr"] == lr and opt.defaults["weight_decay"] == 0.1
    step = train.make_train_step(tm, opt, None, clip=1.0)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y))["loss"]) for x, y in xs]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    want = jax_weights.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=2 * lr * steps,
                                   err_msg=name)
    assert dna.train_config("large-1m") == {"remat": True} and dna.train_config("tiny-1k") == {}
