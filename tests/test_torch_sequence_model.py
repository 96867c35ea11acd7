"""The Long Conv sequence model, its layers and encoder on the port against the
flax modules. Helpers and tolerances are those of
``test_torch_longconv.py``, whose docstring states them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flashfftconv_tpu.models import long_conv as jlc
from flashfftconv_tpu.models import sequence as jseq
from flashfftconv_tpu.models.lm import ConvLMHeadModel as JLM
from flashfftconv_tpu.utils import metrics as jmetrics
from flashfftconv_tpu.utils import optim as joptim
from flashfftconv_tpu_torch.models import long_conv, sequence
from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel
from flashfftconv_tpu_torch.utils import jax_weights, metrics, optim
import copy
from test_torch_longconv import CPU, _close, _np, _tree

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)


def _assert_grads_match(jax_grads: dict, model, tol=1e-4):
    assert set(jax_grads) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        ref = jax_grads[name].numpy()
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        err = float(np.abs(got - ref).max())
        assert err <= tol * float(np.abs(ref).max()) + 1e-7, (name, err, float(np.abs(ref).max()))


def _listops_inputs(b, length, seed):
    """Right-padded token ids in 1..15 (PAD 0) with lengths drawn in
    [length / 4, length], one-hot over 16 tokens, and the valid mask."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 16, (b, length))
    lens = rng.integers(length // 4, length + 1, b)
    ids[np.arange(length)[None, :] >= lens[:, None]] = 0
    return np.eye(16, dtype=np.float32)[ids], ids != 0, rng.integers(0, 10, b)


ENCODERS = {
    "linear": (dict(), lambda r: r.standard_normal((2, 12, 5)).astype(np.float32)),
    "embedding": (dict(n_tokens=17), lambda r: r.integers(0, 17, (2, 12))),
    "one-hot": (dict(n_tokens=17), lambda r: r.integers(0, 17, (2, 12))),
    "position": (dict(), lambda r: r.standard_normal((2, 12, 32)).astype(np.float32)),
    "patch2d": (dict(patch_size=4), lambda r: r.standard_normal((2, 16, 8, 3)).astype(np.float32)),
}


SEQUENCE_MODELS = {
    # test_sequence_model_classification_end_to_end
    "classification": (
        dict(d_model=32, n_layers=2, layer={"mixer": "hyena", "l_max": 16, "filter_order": 16},
             encoder="embedding", n_tokens=32,
             decoder={"_name_": "sequence", "mode": "mean", "d_output": 5}, l_max=16),
        lambda r: r.integers(0, 32, (2, 16))),
    # test_sequence_model_staged_pooling
    "staged_pooling": (
        dict(d_model=16, n_layers=2, n_stages=2, pool={"_name_": "avg", "stride": 2},
             layer={"mixer": "hyena", "l_max": 16}, encoder="linear",
             decoder={"_name_": "sequence", "mode": "mean", "d_output": 3}, l_max=16),
        lambda r: r.standard_normal((2, 16, 4)).astype(np.float32)),
    # test_sequence_model_via_registry's configuration
    "registry_mha": (
        dict(d_model=16, n_layers=1, layer={"mixer": "mha", "num_heads": 2},
             encoder="embedding", n_tokens=16,
             decoder={"_name_": "sequence", "mode": "last", "d_output": 4}),
        lambda r: r.integers(0, 16, (2, 8))),
    # test_sequence_model_long_conv_mixer
    "long_conv": (
        dict(d_model=16, n_layers=1, layer={"mixer": "long-conv",
                                            "mixer_kwargs": {"l_max": 16, "lam": 0.0}},
             encoder="linear", decoder={"_name_": "sequence", "mode": "mean", "d_output": 3}),
        lambda r: r.standard_normal((2, 16, 4)).astype(np.float32)),
    # three stages, a learned pool that widens, encoder list, h3 mixer
    "linear_pool_h3": (
        dict(d_model=8, n_layers=3, n_stages=3, pool={"_name_": "linear", "stride": 2,
                                                      "expand": 2},
             layer={"mixer": "h3", "kernel_lam": 0.001}, encoder=["linear", "position"],
             decoder={"_name_": "sequence", "mode": "pool", "d_output": 2}, l_max=32),
        lambda r: r.standard_normal((2, 32, 4)).astype(np.float32)),
}


def _mixer_f32(cfg, **extra):
    """A copy of cfg whose long-conv mixer computes its FFT conv in f32
    (``extra`` gives conv_dtype and, for JAX, impl)."""
    cfg = copy.deepcopy(cfg)
    layer = cfg["layer"]
    if layer.get("mixer") != "mha":
        layer.get("mixer_kwargs", layer).update(extra)
    return cfg


@pytest.mark.parametrize("channels,impl", [(1, "pallas"), (2, "xla")])
def test_long_conv_layer_matches_flax(channels, impl):
    """Outputs and grads of the f32 layer (d 32, l_max 128, FFT size 256,
    k_len 256, L = 100), dropout off on both sides."""
    jm = jlc.LongConv(h=32, l_max=128, channels=channels, kernel_lam=0.001,
                      conv_dtype=jnp.float32, impl=impl)
    rng = np.random.default_rng(channels)
    u = rng.standard_normal((2, 32, 100)).astype(np.float32)
    dout = rng.standard_normal((2, 32, 100)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(u))["params"]
    ref = jm.apply({"params": params}, jnp.asarray(u))
    gp, gu = jax.jit(jax.grad(lambda p, x: jnp.sum(jm.apply({"params": p}, x) * dout),
                              argnums=(0, 1)))(params, jnp.asarray(u))
    tm = long_conv.LongConv(32, 128, channels=channels, kernel_lam=0.001,
                            conv_dtype=torch.float32, device=CPU).eval()
    tm.load_state_dict(jax_weights.long_conv_state_dict(_tree(params)), strict=True)
    assert tm.kernel.shape[-1] == 256  # k_len = N
    tu = torch.from_numpy(u).requires_grad_()
    got = tm(tu)
    (got * torch.from_numpy(dout)).sum().backward()
    _close(got.detach(), ref, 1e-4)
    _assert_grads_match(jax_weights.long_conv_state_dict(_tree(gp)), tm)
    _close(tu.grad, gu, 1e-4)


@pytest.mark.parametrize("masked,prenorm", [(True, False), (False, False), (True, True)])
def test_long_conv_model_matches_flax(masked, prenorm):
    """The LRA ListOps model at 2 layers, d_model 32, l_max 128, f32: logits
    and every parameter's grad of the cross-entropy, masked-mean pool or
    plain mean, post- or pre-norm."""
    kw = dict(d_output=10, d_model=32, n_layers=2, l_max=128, kernel_lam=0.001,
              prenorm=prenorm)
    jm = jlc.LongConvModel(d_input=16, **kw, conv_dtype=jnp.float32, impl="xla")
    x, mask, y = _listops_inputs(3, 128, 7)
    m = mask if masked else None
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    loss_fn = lambda p: jmetrics.cross_entropy(
        jm.apply({"params": p}, jnp.asarray(x), mask=None if m is None else jnp.asarray(m)),
        jnp.asarray(y))
    ref = jm.apply({"params": params}, jnp.asarray(x),
                   mask=None if m is None else jnp.asarray(m))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tm = long_conv.LongConvModel(16, **kw, conv_dtype=torch.float32, device=CPU).eval()
    tm.load_state_dict(jax_weights.long_conv_model_state_dict(_tree(params)), strict=True)
    got = tm(torch.from_numpy(x), mask=None if m is None else torch.from_numpy(m))
    assert got.shape == (3, 10) and got.dtype == torch.float32
    _close(got.detach(), ref, 1e-4)
    tl = metrics.cross_entropy(got, torch.from_numpy(y))
    tl.backward()
    assert abs(float(tl.detach()) - float(loss)) <= 1e-5 * float(loss)
    _assert_grads_match(jax_weights.long_conv_model_state_dict(_tree(grads)), tm)


def test_long_conv_model_with_a_bf16_plan_matches_flax():
    """The ListOps example's conv_dtype (bfloat16) under f32 activations."""
    kw = dict(d_output=10, d_model=32, n_layers=2, l_max=128, kernel_lam=0.001)
    jm = jlc.LongConvModel(d_input=16, **kw, impl="xla")
    x, mask, _ = _listops_inputs(2, 128, 8)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = jm.apply({"params": params}, jnp.asarray(x), mask=jnp.asarray(mask))
    tm = long_conv.LongConvModel(16, **kw, device=CPU).eval()
    tm.load_state_dict(jax_weights.long_conv_model_state_dict(_tree(params)), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), mask=torch.from_numpy(mask))
    _close(got, ref, 1e-2)


def test_long_conv_model_optimizer_groups_match_the_jax_labels():
    """make_optimizer's no-decay group holds exactly the parameters that the
    JAX package's kernel_label_fn marks on the flax LongConvModel (every
    leaf named kernel: the conv kernels and the Dense kernels)."""
    jm = jlc.LongConvModel(d_input=16, d_model=32, n_layers=2, l_max=64, impl="xla")
    params = _tree(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 16)))["params"])
    jlabels = {}

    def walk(tree, path):
        for k, v in tree.items():
            walk(v, path + (k,)) if isinstance(v, dict) else jlabels.__setitem__(path + (k,), v)

    walk(joptim.label_params(params, joptim.kernel_label_fn), ())
    tm = long_conv.LongConvModel(16, d_model=32, n_layers=2, l_max=64, device=CPU)
    paths = jax_weights.flax_paths(tm)
    labels = optim.label_params(tm)
    assert {paths[n]: lab for n, lab in labels.items()} == jlabels
    assert labels["layer.0.kernel"] == "special" and labels["layer.0.D"] == "default"
    assert set(jax_weights.long_conv_model_state_dict(params)) == set(tm.state_dict())


def test_long_conv_operator_and_lm_match_flax():
    """LongConvOperator alone (outputs and grads) and a 2-layer f32 LM with
    the long-conv mixer (logits, loss, every parameter's grad)."""
    jop = jlc.LongConvOperator(d_model=32, l_max=128, conv_dtype=jnp.float32, impl="pallas")
    u = np.random.default_rng(9).standard_normal((2, 128, 32)).astype(np.float32)
    params = jop.init(jax.random.PRNGKey(0), jnp.asarray(u))["params"]
    gp = jax.jit(jax.grad(lambda p: jnp.sum(jop.apply({"params": p}, jnp.asarray(u)) ** 2)))(
        params)
    top = long_conv.LongConvOperator(32, 128, conv_dtype=torch.float32, device=CPU)
    top.load_state_dict(jax_weights.long_conv_operator_state_dict(_tree(params)), strict=True)
    got = top(torch.from_numpy(u))
    (got ** 2).sum().backward()
    _close(got.detach(), jop.apply({"params": params}, jnp.asarray(u)), 1e-4)
    _assert_grads_match(jax_weights.long_conv_operator_state_dict(_tree(gp)), top)

    cfg = dict(d_model=32, n_layer=2, d_inner=64, vocab_size=64, l_max=128, mixer="long-conv")
    jm = JLM(**cfg, mixer_kwargs={"conv_dtype": jnp.float32, "impl": "xla"}, dtype=jnp.float32)
    xy = np.random.default_rng(10).integers(0, 64, (2, 129))
    x, y = xy[:, :-1], xy[:, 1:]
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmetrics.cross_entropy(
        jm.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y))))(params)
    tm = ConvLMHeadModel(**cfg, mixer_kwargs={"conv_dtype": torch.float32},
                         dtype=torch.float32, device=CPU).eval()
    tm.load_state_dict(jax_weights.from_jax_params(_tree(params)), strict=True)
    logits = tm(torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(),
                               _np(jm.apply({"params": params}, jnp.asarray(x))), atol=2e-3)
    tl = metrics.cross_entropy(logits, torch.from_numpy(y))
    tl.backward()
    assert abs(float(tl.detach()) - float(loss)) <= 1e-5 * float(loss)
    _assert_grads_match(jax_weights.from_jax_params(_tree(grads)), tm)


@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_matches_flax(name):
    kw, make = ENCODERS[name]
    x = make(np.random.default_rng(11))
    jm = jseq._ENCODERS[name](d_model=32, **kw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = jm.apply(variables, jnp.asarray(x))
    tkw = dict(kw)
    if name in ("linear", "patch2d"):
        tkw["d_input"] = x.shape[-1]
    if name in ("linear", "embedding", "patch2d"):
        tkw["device"] = CPU
    tm = sequence.ENCODERS[name](d_model=32, **tkw)
    if "params" in variables:
        tree = {"ln_f": {"scale": np.ones(32), "bias": np.zeros(32)},
                "encoder_0": _tree(variables["params"])}
        state = jax_weights.sequence_model_state_dict(tree)
        tm.load_state_dict({k.split(".", 2)[2]: v for k, v in state.items()
                            if k.startswith("encoder.")}, strict=True)
    got = tm(torch.from_numpy(x))
    assert got.shape == ref.shape
    _close(got.detach(), ref, 1e-5)


def test_retrieval_decoder_matches_flax():
    x = np.random.default_rng(14).standard_normal((4, 9, 8)).astype(np.float32)
    lengths = np.array([9, 3, 5, 7])
    jm = jseq.RetrievalDecoder(n_classes=3, d_model=16)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), lengths=jnp.asarray(lengths))
    ref = jm.apply(variables, jnp.asarray(x), lengths=jnp.asarray(lengths))
    tm = sequence.RetrievalDecoder(8, n_classes=3, d_model=16, device=CPU)
    p = _tree(variables["params"])
    tm.load_state_dict({**jax_weights._dense(p["fc1"], "fc1"),
                        **jax_weights._dense(p["fc2"], "fc2")}, strict=True)
    got = tm(torch.from_numpy(x), lengths=torch.from_numpy(lengths))
    _close(got.detach(), ref, 1e-5)


@pytest.mark.parametrize("name", list(SEQUENCE_MODELS))
def test_sequence_model_matches_flax(name):
    """Outputs and every parameter's grad of sum(out^2) against the flax
    SequenceModel of the same configuration."""
    cfg, make = SEQUENCE_MODELS[name]
    x = make(np.random.default_rng(15))
    jm = jseq.SequenceModel(**_mixer_f32(cfg, conv_dtype=jnp.float32, impl="xla"))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = jm.apply({"params": params}, jnp.asarray(x))
    gp = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) ** 2)))(
        params)
    d_input = x.shape[-1] if x.dtype == np.float32 else None
    tm = sequence.SequenceModel(**_mixer_f32(cfg, conv_dtype=torch.float32), d_input=d_input,
                                device=CPU).eval()
    tm.load_state_dict(jax_weights.sequence_model_state_dict(_tree(params)), strict=True)
    got = tm(torch.from_numpy(x))
    (got ** 2).sum().backward()
    assert got.shape == ref.shape
    _close(got.detach(), ref, 1e-4)
    _assert_grads_match(jax_weights.sequence_model_state_dict(_tree(gp)), tm)
