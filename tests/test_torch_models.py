"""Parity of the PyTorch port's Hyena stack with the flax modules.

The flax modules are initialised from a JAX key; their parameters go to the
port through ``utils.jax_weights``; inputs come from numpy with a seed. The
JAX side runs its Pallas kernels in interpret mode (impl='pallas'), the
port its plain versions on the CPU. Tolerances: f32 filter and operator
outputs at atol 1e-4 (measured gaps 2e-5 and ~1e-6: Sin(10 x) magnifies the
matmuls' summation order), f32 logits at 2e-3, bf16 operator outputs
at the repo's 1e-2 (the JAX kernels round every matmul operand to bf16, the
port's FFT stays f32; both round the activations the same way).

Grads: ``jax.grad`` of the flax model (its conv backward through
``_bwd_fused_io_tiles`` in interpret mode), mapped onto the port's names by
``jax_weights.from_jax_params``, against the port's ``.grad`` (its plain
backward), in f32 with dropout off on both sides. Each parameter's grad is
held to 1e-4 of its largest |value| (measured: below 1e-5 of it; the
filter MLP's Sin(w x) magnifies summation-order differences). The optimizer
chain is held to optax's: losses within 1e-4 relative at each of three
steps, parameters within 2 * lr * steps (a near-zero grad whose sign flips
moves an Adam weight by 2 lr).

The memory levers of the 1M-base HyenaDNA recipe (remat, scan_blocks,
inner_remat, mlp_l_chunks, conv_h_chunks, proj_l_chunks, proj_out_f32,
filter_output_dtype, mlp_dtype, the short filter's history): each is set on
the flax model and on the port alike, from the same weights, and loss and
grads are compared as above. The f32 levers are exact rearrangements, so
the 1e-4 bound of the lever-free model holds; the two bf16 dtype levers
round the filter to bf16 on both sides (8 bits of mantissa), and their
grads are held to 2e-2 of each parameter's largest |grad|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optax

from flashfftconv_tpu.models import filters as jfilters
from flashfftconv_tpu.models.hyena import HyenaOperator as JHyena
from flashfftconv_tpu.models.lm import ConvLMHeadModel as JLM
from flashfftconv_tpu.utils import metrics as jmetrics
from flashfftconv_tpu.utils import optim as joptim
from flashfftconv_tpu.utils import train as jtrain
from flashfftconv_tpu.utils.generation import generate as jgenerate
from flashfftconv_tpu_torch import FlashFFTConv
from flashfftconv_tpu_torch.models import filters as tfilters
from flashfftconv_tpu_torch.models.hyena import HyenaOperator, ShortDepthwiseConv
from flashfftconv_tpu_torch.models.lm import Block, ConvLMHeadModel, LMBackbone
from flashfftconv_tpu_torch.utils import data, jax_weights, metrics, optim, train
from flashfftconv_tpu_torch.utils.generation import generate, sample_logits

CPU = "cpu"
LM = dict(d_model=128, n_layer=2, d_inner=512, vocab_size=256, l_max=1024)


def _np(x):
    return np.array(x, np.float32)


def _init(model, *args):
    params = model.init(jax.random.PRNGKey(0), *args)["params"]
    return params, jax.tree_util.tree_map(np.asarray, params)


def test_positional_embedding_matches():
    z, t = tfilters.positional_embedding(7, 300, device=CPU)
    jz, jt = jfilters.positional_embedding(7, 300)
    np.testing.assert_array_equal(z.numpy(), _np(jz))
    np.testing.assert_array_equal(t.numpy(), _np(jt))
    with pytest.raises(ValueError):
        tfilters.positional_embedding(4, 8, device=CPU)


@pytest.mark.parametrize("kwargs", [
    {}, {"normalized": True, "w": 10.0, "emb_dim": 5}, {"linear_mixer": True},
    {"modulation_args": {"learn_modulation": True, "shift": 0.1}},
])
def test_hyena_filter_matches_flax(kwargs):
    jf = jfilters.HyenaFilter(d_model=32, seq_len=256, **kwargs)
    params, pnp = _init(jf, 200)
    ref = _np(jf.apply({"params": params}, 200))
    tf = tfilters.HyenaFilter(32, seq_len=256, **kwargs, device=CPU)
    tf.load_state_dict(jax_weights.hyena_filter_state_dict(pnp), strict=True)
    with torch.no_grad():
        got = tf(200).numpy()
    assert got.shape == (1, 200, 32)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def _operator_pair(dtype, length, order=2):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm = JHyena(d_model=128, l_max=1024, order=order, conv_dtype=jdt, impl="pallas")
    u = np.random.default_rng(length).standard_normal((2, length, 128)).astype(np.float32)
    ju = jnp.asarray(u, jdt)
    params, pnp = _init(jm, ju)
    ref = _np(jm.apply({"params": params}, ju).astype(jnp.float32))
    tm = HyenaOperator(128, 1024, order=order, conv_dtype=dtype, device=CPU)
    tm.load_state_dict(jax_weights.hyena_operator_state_dict(pnp), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(_np(ju.astype(jnp.float32))).to(dtype))
    assert got.dtype == dtype
    return got.float().numpy(), ref


@pytest.mark.parametrize("length", [1024, 640])
def test_hyena_operator_matches_flax_f32(length):
    got, ref = _operator_pair(torch.float32, length)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_hyena_operator_order3_matches_flax_f32():
    got, ref = _operator_pair(torch.float32, 512, order=3)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_hyena_operator_matches_flax_bf16():
    got, ref = _operator_pair(torch.bfloat16, 1024)
    np.testing.assert_allclose(got, ref, atol=1e-2)


def _lm_pair(dtype=torch.float32):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm = JLM(**LM, mixer_kwargs={"impl": "pallas", "conv_dtype": jdt}, dtype=jdt)
    ids = np.random.default_rng(0).integers(0, 256, (2, 1024))
    params, pnp = _init(jm, jnp.asarray(ids))
    tm = ConvLMHeadModel(**LM, mixer_kwargs={"conv_dtype": dtype}, dtype=dtype, device=CPU)
    tm.load_state_dict(jax_weights.from_jax_params(pnp), strict=True)
    return jm, params, tm.eval(), ids


def test_lm_logits_match_flax():
    jm, params, tm, ids = _lm_pair()
    ref = _np(jm.apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (2, 1024, 256)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-3)


def test_from_jax_params_covers_every_parameter():
    _, _, tm, _ = _lm_pair()
    jm = JLM(**LM, mixer_kwargs={"impl": "xla", "conv_dtype": jnp.float32}, dtype=jnp.float32)
    _, pnp = _init(jm, jnp.zeros((1, 64), jnp.int32))
    sd = jax_weights.from_jax_params(pnp)
    assert set(sd) == set(tm.state_dict())
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(pnp))
    assert n_jax == sum(p.numel() for p in tm.parameters())


def test_generate_matches_flax_greedy():
    """Temperature 0: the port's generate gives the JAX generate's tokens."""
    jm = JLM(**LM, mixer_kwargs={"impl": "xla", "conv_dtype": jnp.float32}, dtype=jnp.float32)
    ids = np.random.default_rng(1).integers(0, 256, (2, 300))
    params, pnp = _init(jm, jnp.asarray(ids))
    ref = np.asarray(jgenerate(jm.apply, params, jnp.asarray(ids), 4, 1024, temperature=0.0))
    tm = ConvLMHeadModel(**LM, mixer_kwargs={"conv_dtype": torch.float32},
                         dtype=torch.float32, device=CPU).eval()
    tm.load_state_dict(jax_weights.from_jax_params(pnp), strict=True)
    got = generate(tm, torch.from_numpy(ids), 4, 1024, temperature=0.0)
    assert got.shape == (2, 304)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_generate_serves_prompts_of_different_lengths():
    """One batch with per-row prompt lengths gives each row what it gets
    alone."""
    tm = ConvLMHeadModel(d_model=32, n_layer=1, d_inner=64, vocab_size=64, l_max=128,
                         dtype=torch.float32, device=CPU,
                         generator=torch.Generator().manual_seed(0)).eval()
    ids = torch.randint(0, 64, (3, 40), generator=torch.Generator().manual_seed(1))
    lengths = torch.tensor([40, 17, 5])
    got = generate(tm, ids, 3, 128, temperature=0.0, prompt_lengths=lengths)
    assert got.shape == (3, 43)
    for i, n in enumerate(lengths.tolist()):
        alone = generate(tm, ids[i : i + 1, :n], 3, 128, temperature=0.0)
        np.testing.assert_array_equal(got[i, : n + 3].numpy(), alone[0].numpy())
    with pytest.raises(ValueError):
        generate(tm, ids, 1, 128, prompt_lengths=torch.tensor([41, 1, 1]))


def test_sample_logits():
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.9], [5.0, -1.0, 0.0, 4.0]])
    assert sample_logits(logits, temperature=0.0).tolist() == [1, 0]
    assert sample_logits(logits, top_k=1).tolist() == [1, 0]
    assert sample_logits(logits, top_p=1e-6).tolist() == [1, 0]
    draws = [sample_logits(logits, temperature=1.0, top_k=2,
                           generator=torch.Generator().manual_seed(s)) for s in range(20)]
    assert all(set(d[0:1].tolist()) <= {1, 3} and set(d[1:].tolist()) <= {0, 3} for d in draws)
    again = [sample_logits(logits, generator=torch.Generator().manual_seed(s)) for s in range(5)]
    assert [a.tolist() for a in again] == [
        sample_logits(logits, generator=torch.Generator().manual_seed(s)).tolist()
        for s in range(5)
    ]


def test_same_seed_same_weights():
    make = lambda: ConvLMHeadModel(d_model=16, n_layer=1, d_inner=32, vocab_size=32,
                                   l_max=64, device=CPU,
                                   generator=torch.Generator().manual_seed(3))
    a, b = make().state_dict(), make().state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


_OP = dict(d_model=8, l_max=64, device=CPU)


_MOE = {"n_experts": 2}


@pytest.mark.parametrize("make", [
    lambda: Block(8, 16, mixer="h3", mixer_kwargs={"l_max": 64}, moe_kwargs=_MOE, device=CPU),
    lambda: Block(8, 16, mixer="m2", mixer_kwargs={"l_max": 64}, moe_kwargs=_MOE, device=CPU),
    lambda: Block(8, 16, mixer_kwargs={"l_max": 64}, moe_kwargs=_MOE, device=CPU),
    lambda: Block(8, 16, mixer_kwargs={"l_max": 64}, mlp_nblocks=2, moe_kwargs=_MOE,
                  device=CPU),
    lambda: ConvLMHeadModel(d_model=8, n_layer=1, d_inner=16, vocab_size=32, l_max=64,
                            mixer="long-conv", moe_kwargs=_MOE, device=CPU),
])
def test_unported_options_raise(make):
    """MoE is the one option of the JAX LM not ported: it raises with every
    mixer and MLP (the h3, m2 and long-conv mixers and block-diagonal MLPs
    are ported and tested in test_torch_h3.py and test_torch_longconv.py)."""
    with pytest.raises(NotImplementedError, match="moe_kwargs"):
        make()


# --- the memory levers of the 1M-base recipe -------------------------------

LEVER_LM = dict(d_model=32, n_layer=2, d_inner=64, vocab_size=64, l_max=256)
# (LM options, mixer options, grad tolerance); dtypes by name, one per side
LEVERS = {
    "remat": (dict(remat=True), {}, 1e-4),
    "scan_blocks": (dict(scan_blocks=True), {}, 1e-4),
    "remat_scan_blocks": (dict(remat=True, scan_blocks=True), {}, 1e-4),
    "inner_remat": (dict(inner_remat=True), {}, 1e-4),
    "remat_inner_remat": (dict(remat=True, inner_remat=True), {}, 1e-4),
    "mlp_l_chunks": (dict(mlp_l_chunks=4), {}, 1e-4),
    "conv_h_chunks": ({}, dict(conv_h_chunks=4), 1e-4),
    "proj_l_chunks": ({}, dict(proj_l_chunks=4), 1e-4),
    "proj_out_f32": ({}, dict(proj_l_chunks=8, proj_out_f32=True), 1e-4),
    "filter_output_dtype_f32": ({}, dict(filter_output_dtype="float32"), 1e-4),
    "filter_output_dtype_bf16": ({}, dict(filter_output_dtype="bfloat16"), 2e-2),
    "mlp_dtype_bf16": ({}, dict(filter_args={"mlp_dtype": "bfloat16"}), 2e-2),
    "every_lever": (dict(remat=True, scan_blocks=True, inner_remat=True, mlp_l_chunks=8),
                    dict(conv_h_chunks=2, proj_l_chunks=8, proj_out_f32=True,
                         filter_output_dtype="float32", filter_args={"mlp_dtype": "float32"}),
                    1e-4),
}


def _dtypes(tree, ns):
    """tree with every dtype name replaced by ns's dtype of that name."""
    if isinstance(tree, dict):
        return {k: _dtypes(v, ns) for k, v in tree.items()}
    return getattr(ns, tree) if tree in ("float32", "bfloat16") else tree


@pytest.mark.parametrize("name", list(LEVERS))
def test_ported_option_matches_flax(name):
    """One memory lever (or all of them) on the flax LM and on the port, f32
    activations, the same weights and batch: the loss and every parameter's
    grad. scan_blocks gives the flax model a stacked parameter tree, which
    from_jax_params unstacks."""
    lm_kw, mixer_kw, tol = LEVERS[name]
    jm = JLM(**LEVER_LM, **lm_kw, dtype=jnp.float32,
             mixer_kwargs={"impl": "xla", "conv_dtype": jnp.float32, **_dtypes(mixer_kw, jnp)})
    xy = np.random.default_rng(11).integers(0, 64, (2, 257))
    x, y = xy[:, :-1], xy[:, 1:]
    params, pnp = _init(jm, jnp.asarray(x))
    assert ("blocks" in pnp["backbone"]) == bool(lm_kw.get("scan_blocks"))
    loss, grads = jax.value_and_grad(lambda p: jmetrics.cross_entropy(
        jm.apply({"params": p}, jnp.asarray(x), deterministic=True), jnp.asarray(y)))(params)
    tm = ConvLMHeadModel(**LEVER_LM, **lm_kw, dtype=torch.float32, device=CPU,
                         mixer_kwargs={"conv_dtype": torch.float32, **_dtypes(mixer_kw, torch)})
    tm.load_state_dict(jax_weights.from_jax_params(pnp), strict=True)
    got = metrics.cross_entropy(tm.eval()(torch.from_numpy(x)), torch.from_numpy(y))
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= max(tol, 1e-5) * float(loss)
    _assert_grads_match(jax_weights.from_jax_params(jax.tree_util.tree_map(np.asarray, grads)),
                        tm, tol=tol)


def test_levers_need_divisible_sizes_as_in_flax():
    """conv_h_chunks that does not divide d_model and proj_l_chunks that
    does not divide L are ignored, as in the flax module; a chunked MLP
    refuses rows it cannot split."""
    g = lambda: torch.Generator().manual_seed(0)
    u = torch.randn(2, 50, 8, generator=g())
    op = dict(_OP, l_max=128, conv_dtype=torch.float32)
    ref = HyenaOperator(**op, generator=g())(u)
    odd = HyenaOperator(**op, conv_h_chunks=3, proj_l_chunks=4, generator=g())(u)
    assert torch.equal(ref, odd)
    block = Block(8, 16, mixer_kwargs={"l_max": 128}, mlp_l_chunks=7, device=CPU)
    with pytest.raises(ValueError, match="l_chunks"):
        block(u)


@pytest.mark.parametrize("k", [3, 5])
def test_short_filter_history_matches_flax(k):
    """ShortDepthwiseConv(history=...): the output and the grads of x, the
    history and the weights against the flax module; and two chunks with the
    carry equal the unchunked causal conv."""
    from flashfftconv_tpu.models.hyena import ShortDepthwiseConv as JShort

    rng = np.random.default_rng(k)
    x, dout = (rng.standard_normal((2, 6, 40)).astype(np.float32) for _ in "ab")
    hist = rng.standard_normal((2, 6, k - 1)).astype(np.float32)
    jm = JShort(6, k, impl="xla")
    params, pnp = _init(jm, jnp.asarray(x), jnp.asarray(hist))
    f = lambda p, a, h: jnp.sum(jm.apply({"params": p}, a, h) * dout)
    ref = _np(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(hist)))
    gp, gx, gh = jax.grad(f, argnums=(0, 1, 2))(params, jnp.asarray(x), jnp.asarray(hist))
    tm = ShortDepthwiseConv(6, k, padding=(k - 1, 0), device=CPU)
    tm.load_state_dict({n: torch.from_numpy(np.array(pnp[n])) for n in ("weights", "bias")})
    tx, th = (torch.from_numpy(a).requires_grad_() for a in (x, hist))
    got = tm(tx, history=th)
    (got * torch.from_numpy(dout)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5)
    for a, r in ((tx.grad, gx), (th.grad, gh), (tm.weights.grad, gp["weights"]),
                 (tm.bias.grad, gp["bias"])):
        np.testing.assert_allclose(a.numpy(), _np(r), atol=1e-4 * max(1.0, float(np.abs(r).max())))
    with torch.no_grad():
        whole = tm(torch.from_numpy(x))[..., :40]
        first = tm(torch.from_numpy(x[..., :24]), history=torch.zeros(2, 6, k - 1))
        second = tm(torch.from_numpy(x[..., 24:]),
                    history=torch.from_numpy(x[..., 24 - (k - 1):24]))
    np.testing.assert_allclose(torch.cat((first, second), -1).numpy(), whole.numpy(), atol=1e-6)


# --- grads, optimizer and train step ---------------------------------------

def _tree_paths(tree, prefix=()):
    """{flax path: leaf} of a nested dict."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_tree_paths(v, prefix + (k,)))
    return out


def _assert_grads_match(jax_grads: dict, model, tol=1e-4):
    assert set(jax_grads) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        ref = jax_grads[name].numpy()
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= tol * float(np.abs(ref).max()) + 1e-7, (name, err, float(np.abs(ref).max()))


def test_hyena_operator_grads_match_flax():
    """Every parameter's grad and the input's grad of the f32 operator."""
    jm = JHyena(d_model=128, l_max=1024, conv_dtype=jnp.float32, impl="pallas")
    rng = np.random.default_rng(2)
    u = rng.standard_normal((2, 1024, 128)).astype(np.float32)
    dout = rng.standard_normal((2, 1024, 128)).astype(np.float32)
    params, pnp = _init(jm, jnp.asarray(u))
    gp, gu = jax.grad(lambda p, x: jnp.sum(jm.apply({"params": p}, x, deterministic=True) * dout),
                      argnums=(0, 1))(params, jnp.asarray(u))
    tm = HyenaOperator(128, 1024, conv_dtype=torch.float32, device=CPU)
    tm.load_state_dict(jax_weights.hyena_operator_state_dict(pnp), strict=True)
    tu = torch.from_numpy(u).requires_grad_()
    (tm(tu) * torch.from_numpy(dout)).sum().backward()
    gp = jax.tree_util.tree_map(np.asarray, gp)
    _assert_grads_match(jax_weights.hyena_operator_state_dict(gp), tm)
    np.testing.assert_allclose(tu.grad.numpy(), _np(gu), atol=1e-4 * float(np.abs(_np(gu)).max()))


def test_lm_grads_match_flax():
    """jax.grad of metrics.cross_entropy over the 2-layer f32 LM, mapped by
    from_jax_params (transposes included), against the port's .grad."""
    jm, params, tm, ids = _lm_pair()
    targets = np.roll(ids, -1, axis=1)
    loss, grads = jax.value_and_grad(lambda p: jmetrics.cross_entropy(
        jm.apply({"params": p}, jnp.asarray(ids), deterministic=True),
        jnp.asarray(targets)))(params)
    got = metrics.cross_entropy(tm(torch.from_numpy(ids)), torch.from_numpy(targets))
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= 1e-5 * float(loss)
    _assert_grads_match(jax_weights.from_jax_params(jax.tree_util.tree_map(np.asarray, grads)), tm)


def test_flax_paths_invert_the_key_map():
    """flax_paths(model)[name] leads, in the flax tree, to the leaf that
    from_jax_params puts under name (transposed for Dense kernels)."""
    jm = JLM(**LM, mixer_kwargs={"impl": "xla", "conv_dtype": jnp.float32}, dtype=jnp.float32)
    _, pnp = _init(jm, jnp.zeros((1, 64), jnp.int32))
    leaves = _tree_paths(pnp)
    tm = ConvLMHeadModel(**LM, mixer_kwargs={"conv_dtype": torch.float32},
                         dtype=torch.float32, device=CPU)
    sd = jax_weights.from_jax_params(pnp)
    paths = jax_weights.flax_paths(tm)
    assert set(paths) == set(sd) and sorted(paths.values()) == sorted(leaves)
    for name, path in paths.items():
        leaf = np.asarray(leaves[path], np.float32)
        want = sd[name].numpy()
        np.testing.assert_array_equal(leaf.T if path[-1] == "kernel" else leaf, want)
    filt = tfilters.HyenaFilter(8, seq_len=32, linear_mixer=True, device=CPU)
    assert jax_weights.flax_paths(filt)["layers.0.weight"] == ("mixer", "kernel")


def test_optimizer_groups_match_kernel_label_fn():
    """The special (no weight decay) group holds exactly the parameters the
    JAX labels mark: every Dense kernel, and no LayerNorm scale although
    both are ``.weight`` in the port."""
    jm = JLM(**LM, mixer_kwargs={"impl": "xla", "conv_dtype": jnp.float32}, dtype=jnp.float32)
    _, pnp = _init(jm, jnp.zeros((1, 64), jnp.int32))
    jlabels = _tree_paths(joptim.label_params(pnp, joptim.kernel_label_fn))
    tm = ConvLMHeadModel(**LM, device=CPU)
    paths = jax_weights.flax_paths(tm)
    labels = optim.label_params(tm)
    assert {paths[n]: lab for n, lab in labels.items()} == jlabels
    assert labels["backbone.blocks.0.norm1.weight"] == "default"
    assert labels["backbone.blocks.0.mlp.fc1.weight"] == "special"
    opt, _ = optim.make_optimizer(tm, lr=2e-3, weight_decay=0.05, special_lr=1e-3)
    named = {id(p): n for n, p in tm.named_parameters()}
    special = {named[id(p)] for p in opt.param_groups[1]["params"]}
    assert special == {n for n, lab in labels.items() if lab == "special"}
    assert [g["weight_decay"] for g in opt.param_groups] == [0.05, 0.0]


@pytest.mark.parametrize("init,peak,warmup,decay,end", [
    (0.0, 3e-4, 2, 7, 0.0), (0.0, 1e-3, 20, 200, 1e-5), (1e-4, 5e-3, 1, 2, 0.0),
])
def test_schedule_matches_optax(init, peak, warmup, decay, end):
    """Step by step, within optax's own f32 rounding (rel 1e-5); 0 exactly at
    step 0 when init is 0."""
    ref = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    mine = optim.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    for step in range(decay + 3):
        assert mine(step) == pytest.approx(float(ref(step)), rel=1e-5, abs=1e-12)
    if init == 0.0:
        assert mine(0) == 0.0
    lin = optax.linear_schedule(init, peak, warmup)
    assert [optim.linear_schedule(init, peak, warmup)(s) for s in range(warmup + 2)] == \
        pytest.approx([float(lin(s)) for s in range(warmup + 2)], rel=1e-5, abs=1e-12)


def test_lm_optimizer_first_update_runs_at_lr_zero():
    """optax counts updates from 0: the LambdaLR gives the first update lr =
    schedule(0) = 0 and then follows the schedule step by step."""
    tm = ConvLMHeadModel(d_model=16, n_layer=1, d_inner=32, vocab_size=32, l_max=64, device=CPU)
    opt, sched = train.lm_optimizer(tm, lr=3e-4, weight_decay=0.1, warmup=2, steps=7)
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 2, 7)
    before = [p.detach().clone() for p in tm.parameters()]
    for step in range(7):
        assert opt.param_groups[0]["lr"] == pytest.approx(float(ref(step)), rel=1e-5, abs=1e-12)
        for p in tm.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
        sched.step()
        if step == 0:
            assert all(torch.equal(a, p) for a, p in zip(before, tm.parameters()))


def test_train_steps_match_optax_chain():
    """Three steps of the examples/lm optax chain (clip_by_global_norm, then
    adamw over warmup_cosine_decay_schedule) against three steps of the
    port's recipe, from the same weights and batch, dropout off."""
    cfg = dict(d_model=32, n_layer=2, d_inner=128, vocab_size=256, l_max=128)
    lr, wd, warmup, steps = 1e-3, 0.1, 1, 3
    jm = JLM(**cfg, mixer_kwargs={"impl": "xla", "conv_dtype": jnp.float32}, dtype=jnp.float32)
    xy = np.random.default_rng(5).integers(0, 256, (2, 129))
    x, y = xy[:, :-1], xy[:, 1:]
    params, pnp = _init(jm, jnp.asarray(x))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1)),
        weight_decay=wd))
    opt_state = tx.init(params)

    @jax.jit
    def jstep(params, opt_state):
        loss, grads = jax.value_and_grad(lambda p: jmetrics.cross_entropy(
            jm.apply({"params": p}, jnp.asarray(x), deterministic=True), jnp.asarray(y)))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    jlosses = []
    for _ in range(steps):
        params, opt_state, loss = jstep(params, opt_state)
        jlosses.append(float(loss))
    tm = ConvLMHeadModel(**cfg, mixer_kwargs={"conv_dtype": torch.float32},
                         dtype=torch.float32, device=CPU).eval()
    tm.load_state_dict(jax_weights.from_jax_params(pnp), strict=True)
    opt, sched = train.lm_optimizer(tm, lr=lr, weight_decay=wd, warmup=warmup, steps=steps)
    step = train.make_train_step(tm, opt, sched, clip=1.0)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y))["loss"]) for _ in range(steps)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    want = jax_weights.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=2 * lr * steps,
                                   err_msg=name)


def test_cross_entropy_and_metrics_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 9, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (2, 9))
    masked = targets.copy()
    masked[0, :4] = 3  # JAX gathers the ignored targets too, so they must be valid ids
    for t, ignore in ((targets, None), (masked, 3)):
        jl, jt = jnp.asarray(logits), jnp.asarray(t)
        ref, ref_grad = jax.value_and_grad(jmetrics.cross_entropy)(jl, jt, ignore)
        tl = torch.from_numpy(logits).requires_grad_()
        got = metrics.cross_entropy(tl, torch.from_numpy(t), ignore)
        got.backward()
        assert float(got.detach()) == pytest.approx(float(ref), rel=1e-6)
        np.testing.assert_allclose(tl.grad.numpy(), _np(ref_grad), atol=1e-7)
        tt, tl = torch.from_numpy(t), tl.detach()
        assert float(metrics.perplexity(tl, tt, ignore)) == pytest.approx(
            float(jmetrics.perplexity(jl, jt, ignore)), rel=1e-6)
        assert float(metrics.accuracy(tl, tt, ignore)) == pytest.approx(
            float(jmetrics.accuracy(jl, jt, ignore)), rel=1e-6)
        assert int(metrics.num_tokens(tt, ignore)) == int(jmetrics.num_tokens(jt, ignore))
    t100 = torch.from_numpy(targets).masked_fill(torch.from_numpy(masked == 3), -100)
    tl = torch.from_numpy(logits).requires_grad_()
    metrics.cross_entropy(tl, t100, -100).backward()
    tr = torch.from_numpy(logits).requires_grad_()
    torch.nn.functional.cross_entropy(tr.reshape(-1, 11), t100.reshape(-1), ignore_index=-100
                                      ).backward()
    np.testing.assert_allclose(tl.grad.numpy(), tr.grad.numpy(), atol=1e-7)
    bf = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_()
    metrics.cross_entropy(bf, torch.from_numpy(targets)).backward()
    assert bf.grad.dtype == torch.bfloat16
    assert float(metrics.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets))) == \
        pytest.approx(float(torch.nn.functional.cross_entropy(
            torch.from_numpy(logits).reshape(-1, 11), torch.from_numpy(targets).reshape(-1))),
            rel=1e-6)


def test_norms_counts_and_ema_match_jax():
    tm = ConvLMHeadModel(d_model=16, n_layer=1, d_inner=32, vocab_size=32, l_max=64, device=CPU,
                         generator=torch.Generator().manual_seed(0))
    for p in tm.parameters():
        p.grad = torch.full_like(p, 0.5)
    tree = {n: jnp.asarray(np.array(p.detach())) for n, p in tm.named_parameters()}
    norms = metrics.param_and_grad_norms(tm)
    assert float(norms["param_norm"]) == pytest.approx(float(jmetrics.global_norm(tree)), rel=1e-5)
    assert float(norms["grad_norm"]) == pytest.approx(0.5 * sum(p.numel() for p in tm.parameters())
                                                      ** 0.5, rel=1e-5)
    counts = metrics.param_counts(tm)
    assert counts["total"] == sum(counts[k] for k in ("embeddings", "backbone"))
    ema = optim.ema_init(tm)
    jema = joptim.ema_init(tree)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(1.0)
    optim.ema_update(ema, tm, decay=0.9)
    jema = joptim.ema_update(jema, {n: v + 1.0 for n, v in tree.items()}, decay=0.9)
    for n in ema:
        np.testing.assert_allclose(ema[n].numpy(), _np(jema[n]), rtol=1e-6, atol=1e-7)
    swapped = optim.ema_swap(ema, tm)
    assert tm.load_state_dict(swapped, strict=False).unexpected_keys == []
    monitor = metrics.SpeedMonitor()
    assert monitor.step(10) == {} and set(monitor.step(10)) == {"step_time_ms", "items_per_sec"}


def test_eval_step_matches_jax_make_eval_step():
    """A classification head (x @ W^T): loss, correct and total with a
    masked padding row, dropout state restored afterwards."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((5, 8)).astype(np.float32)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    y = rng.integers(0, 5, 6)
    mask = np.array([1, 1, 1, 1, 1, 0], np.float32)
    jstep = jtrain.make_eval_step(lambda v, xx, deterministic: xx @ v["params"]["w"].T)
    ref = jstep({"w": jnp.asarray(w)}, (jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)))
    lin = torch.nn.Linear(8, 5, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
    lin.train()
    got = train.make_eval_step(lin)((torch.from_numpy(x), torch.from_numpy(y),
                                     torch.from_numpy(mask)))
    assert lin.training
    for key in ("loss", "correct", "total"):
        assert float(got[key]) == pytest.approx(float(ref[key]), rel=1e-6), key


@pytest.mark.parametrize("remat", [True, False])
def test_flash_fft_conv_remat_grads(remat):
    """remat is accepted with the JAX module's default (True); both values
    give the JAX module's grads and save only the Function's inputs."""
    import inspect

    from flashfftconv_tpu import FlashFFTConv as JFlashFFTConv

    assert inspect.signature(FlashFFTConv).parameters["remat"].default is True
    rng = np.random.default_rng(8)
    u, k, pre, post = (rng.standard_normal(s).astype(np.float32)
                       for s in ((2, 4, 200), (4, 150), (2, 4, 200), (2, 4, 200)))
    dout = rng.standard_normal((2, 4, 200)).astype(np.float32)
    jconv = JFlashFFTConv(512, dtype=jnp.float32, remat=remat)
    ref = jax.grad(lambda *a: jnp.sum(jconv(*a) * dout), argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (u, k, pre, post)))
    conv = FlashFFTConv(512, dtype=torch.float32, device=CPU, remat=remat)
    ts = [torch.from_numpy(a).requires_grad_() for a in (u, k, pre, post)]
    y = conv(*ts)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 4 and all(a is b for a, b in zip(saved, ts))
    got = torch.autograd.grad(y, ts, torch.from_numpy(dout))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), _np(r), atol=1e-4 * max(1.0, float(np.abs(r).max())))


def test_lm_train_mode_takes_steps_on_cpu():
    """train() mode (embed dropout 0.1, resid dropout) runs forward and
    backward through the Functions, in bf16 activations with f32 weights,
    and the loss falls over a few steps on one batch."""
    torch.manual_seed(0)
    tm = ConvLMHeadModel(d_model=32, n_layer=2, d_inner=64, vocab_size=64, l_max=128,
                         resid_dropout=0.1, dtype=torch.bfloat16, device=CPU,
                         generator=torch.Generator().manual_seed(1)).train()
    opt, sched = train.lm_optimizer(tm, lr=3e-3, weight_decay=0.1, warmup=1, steps=6)
    step = train.make_train_step(tm, opt, sched)
    xy = torch.randint(0, 64, (2, 129), generator=torch.Generator().manual_seed(2))
    out = [step(xy[:, :-1], xy[:, 1:]) for _ in range(6)]
    losses = [float(o["loss"]) for o in out]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in tm.parameters())


# --- HyenaDNA: the long path, the checkpoint import and scoring ---------------

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


# --- HyenaDNA training: grads under remat, the optax chain, the batches ------

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


@pytest.mark.parametrize("batch,seq_len", [(1, 1000), (3, 64)])
def test_lm_batches_match_jax(batch, seq_len):
    """The same generator gives the JAX function's windows, batch after
    batch, targets one position after inputs."""
    from flashfftconv_tpu.utils.data import lm_batches as jlm_batches

    tokens = np.random.default_rng(0).integers(0, 5, 5000).astype(np.int32)
    mine = data.lm_batches(tokens, batch, seq_len, np.random.default_rng(7))
    ref = jlm_batches(tokens, batch, seq_len, np.random.default_rng(7))
    for _ in range(3):
        (x, y), (rx, ry) = next(mine), next(ref)
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)
        assert x.shape == (batch, seq_len) and np.array_equal(x[:, 1:], y[:, :-1])

