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

Split by topic so that the test workers share them: the memory levers are
in ``test_torch_levers.py``, HyenaDNA in ``test_torch_dna.py``, and the
optimizer, the schedule and the train and eval steps in
``test_torch_train.py``; they take their helpers from here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashfftconv_tpu.models import filters as jfilters
from flashfftconv_tpu.models.hyena import HyenaOperator as JHyena
from flashfftconv_tpu.models.lm import ConvLMHeadModel as JLM
from flashfftconv_tpu.utils import metrics as jmetrics
from flashfftconv_tpu.utils.generation import generate as jgenerate
from flashfftconv_tpu_torch.models import filters as tfilters
from flashfftconv_tpu_torch.models.hyena import HyenaOperator
from flashfftconv_tpu_torch.models.lm import Block, ConvLMHeadModel
from flashfftconv_tpu_torch.models.moe import MoEMlp
from flashfftconv_tpu_torch.utils import jax_weights, metrics
from flashfftconv_tpu_torch.utils.generation import generate, sample_logits

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

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
    """MoE, the last option of the JAX LM that raised here, now builds with
    every mixer and MLP option: the block's MLP is a ``MoEMlp`` (held to
    flax in test_torch_moe.py), and a forward gives finite outputs of the
    input's shape. The h3, m2 and long-conv mixers and block-diagonal MLPs
    are tested in test_torch_h3.py and test_torch_longconv.py."""
    model = make()
    block = model.backbone.blocks[0] if isinstance(model, ConvLMHeadModel) else model
    assert isinstance(block.mlp, MoEMlp)
    with torch.no_grad():
        if isinstance(model, ConvLMHeadModel):
            y = model(torch.randint(0, 32, (2, 64), generator=torch.Generator().manual_seed(0)))
            assert y.shape == (2, 64, 32)
        else:
            x = torch.randn(2, 64, 8, generator=torch.Generator().manual_seed(0))
            y = model(x)
            assert y.shape == x.shape
    assert torch.isfinite(y).all()


# --- grads -----------------------------------------------------------------

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
