"""The H3 operator, the S4D kernel and the LM with each mixer on the port
against the flax modules. Helpers and tolerances are those of
``test_torch_h3.py``, whose docstring states them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flashfftconv_tpu.models import h3 as jh3
from flashfftconv_tpu.models import ssm as jssm
from flashfftconv_tpu.models.lm import ConvLMHeadModel as JLM
from flashfftconv_tpu.utils import metrics as jmetrics
from flashfftconv_tpu_torch.models import h3, ssm
from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel
from flashfftconv_tpu_torch.utils import jax_weights, metrics
from test_torch_h3 import CPU, _close, _init, _load, _np

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)


def _assert_grads_match(jax_grads: dict, model, tol=1e-4):
    assert set(jax_grads) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        ref = jax_grads[name].numpy()
        # a parameter the forward never reads (an M2 filter's bias) has no grad
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        err = float(np.abs(got - ref).max())
        assert err <= tol * float(np.abs(ref).max()) + 1e-7, (name, err, float(np.abs(ref).max()))


LM = dict(d_model=32, n_layer=2, d_inner=64, vocab_size=64, l_max=128)


OPERATORS = {
    "long_conv_hd1": dict(head_dim=1),
    "long_conv_hd2": dict(head_dim=2),
    "shift_s4d_hd1": dict(head_dim=1, k_kernel_type="shift", ssm_kernel_type="s4d", d_state=16),
    "shift_s4d_hd2": dict(head_dim=2, k_kernel_type="shift", ssm_kernel_type="s4d", d_state=16),
}


LMS = {
    "h3": (dict(mixer="h3", mixer_kwargs={"kernel_lam": 0.001}), {}),
    "h3_shift_s4d": (dict(mixer="h3"), dict(head_dim=2, k_kernel_type="shift",
                                            ssm_kernel_type="s4d", d_state=16)),
    "m2_blockdiag_mlp": (dict(mixer="m2", mlp_nblocks=4), {}),
}


@pytest.mark.parametrize("measure", ["lin", "inv", "legs"])
def test_s4d_kernel_matches_flax(measure):
    jm = jssm.S4DKernel(h=24, n_state=16, measure=measure)
    params, pnp = _init(jm, 200)
    ref = jm.apply({"params": params}, 200)
    tm = _load(ssm.S4DKernel(24, n_state=16, measure=measure, device=CPU),
               jax_weights._leaves(pnp, ""))
    got = tm(200)
    assert got.shape == (24, 200) and got.dtype == torch.float32
    _close(got.detach(), ref, 1e-5)
    # the same grads through the Vandermonde
    w = np.random.default_rng(1).standard_normal((24, 200)).astype(np.float32)
    gp = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, 200) * w)))(params)
    (got * torch.from_numpy(w)).sum().backward()
    _assert_grads_match(jax_weights._leaves(jax.tree_util.tree_map(np.asarray, gp), ""), tm,
                        tol=1e-5)


@pytest.mark.parametrize("name", list(OPERATORS))
def test_h3_operator_matches_flax(name):
    """Outputs and grads (every parameter's and the input's) of the f32
    operator at d_model 32, l_max 128 (FFT size 256), L = 100 < l_max at
    head_dim 1 (the flax module takes only L = l_max at a larger head_dim);
    the JAX side runs the direct Pallas kernels in interpret mode."""
    opts = OPERATORS[name]
    length = 100 if opts["head_dim"] == 1 else 128
    jm = jh3.H3Operator(d_model=32, l_max=128, kernel_lam=0.001, conv_dtype=jnp.float32,
                        impl="pallas", **opts)
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, length, 32)).astype(np.float32)
    dout = rng.standard_normal((2, length, 32)).astype(np.float32)
    params, pnp = _init(jm, jnp.asarray(u))
    ref = jm.apply({"params": params}, jnp.asarray(u))
    gp, gu = jax.jit(jax.grad(lambda p, x: jnp.sum(jm.apply({"params": p}, x) * dout),
                              argnums=(0, 1)))(params, jnp.asarray(u))
    tm = h3.H3Operator(32, 128, kernel_lam=0.001, conv_dtype=torch.float32, device=CPU, **opts)
    _load(tm, jax_weights.h3_operator_state_dict(pnp))
    tu = torch.from_numpy(u).requires_grad_()
    got = tm(tu)
    (got * torch.from_numpy(dout)).sum().backward()
    _close(got.detach(), ref, 1e-4)
    _assert_grads_match(jax_weights.h3_operator_state_dict(jax.tree_util.tree_map(np.asarray, gp)),
                        tm)
    _close(tu.grad, gu, 1e-4)


def test_h3_operator_bf16_matches_flax():
    """bf16 activations (the LM's dtype): the f32 k_D promotes k to f32, so
    the second conv and the gate run in f32 on both sides; outputs at 1e-2."""
    jm = jh3.H3Operator(d_model=32, l_max=128, impl="xla")
    u = np.random.default_rng(4).standard_normal((2, 128, 32)).astype(np.float32)
    ju = jnp.asarray(u, jnp.bfloat16)
    params, pnp = _init(jm, ju)
    ref = jm.apply({"params": params}, ju)
    tm = _load(h3.H3Operator(32, 128, device=CPU), jax_weights.h3_operator_state_dict(pnp))
    with torch.no_grad():
        got = tm(torch.from_numpy(_np(ju.astype(jnp.float32))).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(ref.astype(jnp.float32)), atol=1e-2)


@pytest.mark.parametrize("name", list(LMS))
def test_lm_with_mixer_matches_flax(name):
    """A 2-layer f32 LM with the h3 (both kernel pairs) or m2 mixer (with
    the block-diagonal MLP): logits at 2e-3, the loss at 1e-5 relative and
    every parameter's grad at 1e-4 of its largest |grad|."""
    lm_kw, extra = LMS[name]
    mk = {**lm_kw.get("mixer_kwargs", {}), **extra}
    lm_kw = {k: v for k, v in lm_kw.items() if k != "mixer_kwargs"}
    jm = JLM(**LM, **lm_kw, mixer_kwargs={**mk, "conv_dtype": jnp.float32, "impl": "xla"},
             dtype=jnp.float32)
    xy = np.random.default_rng(5).integers(0, 64, (2, 129))
    x, y = xy[:, :-1], xy[:, 1:]
    params, pnp = _init(jm, jnp.asarray(x))
    logits = jm.apply({"params": params}, jnp.asarray(x))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmetrics.cross_entropy(
        jm.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y))))(params)
    tm = ConvLMHeadModel(**LM, **lm_kw, mixer_kwargs={**mk, "conv_dtype": torch.float32},
                         dtype=torch.float32, device=CPU).eval()
    tm.load_state_dict(jax_weights.from_jax_params(pnp), strict=True)
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), _np(logits), atol=2e-3)
    tl = metrics.cross_entropy(got, torch.from_numpy(y))
    tl.backward()
    assert abs(float(tl.detach()) - float(loss)) <= 1e-5 * float(loss)
    _assert_grads_match(jax_weights.from_jax_params(jax.tree_util.tree_map(np.asarray, grads)),
                        tm)


def test_flax_paths_of_the_h3_lm_invert_the_key_map():
    """flax_paths (the optimizer's labels) of an h3 LM leads to the flax
    leaf that from_jax_params puts under each name."""
    jm = JLM(**LM, mixer="h3", mixer_kwargs={"conv_dtype": jnp.float32, "impl": "xla"},
             dtype=jnp.float32)
    _, pnp = _init(jm, jnp.zeros((1, 16), jnp.int32))
    tm = ConvLMHeadModel(**LM, mixer="h3", device=CPU)
    sd = jax_weights.from_jax_params(pnp)
    paths = jax_weights.flax_paths(tm)
    assert set(paths) == set(sd)
    for name, path in paths.items():
        leaf = pnp
        for part in path:
            leaf = leaf[part]
        leaf = np.asarray(leaf, np.float32)
        dense = path[-1] == "kernel" and leaf.ndim == 2  # a Dense kernel, (in, out)
        np.testing.assert_array_equal(leaf.T if dense else leaf, sd[name].numpy())
