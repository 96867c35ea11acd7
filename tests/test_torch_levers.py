"""The memory levers of the 1M-base HyenaDNA recipe on the port against the
flax modules: remat, scan_blocks, inner_remat, mlp_l_chunks, conv_h_chunks,
proj_l_chunks, proj_out_f32, filter_output_dtype, mlp_dtype and the short
filter's history, each set on the flax model and on the port alike, from the
same weights; loss and grads are compared. The f32 levers are exact
rearrangements, so the 1e-4 bound of the lever-free model holds; the two
bf16 dtype levers round the filter to bf16 on both sides (8 bits of
mantissa), and their grads are held to 2e-2 of each parameter's largest
|grad|. Helpers and tolerances are those of ``test_torch_models.py``, whose
docstring states them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flashfftconv_tpu.models.lm import ConvLMHeadModel as JLM
from flashfftconv_tpu.utils import metrics as jmetrics
from flashfftconv_tpu_torch.models.hyena import HyenaOperator, ShortDepthwiseConv
from flashfftconv_tpu_torch.models.lm import Block, ConvLMHeadModel
from flashfftconv_tpu_torch.utils import jax_weights, metrics
from test_torch_models import CPU, _assert_grads_match, _init, _np

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)


_OP = dict(d_model=8, l_max=64, device=CPU)


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
