"""flash_mha and the MHA operator of the port against JAX's flash attention and
the flax modules, forward, grads and decoding. Helpers and tolerances are
those of ``test_torch_attention.py``, whose docstring states them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flashfftconv_tpu.models import attention as jattn_mod
from flashfftconv_tpu.models.lm import ConvLMHeadModel as JLM
from flashfftconv_tpu.ops import attention as jattn
from flashfftconv_tpu.ops import fused as jfused
from flashfftconv_tpu_torch.models import attention as tattn_mod
from flashfftconv_tpu_torch.models.lm import Block, ConvLMHeadModel
from flashfftconv_tpu_torch.ops import attention as tattn
from flashfftconv_tpu_torch.ops import fused
from flashfftconv_tpu_torch.utils import jax_weights
from test_torch_attention import CPU, DTYPES, KERNEL_CASES, _assert_grads, _check, _init, _jax_attention

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)


RAGGED_CASES = [
    (1, 64, "f32", "causal"), (7, 64, "f32", "alibi"), (129, 128, "f32", "segments"),
    (300, 64, "f32", "noncausal"), (300, 64, "bf16", "causal"),
]


def _port_attention(inputs, dtype, case):
    q, k, v, do, bias, seg = inputs
    tdt = DTYPES[dtype][1]
    qt, kt, vt = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    bt = None if bias is None else torch.from_numpy(bias).requires_grad_()
    st = None if seg is None else torch.from_numpy(seg)
    out = tattn.flash_mha(qt, kt, vt, causal=case != "noncausal", bias=bt, segment_ids=st)
    out.backward(torch.from_numpy(do).to(tdt))
    grads = [t.grad.float().numpy() for t in (qt, kt, vt)]
    grads.append(None if bt is None else bt.grad.numpy())
    return out.detach().float().numpy(), grads


MHA_CASES = {
    "plain": dict(),
    "rotary8": dict(rotary_dim=8),
    "rotary_full": dict(rotary_dim=64),
    "alibi": dict(alibi=True),
    "segments": dict(),
}


@pytest.mark.parametrize("l,d,dtype,case", KERNEL_CASES + RAGGED_CASES)
def test_flash_mha_matches_jax_flash_attention(l, d, dtype, case):
    """The port's attention (the plain versions of the three kernels on the
    CPU) against the Pallas kernel (L = 256) or mha_reference (ragged L)."""
    inputs, ref_out, ref_grads = _jax_attention(l, d, dtype, case)
    out, grads = _port_attention(inputs, dtype, case)
    _check(out, grads, ref_out, ref_grads, dtype, inputs[4])


def test_alibi_rotary_and_packing_match_jax():
    np.testing.assert_allclose(tattn.alibi_slopes(12).numpy(),
                               np.asarray(jattn.alibi_slopes(12)), rtol=1e-7)
    for h, lq, lk in ((12, 7, 9), (8, 5, 5), (6, 1, 4)):
        np.testing.assert_allclose(tattn.alibi_bias(h, lq, lk).numpy(),
                                   np.asarray(jattn.alibi_bias(h, lq, lk)), rtol=1e-6)
    for l, dim in ((17, 8), (33, 64)):
        for got, want in zip(tattn_mod.rotary_tables(l, dim),
                             jattn_mod.rotary_tables(l, dim)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        x = np.random.default_rng(l).standard_normal((2, 3, l, dim)).astype(np.float32)
        cos, sin = jattn_mod.rotary_tables(l, dim)
        want = jfused.apply_rotary_emb(jnp.asarray(x), cos, sin)
        got = fused.apply_rotary_emb(torch.from_numpy(x), *tattn_mod.rotary_tables(l, dim))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    rng = np.random.default_rng(4)
    seqs = [rng.standard_normal((n, 3)).astype(np.float32) for n in (5, 9, 3, 12, 1, 7)]
    got, want = tattn.pack_sequences(seqs, 12), jattn.pack_sequences(seqs, 12)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    with pytest.raises(ValueError):
        tattn.pack_sequences(seqs, 8)


@pytest.mark.parametrize("case", list(MHA_CASES))
def test_mha_operator_matches_flax(case):
    """MHAOperator forward, input grad and parameter grads against flax
    (d_model 128, 2 heads of 64, L = 40), weights carried by mha_state_dict."""
    kw = MHA_CASES[case]
    rng = np.random.default_rng(6)
    u = rng.standard_normal((2, 40, 128)).astype(np.float32)
    w = rng.standard_normal((2, 40, 128)).astype(np.float32)
    seg = np.repeat(np.array([[1, 2, 3, 4], [1, 1, 2, 2]]), 10, axis=1).astype(np.int32) \
        if case == "segments" else None
    jm = jattn_mod.MHAOperator(d_model=128, num_heads=2, **kw)
    params, pnp = _init(jm, jnp.asarray(u))
    seg_j = None if seg is None else jnp.asarray(seg)

    def loss(p, x):
        return (jm.apply({"params": p}, x, segment_ids=seg_j) * w).sum()

    ref = jm.apply({"params": params}, jnp.asarray(u), segment_ids=seg_j)
    gp, gu = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(u))
    tm = tattn_mod.MHAOperator(128, num_heads=2, **kw, device=CPU)
    tm.load_state_dict(jax_weights.mha_state_dict(pnp), strict=True)
    ut = torch.from_numpy(u).requires_grad_()
    out = tm(ut, segment_ids=None if seg is None else torch.from_numpy(seg))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5 * float(np.abs(ref).max()))
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(gu),
                               atol=1e-4 * float(np.abs(gu).max()))
    _assert_grads(jax_weights.mha_state_dict(jax.tree_util.tree_map(np.asarray, gp)), tm)


@pytest.mark.parametrize("kw", [dict(rotary_dim=16), dict(alibi=True)])
def test_mha_step_decodes_like_the_forward_and_flax(kw):
    """step over a fresh cache, one position at a time, gives the forward's
    outputs at every position, and flax's apply_step the same."""
    rng = np.random.default_rng(7)
    u = rng.standard_normal((2, 12, 128)).astype(np.float32)
    jm = jattn_mod.MHAOperator(d_model=128, num_heads=2, **kw)
    params, pnp = _init(jm, jnp.asarray(u))
    tm = tattn_mod.MHAOperator(128, num_heads=2, **kw, device=CPU).eval()
    tm.load_state_dict(jax_weights.mha_state_dict(pnp), strict=True)
    with torch.no_grad():
        full = tm(torch.from_numpy(u))
        cache = tm.init_cache(2, 16)
        steps = []
        for pos in range(12):
            y, cache = tm.step(torch.from_numpy(u[:, pos : pos + 1]), cache, pos)
            steps.append(y)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(), atol=1e-5)
    jcache = jm.init_cache(2, 16)
    for pos in range(12):
        jy, jcache = jm.apply_step({"params": params}, jnp.asarray(u[:, pos : pos + 1]), jcache,
                                   pos)
        np.testing.assert_allclose(steps[pos].numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), atol=1e-5)


def test_conv_lm_with_the_mha_mixer_matches_flax():
    cfg = dict(d_model=128, n_layer=2, d_inner=256, vocab_size=64, l_max=32)
    mk = {"num_heads": 2, "alibi": True}
    jm = JLM(**cfg, mixer="mha", mixer_kwargs=mk, dtype=jnp.float32)
    ids = np.random.default_rng(9).integers(0, 64, (2, 32))
    params, pnp = _init(jm, jnp.asarray(ids))
    gp = jax.jit(jax.grad(lambda p: jm.apply({"params": p}, jnp.asarray(ids)).sum()))(params)
    tm = ConvLMHeadModel(**cfg, mixer="mha", mixer_kwargs=mk, dtype=torch.float32,
                         device=CPU).eval()
    tm.load_state_dict(jax_weights.from_jax_params(pnp), strict=True)
    logits = tm(torch.from_numpy(ids))
    logits.sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jm.apply({"params": params}, jnp.asarray(ids))),
                               atol=1e-4)
    _assert_grads(jax_weights.from_jax_params(jax.tree_util.tree_map(np.asarray, gp)), tm)
    with pytest.raises(ValueError, match="unknown mixer"):
        Block(16, 32, mixer="attention", device=CPU)
