"""Parity of the port's fused ops (``ops/fused.py``) with the JAX package's.

Inputs from numpy with a seed; both sides on the CPU. Tolerances: f32
outputs at atol 1e-5 (the same f32 compositions, another summation order),
bf16 outputs within one bf16 ulp of their scale (2^-7 relative). The
dropout ops draw their masks from different generators, so they are held
to the JAX ops at rate 0 and at ``deterministic=True`` exactly, and at rate
> 0 to their keep rate (within 5 standard deviations) and their 1/(1 - rate)
scaling of the kept elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashfftconv_tpu_torch as tff
from flashfftconv_tpu.ops import fused as jfused


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, ref, dtype=torch.float32):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = got.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=1e-5)
    else:
        np.testing.assert_allclose(got, ref, atol=2.0**-7 * float(np.abs(ref).max()))


_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_bias_gelu_matches_jax(dtype):
    x, w, b = _rand(0, 4, 7, 32), _rand(1, 32, 48, scale=0.2), _rand(2, 48)
    ref = jfused.dense_bias_gelu(jnp.asarray(x, _DT[dtype]), jnp.asarray(w), jnp.asarray(b))
    got = tff.dense_bias_gelu(torch.from_numpy(x).to(dtype), torch.from_numpy(w),
                              torch.from_numpy(b))
    assert got.dtype == dtype
    _close(got, ref, dtype)


@pytest.mark.parametrize("prenorm", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("norm", ["layer", "rms"])
def test_dropout_add_norm_at_rate_0_matches_jax(norm, residual, prenorm):
    """Rate 0 in training mode and rate 0.3 with deterministic=True are both
    the plain residual norm, as in the JAX op."""
    x, r, wt, bs = _rand(3, 2, 5, 40), _rand(4, 2, 5, 40), _rand(5, 40), _rand(6, 40)
    res = jnp.asarray(r) if residual else None
    tres = torch.from_numpy(r) if residual else None
    for rate, det in ((0.0, False), (0.3, True)):
        if norm == "layer":
            ref = jfused.dropout_add_layer_norm(jnp.asarray(x), res, jnp.asarray(wt),
                                                jnp.asarray(bs), rate, jax.random.PRNGKey(0),
                                                deterministic=det, prenorm=prenorm)
            got = tff.dropout_add_layer_norm(torch.from_numpy(x), tres, torch.from_numpy(wt),
                                             torch.from_numpy(bs), rate, deterministic=det,
                                             prenorm=prenorm)
        else:
            ref = jfused.dropout_add_rms_norm(jnp.asarray(x), res, jnp.asarray(wt), rate,
                                              jax.random.PRNGKey(0), deterministic=det,
                                              prenorm=prenorm)
            got = tff.dropout_add_rms_norm(torch.from_numpy(x), tres, torch.from_numpy(wt),
                                           rate, deterministic=det, prenorm=prenorm)
        if prenorm:
            _close(got[1], ref[1])
            got, ref = got[0], ref[0]
        _close(got, ref)


@pytest.mark.parametrize("norm", ["layer", "rms"])
def test_dropout_add_norm_keep_rate_and_scaling(norm):
    """At rate 0.25 the pre-norm residual (prenorm=True, no residual) is x /
    0.75 where kept and 0 elsewhere, a share 0.75 of the elements kept
    within 5 standard deviations; the same generator seed gives the same
    mask."""
    rate, n = 0.25, 64 * 512
    x = torch.from_numpy(_rand(7, 64, 512)) + 3.0  # no element is 0
    w, b = torch.ones(512), torch.zeros(512)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        if norm == "layer":
            return tff.dropout_add_layer_norm(x, None, w, b, rate, generator=g,
                                              deterministic=False, prenorm=True)[1]
        return tff.dropout_add_rms_norm(x, None, w, rate, generator=g, deterministic=False,
                                        prenorm=True)[1]

    res = run(0)
    kept = res != 0
    share = float(kept.float().mean())
    assert abs(share - (1 - rate)) <= 5 * (rate * (1 - rate) / n) ** 0.5, share
    torch.testing.assert_close(res[kept], x[kept] / (1 - rate))
    assert torch.equal(res, run(0)) and not torch.equal(res, run(1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_matches_jax(dtype):
    x, w = _rand(8, 3, 6, 48), _rand(9, 48)
    ref = jfused.rms_norm(jnp.asarray(x, _DT[dtype]), jnp.asarray(w))
    got = tff.rms_norm(torch.from_numpy(x).to(dtype), torch.from_numpy(w))
    assert got.dtype == dtype
    _close(got, ref, dtype)


@pytest.mark.parametrize("masked", [False, True])
def test_scaled_masked_softmax_matches_jax(masked):
    s = _rand(10, 2, 3, 8, 8)
    mask = np.random.default_rng(11).random((2, 1, 8, 8)) < 0.6 if masked else None
    ref = jfused.scaled_masked_softmax(jnp.asarray(s), None if mask is None else
                                       jnp.asarray(mask), scale=0.125)
    got = tff.scaled_masked_softmax(torch.from_numpy(s), None if mask is None else
                                    torch.from_numpy(mask), scale=0.125)
    _close(got, ref)


def test_apply_rotary_emb_matches_jax():
    x, ang = _rand(12, 2, 4, 10, 32), _rand(13, 10, 16)
    ref = jfused.apply_rotary_emb(jnp.asarray(x), jnp.cos(ang), jnp.sin(ang))
    got = tff.apply_rotary_emb(torch.from_numpy(x), torch.from_numpy(np.cos(ang)),
                               torch.from_numpy(np.sin(ang)))
    _close(got, ref)


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
@pytest.mark.parametrize("ignore_index", [-100, 3])
def test_cross_entropy_loss_matches_jax(ignore_index, label_smoothing):
    """With ignored labels (-100 pads, or a real class id as ignore_index)
    and label smoothing: the loss and its grad of the logits."""
    logits = _rand(14, 4, 9, 37, scale=3.0)
    labels = np.random.default_rng(15).integers(0, 37, (4, 9))
    labels[0, :4] = -100
    labels[1, 2] = 3

    def jloss(lg):
        return jfused.cross_entropy_loss(lg, jnp.asarray(labels), ignore_index=ignore_index,
                                         label_smoothing=label_smoothing)

    ref, gref = jax.value_and_grad(jloss)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = tff.cross_entropy_loss(lt, torch.from_numpy(labels), ignore_index=ignore_index,
                                 label_smoothing=label_smoothing)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gref), atol=1e-7)
