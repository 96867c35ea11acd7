"""Parity of the port's partial and frequency-sparse convs with the JAX
package's ``ops/sparse.py``, on the CPU.

Inputs come from numpy with a seed. With a plan the port runs
``dispatch.fft_conv`` (on the CPU the kernels' plain versions: the direct
plan at FFT size 512, the Monarch plan at 2048), the JAX package its
``impl="xla"`` path, as its own tests do; without a plan both run their
FFT libraries. Tolerances: f32 outputs at atol 1e-4 (|y| ~ 1), grads at
1e-4 of each one's largest |value|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashfftconv_tpu as jff
import flashfftconv_tpu_torch as tff
from flashfftconv_tpu.ops import sparse as jsparse


def _inputs(seed, h, length, k_len):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, length)).astype(np.float32)
    k = (rng.standard_normal((h, k_len)) * 0.1).astype(np.float32)
    return x, k


@pytest.mark.parametrize("length,n_partial", [(256, 64), (1024, 100)])
def test_partial_fft_conv_with_a_plan_matches_jax(length, n_partial):
    """Through the direct plan (N = 512) and a Monarch plan (N = 2048):
    output and the grads of x and k."""
    x, k = _inputs(length, 4, length, length)
    w = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    jplan = jff.make_plan(2 * length, compute_dtype=jnp.float32)

    def jloss(xx, kk):
        return jnp.sum(jff.partial_fft_conv(xx, kk, n_partial, plan=jplan, impl="xla") * w)

    ref = np.asarray(jff.partial_fft_conv(jnp.asarray(x), jnp.asarray(k), n_partial,
                                          plan=jplan, impl="xla"))
    gx, gk = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(k))
    plan = tff.make_plan(2 * length, torch.float32, device="cpu")
    xt, kt = (torch.from_numpy(a).requires_grad_() for a in (x, k))
    y = tff.partial_fft_conv(xt, kt, n_partial, plan=plan)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), ref, atol=1e-4)
    for got, r in ((xt.grad, gx), (kt.grad, gk)):
        r = np.asarray(r)
        np.testing.assert_allclose(got.numpy(), r, atol=1e-4 * float(np.abs(r).max()))
    assert not kt.grad[:, n_partial:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_partial_fft_conv_without_a_plan_matches_jax(dtype):
    """At FFT size 2 L through the FFT libraries, in x's dtype."""
    x, k = _inputs(7, 3, 200, 200)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jsparse.partial_fft_conv(jnp.asarray(x, jdt), jnp.asarray(k), 50)
    y = tff.partial_fft_conv(torch.from_numpy(x).to(dtype), torch.from_numpy(k), 50)
    assert y.dtype == dtype
    atol = 1e-4 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=atol)


@pytest.mark.parametrize("n_partial", [1, 64, 255])
def test_frequency_sparse_fft_conv_matches_jax(n_partial):
    x, k = _inputs(n_partial, 3, 128, 128)
    ref = np.asarray(jff.frequency_sparse_fft_conv(jnp.asarray(x), jnp.asarray(k), n_partial))
    y = tff.frequency_sparse_fft_conv(torch.from_numpy(x), torch.from_numpy(k), n_partial)
    np.testing.assert_allclose(y.numpy(), ref, atol=1e-4)


def test_class_wrappers_match_the_functions():
    x, k = (torch.from_numpy(a) for a in _inputs(3, 2, 256, 256))
    plan = tff.make_plan(512, torch.float32, device="cpu")
    torch.testing.assert_close(tff.PartialFFTConv(32, plan=plan)(x, k),
                               tff.partial_fft_conv(x, k, 32, plan=plan), rtol=0, atol=0)
    torch.testing.assert_close(tff.FrequencySparseFFTConv(32)(x, k),
                               tff.frequency_sparse_fft_conv(x, k, 32), rtol=0, atol=0)
