"""The port's FFT conv (the Monarch and fallback routes) against the JAX
package's Pallas kernels, forward and grads, f32 and bf16. Helpers and
tolerances are those of ``test_torch_ops.py``, whose docstring states them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flashfftconv_tpu as jff
import flashfftconv_tpu_torch as tff
from flashfftconv_tpu.ops import monarch_pallas
from flashfftconv_tpu_torch.ops import dispatch, monarch_cuda
from flashfftconv_tpu_torch.ops import plan as tplan
from test_torch_ops import CPU, _assert_grads_close, _conv_data, _np

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)


@pytest.mark.parametrize("n", [256, 1024, 4096])
@pytest.mark.parametrize("case", ["ungated", "gated", "padded", "gated_padded"])
def test_conv_matches_jax_pallas_f32(n, case):
    """f32: the port's wrappers (spectrum + monarch_conv, plain on the CPU)
    against fft_conv(impl='pallas') (the fused Pallas kernels in interpret
    mode) and the JAX fft oracle, at atol 1e-4."""
    gated = "gated" in case
    length = n // 2 if "padded" in case else n
    u, k, gates = _conv_data(np.random.default_rng(n), 2, 16, length, length, gated)
    jp = jff.make_plan(n, compute_dtype=jnp.float32)
    jargs = [jnp.asarray(a) for a in (u, k, *gates)]
    y_pallas = _np(jff.fft_conv(jp, *jargs, impl="pallas"))
    y_ref = _np(jff.fft_conv_reference(n, *jargs))
    p = tplan.make_plan(n, torch.float32, device=CPU)
    tu, tk, *tg = (torch.from_numpy(a) for a in (u, k, *gates))
    got = monarch_cuda.monarch_conv(p, tu, monarch_cuda.spectrum(p, tk), *tg).numpy()
    np.testing.assert_allclose(got, y_pallas, atol=1e-4)
    np.testing.assert_allclose(got, y_ref, atol=1e-4)
    np.testing.assert_allclose(tff.fft_conv(p, tu, tk, *tg).numpy(), y_ref, atol=1e-4)


@pytest.mark.parametrize("n", [1024, 4096])
@pytest.mark.parametrize("gated", [False, True])
def test_conv_matches_jax_pallas_bf16(n, gated):
    """bf16 I/O at the repo's 1e-2 (module docstring)."""
    u, k, gates = _conv_data(np.random.default_rng(n + 1), 2, 16, n // 2, n // 2, gated,
                             y_max=0.5)
    jp = jff.make_plan(n, compute_dtype=jnp.bfloat16)
    jargs = [jnp.asarray(a, jnp.bfloat16) if i != 1 else jnp.asarray(a)
             for i, a in enumerate((u, k, *gates))]
    y_pallas = _np(jff.fft_conv(jp, *jargs, impl="pallas").astype(jnp.float32))
    p = tplan.make_plan(n, torch.bfloat16, device=CPU)
    targs = [torch.from_numpy(_np(a.astype(jnp.float32))) for a in jargs]
    targs = [t.to(torch.bfloat16) if i != 1 else t for i, t in enumerate(targs)]
    got = dispatch.fft_conv(p, *targs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), y_pallas, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fallback_shape_matches_jax_tile_kernels(monkeypatch, dtype):
    """N = 2048 (JAX factors (16, 128)), B = 3, H = 5, L = 1000: odd B, no
    channel tile and L % n2 != 0 send fft_conv_pallas to its tile kernels,
    _conv_tiles (real I/O) forward and _bwd_tiles backward, in interpret
    mode (spies assert they ran). The port's FftConvFunction computes their
    function at this shape (monarch_conv and monarch_conv_bwd, plain on the
    CPU): output and grads of u, k and the gates at the module docstring's
    f32 and bf16 tolerances."""
    n, b, h, length = 2048, 3, 5, 1000
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = jff.make_plan(n, compute_dtype=jdt)
    assert jp.factors == (16, 128) and monarch_pallas._h_tile(*jp.factors, h) is None
    calls = {"_conv_tiles": 0, "_bwd_tiles": 0}
    for name in calls:
        orig = getattr(monarch_pallas, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(monarch_pallas, name, spy)
    low = dtype == torch.bfloat16
    u, k, gates = _conv_data(np.random.default_rng(60 + low), b, h, length, length, True,
                             y_max=0.5 if low else None)
    dout = np.random.default_rng(61).standard_normal(u.shape).astype(np.float32)
    cast = lambda a: jnp.asarray(a, jdt)
    jargs = [cast(u), jnp.asarray(k), *map(cast, gates)]
    y_ref = _np(monarch_pallas.fft_conv_pallas(jp, *jargs).astype(jnp.float32))
    want = jax.jit(jax.grad(
        lambda *a: jnp.sum((monarch_pallas.fft_conv_pallas(jp, *a) * cast(dout))
                           .astype(jnp.float32)), argnums=(0, 1, 2, 3)))(*jargs)
    assert calls == {"_conv_tiles": 2, "_bwd_tiles": 1}
    p = tplan.make_plan(n, dtype, device=CPU)
    ts = [torch.from_numpy(_np(a)) for a in jargs]
    ts = [(t if i == 1 else t.to(dtype)).requires_grad_() for i, t in enumerate(ts)]
    y = tff.fft_conv(p, *ts)
    tol = 1e-2 if low else 1e-4
    np.testing.assert_allclose(y.detach().float().numpy(), y_ref,
                               atol=tol * max(1.0, np.abs(y_ref).max()))
    got = torch.autograd.grad(y, ts, torch.from_numpy(_np(cast(dout))).to(dtype))
    _assert_grads_close(got, want, tol, "u k pre post".split())


@pytest.mark.parametrize("gated,padded,b", [
    *(pytest.param(g, p, 2, id=f"{p}-{g}") for g in (False, True) for p in (False, True)),
    pytest.param(False, False, 8, id="B8-ungated"), pytest.param(True, True, 8, id="B8-gated"),
    pytest.param(True, False, 3, id="B3-gated"), pytest.param(False, True, 3, id="B3-ungated"),
])
def test_conv_grads_match_jax_bwd_fused_f32(gated, padded, b):
    """jax.grad of fft_conv_pallas, whose backward runs _bwd_fused_io_tiles
    in interpret mode (H=64 fits its channel tile, L % n2 == 0), against the
    port's FftConvFunction with the plain backward, f32. B = 8 sums the dk
    spectra of all 8 rows into one partial (bwd_group 8), B = 3 keeps one
    partial a row (bwd_group 1)."""
    n = 2048
    jp = jff.make_plan(n, compute_dtype=jnp.float32)
    length = n - jp.factors[1] if padded else n
    assert monarch_pallas._h_tile(*jp.factors, 64) is not None and length % jp.factors[1] == 0
    rng = np.random.default_rng(20 + 2 * gated + padded + 10 * (b != 2))
    u, k, gates = _conv_data(rng, b, 64, length, length, gated)
    dout = rng.standard_normal(u.shape).astype(np.float32)
    args = [jnp.asarray(a) for a in (u, k, *gates)]
    ref = jax.grad(lambda *a: jnp.sum(monarch_pallas.fft_conv_pallas(jp, *a) * dout),
                   argnums=tuple(range(len(args))))(*args)
    p = tplan.make_plan(n, torch.float32, device=CPU)
    ts = [torch.from_numpy(a).requires_grad_() for a in (u, k, *gates)]
    y = tff.fft_conv(p, *ts)
    assert type(y.grad_fn).__name__ == "FftConvFunctionBackward"
    got = torch.autograd.grad(y, ts, torch.from_numpy(dout))
    _assert_grads_close(got, ref, 1e-4, "u k pre post".split())


@pytest.mark.parametrize("gated", [False, True])
def test_conv_grads_match_jax_bwd_fused_bf16(gated):
    """bf16 I/O: u, gates and dout in bf16, k and dk in f32 (module
    docstring)."""
    n = 2048
    jp = jff.make_plan(n, compute_dtype=jnp.bfloat16)
    length = n - jp.factors[1]
    u, k, gates = _conv_data(np.random.default_rng(30 + gated), 2, 16, length, length, gated,
                             y_max=0.5)
    dout = np.random.default_rng(40).standard_normal(u.shape).astype(np.float32)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    args = [bf(u), jnp.asarray(k), *map(bf, gates)]
    ref = jax.grad(lambda *a: jnp.sum((monarch_pallas.fft_conv_pallas(jp, *a) * bf(dout))
                                      .astype(jnp.float32)),
                   argnums=tuple(range(len(args))))(*args)
    p = tplan.make_plan(n, torch.bfloat16, device=CPU)
    ts = [torch.from_numpy(_np(a)) for a in args]
    ts = [(t if i == 1 else t.to(torch.bfloat16)).requires_grad_() for i, t in enumerate(ts)]
    got = torch.autograd.grad(tff.fft_conv(p, *ts), ts,
                              torch.from_numpy(_np(bf(dout))).to(torch.bfloat16))
    assert [a.dtype for a in got] == [t.dtype for t in ts]
    _assert_grads_close(got, ref, 1e-2, "u k pre post".split())
