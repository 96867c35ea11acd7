"""The long convolution (64K-4M) of the port against the JAX package's Pallas
kernels, forward and backward, f32 and bf16. Helpers and tolerances are
those of ``test_torch_long.py``, whose docstring states them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flashfftconv_tpu as jff
import flashfftconv_tpu_torch as tff
from flashfftconv_tpu.ops import monarch_pallas as mp
from flashfftconv_tpu_torch.ops import monarch, monarch_cuda
from flashfftconv_tpu_torch.ops import plan as tplan
from test_torch_long import CPU, SIZES, _conv_data, _np

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)


def _jax_plan(n, dtype):
    plan = jff.make_plan(n, compute_dtype=dtype, factors=SIZES[n])
    assert mp.supported(plan) and len(plan.factors) == (3 if SIZES[n] is None else 4)
    return plan


BWD_FUSED = {65536: "_long_bwd_fused", 524288: "_long4_bwd_fused"}


F32_CASES = [("ungated", 2), ("gated", 1), ("padded", 3), ("gated_padded", 3), ("ungated", 1)]


def _bwd_pair(n, dtype, case, b, scale=1.0):
    """(port grads, JAX grads) of one long conv, each (du, dk, dpre, dpost)
    as f32 numpy arrays (gates' grads None when ungated). The JAX side is the
    fused backward of that plan, given ug and g as fft_conv_pallas's VJP gives
    them; the port's is long_spectrum, long_conv_bwd and long_dk_finish."""
    gated = "gated" in case
    length = n // 2 - 7 if "padded" in case else n
    rng = np.random.default_rng(n + 10 * b + len(case))
    u, k, gates = _conv_data(rng, n, b, 2, length, gated)
    dout = rng.standard_normal(u.shape).astype(np.float32) * scale
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ju, jd, *jg = (jnp.asarray(a).astype(jdt) for a in (u, dout, *gates))
    pre, post = jg if gated else (None, None)
    ug = ju if pre is None else ju * pre
    g = jd if post is None else jd * post
    fused = getattr(mp, BWD_FUSED[n])
    want = fused(_jax_plan(n, jdt), ju, jnp.asarray(k), pre, post, jd, ug, g)
    p = tplan.make_plan(n, dtype, device=CPU)
    tu, td, *tg = (torch.from_numpy(a).to(dtype) for a in (u, dout, *gates))
    tpre, tpost = tg if gated else (None, None)
    k_f = monarch_cuda.long_spectrum(p, torch.from_numpy(k))
    du, dpre, dpost, partials = monarch_cuda.long_conv_bwd(p, tu, k_f, tpre, tpost, td)
    dk = monarch_cuda.long_dk_finish(p, partials, k.shape[-1])
    assert du.dtype == dtype and dk.dtype == torch.float32 and dk.shape == k.shape
    to_np = lambda t: None if t is None else t.float().numpy()
    return ([to_np(t) for t in (du, dk, dpre, dpost)],
            [None if t is None else _np(t) for t in want])


@pytest.mark.parametrize("n", list(SIZES))
@pytest.mark.parametrize("case,b", F32_CASES)
def test_long_conv_matches_jax_pallas_f32(n, case, b):
    """f32: the port's fft_conv (long_spectrum, butterfly, long_conv_inner,
    inverse butterfly; plain on the CPU) against fft_conv_pallas in interpret
    mode, at 1e-4 of max(1, largest |y|)."""
    length = n // 2 - 7 if "padded" in case else n
    rng = np.random.default_rng(n + b)
    u, k, gates = _conv_data(rng, n, b, 2, length, "gated" in case)
    want = _np(mp.fft_conv_pallas(_jax_plan(n, jnp.float32), *(jnp.asarray(a) for a in (u, k, *gates))))
    p = tplan.make_plan(n, torch.float32, device=CPU)
    got = tff.fft_conv(p, *(torch.from_numpy(a) for a in (u, k, *gates)))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() < 1e-4 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("n", list(SIZES))
@pytest.mark.parametrize("case,b", [("gated", 2), ("padded", 1)])
def test_long_conv_matches_jax_pallas_bf16(n, case, b):
    """bf16 inputs and plan: within the repo's 1e-2 at |y| <= 0.5."""
    length = n // 2 if "padded" in case else n
    rng = np.random.default_rng(n + b + 1)
    u, k, gates = _conv_data(rng, n, b, 2, length, "gated" in case, y_max=0.5)
    ju, *jg = (jnp.asarray(a).astype(jnp.bfloat16) for a in (u, *gates))
    want = _np(mp.fft_conv_pallas(_jax_plan(n, jnp.bfloat16), ju, jnp.asarray(k), *jg))
    tu, *tg = (torch.from_numpy(a).bfloat16() for a in (u, *gates))
    p = tplan.make_plan(n, torch.bfloat16, device=CPU)
    got = tff.fft_conv(p, tu, torch.from_numpy(k), *tg)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() < 1e-2


@pytest.mark.parametrize("n", list(BWD_FUSED))
@pytest.mark.parametrize("case,b", [("ungated", 2), ("gated", 1), ("gated_padded", 3),
                                    ("padded", 1)])
def test_long_backward_matches_jax_fused_backward_f32(n, case, b):
    """f32: du, dk, dpre and dpost against _long_bwd_fused at 65536 and
    _long4_bwd_fused at 524288 (factors (4, 4, 256, 128)), at 1e-4 of
    max(1, largest |grad|)."""
    got, want = _bwd_pair(n, torch.float32, case, b)
    for name, a, r in zip(("du", "dk", "dpre", "dpost"), got, want):
        assert (a is None) == (r is None), name
        if r is not None:
            assert a.shape == r.shape, name
            assert np.abs(a - r).max() < 1e-4 * max(1.0, np.abs(r).max()), name


@pytest.mark.parametrize("n", list(BWD_FUSED))
@pytest.mark.parametrize("case,b", [("gated", 2), ("padded", 1)])
def test_long_backward_matches_jax_fused_backward_bf16(n, case, b):
    """bf16 inputs and plan: the bf16 grads within the repo's 1e-2 once dout
    is scaled so that they stay within 0.5; dk (f32 on both sides, a sum
    over B*L products of bf16-rounded spectra on the JAX side) within 1e-2
    of its largest |value|."""
    probe, _ = _bwd_pair(n, torch.float32, case, b)
    scale = 0.5 / max(np.abs(a).max() for a in (probe[0], *probe[2:]) if a is not None)
    got, want = _bwd_pair(n, torch.bfloat16, case, b, scale=scale)
    for name, a, r in zip(("du", "dk", "dpre", "dpost"), got, want):
        if r is not None:
            tol = 1e-2 * np.abs(r).max() if name == "dk" else 1e-2
            assert np.abs(a - r).max() < tol, (name, np.abs(a - r).max(), np.abs(r).max())


def test_long_backward_of_a_band_8192_plan_matches_jax(monkeypatch):
    """A custom plan of FFT size 131072 with an 8192-point band (factors
    (8, 32, 16, 16)) runs its forward under its own factors and its backward
    under bwd_plan, the default plan of that size (band 4096: the backward
    kernel holds four bands of at most 4096 points), as the JAX package's
    _bwd_plan lets a backward run under factors of its own. Output and the
    grads of u, k and the gates against fft_conv_pallas and its jax.grad at
    1e-4 of max(1, largest |value|)."""
    import jax

    n = 131072
    p = tplan.make_plan(n, torch.float32, device=CPU, factors=(8, 32, 16, 16))
    assert p.band == 8192 and monarch_cuda.bwd_plan(p).band == monarch_cuda.MAX_BWD_BAND
    assert monarch_cuda.bwd_plan(monarch_cuda.bwd_plan(p)) is monarch_cuda.bwd_plan(p)
    bands = []
    inner = monarch.long_conv_bwd_inner_plain
    monkeypatch.setattr(monarch, "long_conv_bwd_inner_plain",
                        lambda plan, *a, **kw: bands.append(plan.band) or inner(plan, *a, **kw))
    rng = np.random.default_rng(81)
    u, k, gates = _conv_data(rng, n, 1, 2, n // 2, True)
    dout = rng.standard_normal(u.shape).astype(np.float32)
    jp = jff.make_plan(n, compute_dtype=jnp.float32)
    args = [jnp.asarray(a) for a in (u, k, *gates)]
    y_ref = _np(mp.fft_conv_pallas(jp, *args))
    want = jax.jit(jax.grad(lambda *a: jnp.sum(mp.fft_conv_pallas(jp, *a) * dout),
                            argnums=(0, 1, 2, 3)))(*args)
    ts = [torch.from_numpy(a).requires_grad_() for a in (u, k, *gates)]
    y = tff.fft_conv(p, *ts)
    np.testing.assert_allclose(y.detach().numpy(), y_ref, atol=1e-4 * max(1.0, np.abs(y_ref).max()))
    got = torch.autograd.grad(y, ts, torch.from_numpy(dout))
    assert bands == [4096]
    for name, a, r in zip(("u", "k", "pre", "post"), got, want):
        r = _np(r)
        np.testing.assert_allclose(a.numpy(), r, atol=1e-4 * max(1.0, np.abs(r).max()),
                                   err_msg=name)


def test_flashfftconv_module_131072_matches_jax():
    n = 131072
    rng = np.random.default_rng(5)
    u, k, gates = _conv_data(rng, n, 2, 3, n // 2, True)
    conv = tff.FlashFFTConv(n, dtype=torch.float32, device=CPU)
    assert conv.plan.n_outer == 1 and "sub_tw_flat" in dict(conv.named_buffers())
    got = conv(*(torch.from_numpy(a) for a in (u, k, *gates)))
    want = _np(jff.FlashFFTConv(n, dtype=jnp.float32)(*(jnp.asarray(a) for a in (u, k, *gates))))
    assert np.abs(got.numpy() - want).max() < 1e-4 * max(1.0, np.abs(want).max())
    assert np.abs(conv(torch.from_numpy(u), torch.from_numpy(k)).numpy()
                  - _np(jff.fft_conv_reference(n, jnp.asarray(u), jnp.asarray(k)))).max() < 1e-3
