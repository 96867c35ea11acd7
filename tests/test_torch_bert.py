"""Parity of the port's M2-BERT slice with the JAX package.

The direct-DFT conv of FFT sizes up to 512: the port's plain versions
(``direct_conv_plain``; the backward's ``conv_bwd_plain`` + ``dk_finish_plain``,
the plain versions of the row-FFT backward that ``direct_conv_bwd`` runs;
which the kernel wrappers run on CPU tensors) against the JAX package's
``_direct_fused_io_tiles`` and ``_direct_bwd_fused_io_tiles`` in interpret
mode (a spy asserts that they ran), and against its XLA direct path below
FFT size 256. Then the M2-BERT modules (``BlockdiagLinear``,
``MonarchMixerSequenceMixing``, a 2-layer ``M2BertForMaskedLM``) against
flax, weights carried by ``utils.jax_weights.m2_bert_state_dict``, the
M2-BERT checkpoint import against the JAX import, three optimizer steps
against the ``examples/bert`` optax chain and ``mlm_batches`` against the
example's ``mlm_batch``. Inputs come from numpy with a seed.

Tolerances: f32 conv outputs at atol 1e-4 (both sides are f32 DFTs of
outputs of order 1-10); grads at 1e-4 of max(1, their largest |value|) (dk
sums B*L products); bf16 outputs at the repo's 1e-2 with outputs scaled to
|y| <= 0.5 (the JAX kernel rounds its DFT tables and operands to bf16, the
port's DFT stays f32); f32 module outputs at 1e-4 of their largest |value|,
logits at 2e-3, every parameter's grad at 1e-4 of its largest |grad| in one
mixer and 5e-4 in the 2-layer model. The M2 filters' MLP runs Sin(10 x)
(``hyena_w`` 10), which magnifies the matmuls' summation order: one filter
alone differs from flax by 2.9e-5 of its largest value, and the 2-layer
model's grads by up to 1.6e-4 of theirs (``ref_structure``, where the
mixers carry the whole gradient), while the JAX package's own Pallas and
XLA paths, which share the filter, agree within 1e-6. Without the filter
MLPs (``inference_mode``) the mixer's grads agree within 8e-7, against
4.7e-5 with them.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashfftconv_tpu as jff
from flashfftconv_tpu.ops import monarch_pallas as mp
from flashfftconv_tpu_torch import FlashFFTConv
from flashfftconv_tpu_torch.ops import monarch, monarch_cuda
from flashfftconv_tpu_torch.ops import plan as tplan

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

CPU = "cpu"


def _np(x):
    return np.array(x, np.float32)


def _conv_data(rng, b, h, length, k_len, gated, y_max=None):
    """Unit-normal inputs and gates and a decaying kernel; with y_max the
    kernel is rescaled so that the largest |output| is y_max."""
    u = rng.standard_normal((b, h, length)).astype(np.float32)
    k = (rng.standard_normal((h, k_len)) * 0.1 * np.exp(-np.arange(k_len) / 50)).astype(
        np.float32)
    gates = [rng.standard_normal((b, h, length)).astype(np.float32)
             for _ in range(2 if gated else 0)]
    if y_max is not None:
        y = jff.fft_conv_reference(2 * max(length, k_len),
                                   *(jnp.asarray(a) for a in (u, k, *gates)))
        k = (k * (y_max / float(jnp.abs(y).max()))).astype(np.float32)
    return u, k, gates


def _spy(monkeypatch, name):
    calls = []
    orig = getattr(mp, name)

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(mp, name, spy)
    return calls


# --- the direct-DFT conv (kernels: _direct_fused_io_tiles and its backward) --

DIRECT_CASES = [(n, length, gated) for n in (256, 512) for length in (n // 2, n)
                for gated in (False, True)]


@pytest.mark.parametrize("n,length,gated", DIRECT_CASES)
def test_direct_conv_matches_jax_direct_kernel(monkeypatch, n, length, gated):
    """f32: direct_conv on CPU tensors (its plain version) against
    fft_conv_pallas at a 1-factor plan, where _direct_fused_io_tiles runs."""
    calls = _spy(monkeypatch, "_direct_fused_io_tiles")
    jp = jff.make_plan(n, compute_dtype=jnp.float32)
    assert jp.factors == (n,)
    u, k, gates = _conv_data(np.random.default_rng(n + length), 4, 16, length, length, gated)
    ref = _np(mp.fft_conv_pallas(jp, *(jnp.asarray(a) for a in (u, k, *gates))))
    assert calls, "the JAX direct kernel did not run"
    p = tplan.make_plan(n, torch.float32, device=CPU)
    assert p.direct and p.direct_roots.shape == (n,)
    tu, tk, *tg = (torch.from_numpy(a) for a in (u, k, *gates))
    got = monarch_cuda.direct_conv(p, tu, monarch_cuda.spectrum(p, tk), *tg)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("n,gated", [(256, False), (256, True), (512, True)])
def test_direct_conv_matches_jax_direct_kernel_bf16(monkeypatch, n, gated):
    """bf16 I/O at the repo's 1e-2, outputs scaled to |y| <= 0.5."""
    calls = _spy(monkeypatch, "_direct_fused_io_tiles")
    u, k, gates = _conv_data(np.random.default_rng(n + 7), 4, 16, n // 2, n // 2, gated,
                             y_max=0.5)
    jp = jff.make_plan(n, compute_dtype=jnp.bfloat16)
    jargs = [jnp.asarray(a, jnp.bfloat16) if i != 1 else jnp.asarray(a)
             for i, a in enumerate((u, k, *gates))]
    ref = _np(mp.fft_conv_pallas(jp, *jargs).astype(jnp.float32))
    assert calls
    p = tplan.make_plan(n, torch.bfloat16, device=CPU)
    targs = [torch.from_numpy(_np(a.astype(jnp.float32))) for a in jargs]
    tu, tk, *tg = [t.to(torch.bfloat16) if i != 1 else t for i, t in enumerate(targs)]
    got = monarch_cuda.direct_conv(p, tu, monarch_cuda.spectrum(p, tk), *tg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-2)


@pytest.mark.parametrize("n,length,gated", DIRECT_CASES)
def test_direct_conv_bwd_matches_jax_grad(monkeypatch, n, length, gated):
    """direct_conv_bwd on CPU tensors (its plain version conv_bwd_plain,
    with the dk spectrum in B / bwd_group(B) partials) and dk_finish against
    jax.grad through _direct_bwd_fused_io_tiles."""
    calls = _spy(monkeypatch, "_direct_bwd_fused_io_tiles")
    jp = jff.make_plan(n, compute_dtype=jnp.float32)
    rng = np.random.default_rng(n + length + 1)
    u, k, gates = _conv_data(rng, 4, 16, length, length, gated)
    dout = rng.standard_normal(u.shape).astype(np.float32)
    args = [jnp.asarray(a) for a in (u, k, *gates)]
    ref = jax.grad(lambda *a: jnp.sum(mp.fft_conv_pallas(jp, *a) * dout),
                   argnums=tuple(range(len(args))))(*args)
    assert calls, "the JAX direct backward kernel did not run"
    p = tplan.make_plan(n, torch.float32, device=CPU)
    tu, tk, *tg = (torch.from_numpy(a) for a in (u, k, *gates))
    du, dpre, dpost, parts = monarch_cuda.direct_conv_bwd(
        p, tu, monarch_cuda.spectrum(p, tk), *(tg or (None, None)), torch.from_numpy(dout))
    assert parts.shape == (4 // monarch.bwd_group(4), 16, n // 2 + 1)
    assert parts.dtype == torch.complex64
    got = [du, monarch_cuda.dk_finish(p, parts, length), *([dpre, dpost] if gated else [])]
    for name, a, r in zip("u k pre post".split(), got, ref):
        r = _np(r)
        np.testing.assert_allclose(a.numpy(), r, atol=1e-4 * max(1.0, float(np.abs(r).max())),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("b", [1, 3, 8, 20, 128])
def test_direct_dk_from_grouped_partials_matches_one_batch_sum(b):
    """At N = 256 the direct backward leaves dk's spectrum in B / bwd_group(B)
    partials (one per group of 1, 2, 4 or 8 rows, summed in b order) where it
    used to leave one sum over the whole batch: dk through dk_finish_plain
    from either agrees within the card's f32_tol (2e-5 of the largest |dk|);
    the single sum is taken here by the dense direct DFT of the direct
    path's tables."""
    n, h, length = 256, 4, 128
    rng = np.random.default_rng(b)
    u, gate, dout = (torch.from_numpy(rng.standard_normal((b, h, length)).astype(np.float32))
                     for _ in "abc")
    p = tplan.make_plan(n, torch.float32, device=CPU)
    k_f = monarch_cuda.spectrum(p, torch.from_numpy(rng.standard_normal((h, n))
                                                    .astype(np.float32) * 0.1))
    parts = monarch.conv_bwd_plain(p, u, k_f, gate, gate, dout)[3]
    assert parts.shape == (b // monarch.bwd_group(b), h, n // 2 + 1)
    w, _ = monarch._direct_tables(p, length)
    g_f, u_f = monarch._direct_dft(w, dout * gate), monarch._direct_dft(w, u * gate)
    one = (g_f * u_f.conj()).sum(0, keepdim=True)
    want = monarch.dk_finish_plain(p, one, n)
    got = monarch.dk_finish_plain(p, parts, n)
    assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max()) + 1e-7


def _unpack_direct_tf32(n, tab):
    """(C, I) as f32 hi + lo from the fragment order of direct_tf32 (the
    inverse of plan.direct_tf32_tables' gather), and each part's bits."""
    s, k, j, lane = np.meshgrid(np.arange(n // 16), np.arange(n // 8), np.arange(2),
                                np.arange(32), indexing="ij")
    g, q = lane // 4, lane % 4
    c, inv = np.zeros((n, n), np.float64), np.zeros((n, n), np.float64)
    fwd, bwd = tab[0].astype(np.float64), tab[1].astype(np.float64)
    c[8 * k + q, 16 * s + 8 * j + g] = fwd[..., 0] + fwd[..., 2]
    c[8 * k + q + 4, 16 * s + 8 * j + g] = fwd[..., 1] + fwd[..., 3]
    col = 16 * s + 8 * j + 2 * q
    inv[col, 8 * k + g] = bwd[..., 0] + bwd[..., 2]
    inv[col + 1, 8 * k + g] = bwd[..., 1] + bwd[..., 3]
    return c, inv


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256, 512])
def test_direct_tf32_tables_match_the_jax_dft_tables(n):
    """The direct forward kernel's tables (plan.direct_tf32): every entry of
    C and I, rebuilt from the fragment order as hi + lo, against the JAX
    package's 1-factor plan tables (dft_re, dft_im: the N-point DFT; idft_re,
    idft_im: its inverse with 1/N) at the columns the kernel takes (0: Re
    X[0], 1: Re X[M], 2f and 2f+1: Re and Im X[f]) within 1e-6; hi and lo
    each exact in TF32 (low 13 bits clear), hi the nearest TF32 value of the
    f32 entry, hi + lo within 2^-22 of it."""
    m = n // 2
    p = tplan.make_plan(n, torch.float32, device=CPU)
    tab = p.direct_tf32.numpy()
    assert tab.shape == (2, n // 16, n // 8, 2, 32, 4) and tab.dtype == np.float32
    assert not (tab.view(np.uint32) & np.uint32(0x1FFF)).any()
    jp = jff.make_plan(n, compute_dtype=jnp.float32)
    dre, dim_ = _np(jp.dft_re[0]), _np(jp.dft_im[0])
    ire, iim = _np(jp.idft_re[0]), _np(jp.idft_im[0])
    f = np.arange(1, m)
    want_c = np.empty((n, n))
    want_c[:, 0], want_c[:, 1] = dre[:, 0], dre[:, m]
    want_c[:, 2 * f], want_c[:, 2 * f + 1] = dre[:, f], dim_[:, f]
    want_i = np.empty((n, n))
    want_i[0], want_i[1] = ire[0], ire[m]
    want_i[2 * f], want_i[2 * f + 1] = 2 * ire[f], -2 * iim[f]
    c, inv = _unpack_direct_tf32(n, tab)
    np.testing.assert_allclose(c, want_c, rtol=0, atol=1e-6)
    np.testing.assert_allclose(inv, want_i, rtol=0, atol=1e-6 / n)
    exact_c, exact_i = (a.astype(np.float32).astype(np.float64)
                        for a in tplan.direct_dft_columns(n))
    assert np.abs(c - exact_c).max() <= 2.0**-22
    assert np.abs(inv - exact_i).max() <= 2.0**-22 * 2 / n
    hi_only = tab.copy()
    hi_only[..., 2:] = 0.0
    for got, exact in zip(_unpack_direct_tf32(n, hi_only), (exact_c, exact_i)):
        np.testing.assert_array_equal(got, tplan.tf32_split(exact)[0])


def test_tf32_split_rounds_as_the_tensor_cores_take_it():
    """tf32_split: hi the nearest TF32 value (ties away from zero), lo = x -
    hi rounded the same way, both with the low 13 bits clear, |x - hi - lo|
    <= 2^-22 |x|, on random values of every magnitude and on the ties."""
    rng = np.random.default_rng(16)
    x = (rng.standard_normal(4096) * np.exp2(rng.integers(-60, 60, 4096))).astype(np.float32)
    tie = (np.float32(1.0) + np.float32(2.0**-11)) * np.float32([1, -1])
    hi, lo = tplan.tf32_split(np.concatenate((x, tie)))
    assert not ((hi.view(np.uint32) | lo.view(np.uint32)) & np.uint32(0x1FFF)).any()
    ref = np.concatenate((x, tie)).astype(np.float64)
    assert np.all(np.abs(ref - hi) <= np.abs(ref) * 2.0**-11)
    assert np.all(np.abs(ref - hi - lo) <= np.abs(ref) * 2.0**-22)
    np.testing.assert_array_equal(hi[-2:], np.float32([1 + 2.0**-10, -1 - 2.0**-10]))


@pytest.mark.parametrize("n,length", [(16, 16), (256, 128), (512, 259)])
def test_direct_tf32_tables_give_the_conv(n, length):
    """The kernel's arithmetic on its tables, in f64 numpy: U = x C over the
    first L rows of C, Y = U K per column pair (columns 0 and 1 the real
    parts of X[0] and X[M] times Re K[0] and Re K[M]), y = Y I over the
    first L columns of I; against irfft(rfft(x, N) K)[:L] of torch.fft,
    within 1e-5 of the largest |y|."""
    m = n // 2
    rng = np.random.default_rng(n + length)
    x = rng.standard_normal((3, length))
    k_f = rng.standard_normal(m + 1) + 1j * rng.standard_normal(m + 1)
    c, inv = _unpack_direct_tf32(n, tplan.make_plan(n, torch.float32, device=CPU)
                                 .direct_tf32.numpy())
    u = x @ c[:length]
    y = np.empty_like(u)
    y[:, 0], y[:, 1] = u[:, 0] * k_f[0].real, u[:, 1] * k_f[m].real
    z = (u[:, 2::2] + 1j * u[:, 3::2]) * k_f[1:m]
    y[:, 2::2], y[:, 3::2] = z.real, z.imag
    got = y @ inv[:, :length]
    want = torch.fft.irfft(torch.fft.rfft(torch.from_numpy(x), n=n)
                           * torch.from_numpy(k_f), n=n)[:, :length].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n", [16, 64, 128])
def test_small_plans_match_jax_direct_path(n):
    """FFT sizes 16-128 run spectrum -> direct_conv in the port; the JAX
    package runs them through its 1-factor XLA direct path (L % 128 != 0 or
    N < 256 keeps its Pallas kernel out). Output and grads, f32, B = 3 and a
    ragged L."""
    jp = jff.make_plan(n, compute_dtype=jnp.float32)
    assert len(jp.factors) == 1
    rng = np.random.default_rng(n)
    u, k, gates = _conv_data(rng, 3, 5, n - 3, n // 2, True)
    dout = rng.standard_normal(u.shape).astype(np.float32)
    args = [jnp.asarray(a) for a in (u, k, *gates)]
    y_ref = _np(jff.fft_conv(jp, *args))
    g_ref = jax.grad(lambda *a: jnp.sum(jff.fft_conv(jp, *a) * dout), argnums=(0, 1, 2, 3))(*args)
    conv = FlashFFTConv(n, torch.float32, device=CPU)
    assert conv.plan.direct and "direct_roots" in conv.plan.tensors()
    assert tplan.default_factors(n) == {16: (8,), 64: (32,), 128: (8, 8)}[n]
    ts = [torch.from_numpy(a).requires_grad_() for a in (u, k, *gates)]
    y = conv(*ts)
    np.testing.assert_allclose(y.detach().numpy(), y_ref, atol=1e-4)
    y.backward(torch.from_numpy(dout))
    for name, t, r in zip("u k pre post".split(), ts, g_ref):
        r = _np(r)
        np.testing.assert_allclose(t.grad.numpy(), r, atol=1e-4 * max(1.0, float(np.abs(r).max())),
                                   err_msg=f"d{name}")


def test_fft_conv_function_takes_the_direct_path_on_cpu(monkeypatch):
    """FftConvFunction at N = 256 and 512 runs direct_conv forward and
    direct_conv_bwd + dk_finish backward; on the CPU the wrappers run
    direct_conv_plain and conv_bwd_plain (the plain version of the row-FFT
    backward that direct_conv_bwd launches on the card). The Monarch conv's
    wrappers never run there, and they do at N = 1024."""
    seen = []
    for mod, names in ((monarch, ("direct_conv_plain", "conv_with_spectrum", "conv_bwd_plain")),
                       (monarch_cuda, ("direct_conv", "direct_conv_bwd", "monarch_conv",
                                       "monarch_conv_bwd"))):
        for name in names:
            orig = getattr(mod, name)
            monkeypatch.setattr(
                mod, name, lambda *a, _o=orig, _n=name, **kw: (seen.append(_n), _o(*a, **kw))[1])
    g = torch.Generator().manual_seed(0)
    for n in (256, 512, 1024):
        seen.clear()
        p = tplan.make_plan(n, torch.float32, device=CPU)
        u = torch.randn(2, 3, n // 2, generator=g).requires_grad_()
        k = torch.randn(3, n // 2, generator=g).requires_grad_()
        y = monarch_cuda.fft_conv(p, u, k)
        y.square().sum().backward()
        ref = monarch.fft_conv_reference(n, u.detach(), k.detach())
        torch.testing.assert_close(y.detach(), ref, atol=2e-5 * float(ref.abs().max()), rtol=0)
        want = (["direct_conv", "direct_conv_plain", "direct_conv_bwd", "conv_bwd_plain"]
                if n <= tplan.DIRECT_MAX
                else ["monarch_conv", "conv_with_spectrum", "monarch_conv_bwd", "conv_bwd_plain"])
        assert seen == want, (n, seen)


def test_direct_wrappers_refuse_other_plans():
    """Plans above DIRECT_MAX carry no direct table and the direct path
    refuses them; gates come in pairs."""
    p = tplan.make_plan(1024, torch.float32, device=CPU)
    assert not p.direct and p.direct_roots is None and "direct_roots" not in p.tensors()
    u, k_f = torch.zeros(1, 2, 8), torch.zeros(2, 513, dtype=torch.complex64)
    with pytest.raises(ValueError, match="no direct plan"):
        monarch_cuda.direct_conv(p, u, k_f)
    with pytest.raises(ValueError, match="no direct plan"):
        monarch_cuda.direct_conv_bwd(p, u, k_f, None, None, u)
    with pytest.raises(ValueError, match="both"):
        monarch_cuda.direct_conv(tplan.make_plan(256, device=CPU), u, None, u, None)
    assert tplan.DIRECT_MAX == 512 and tplan.MIN_SEQLEN == 16


# --- M2-BERT modules against flax ------------------------------------------
