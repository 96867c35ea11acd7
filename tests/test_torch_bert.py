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

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flashfftconv_tpu as jff
from flashfftconv_tpu.models import bert as jbert
from flashfftconv_tpu.models import m2_bert as jm2
from flashfftconv_tpu.ops import monarch_pallas as mp
from flashfftconv_tpu.utils import checkpoint_import as jci
from flashfftconv_tpu_torch import FlashFFTConv
from flashfftconv_tpu_torch.models import bert as tbert
from flashfftconv_tpu_torch.models import m2_bert as tm2
from flashfftconv_tpu_torch.ops import monarch, monarch_cuda
from flashfftconv_tpu_torch.ops import plan as tplan
from flashfftconv_tpu_torch.utils import checkpoint_import as tci
from flashfftconv_tpu_torch.utils import data, jax_weights, metrics, optim, train

CPU = "cpu"
ROOT = Path(__file__).resolve().parent.parent


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

def _init(model, *args, **kw):
    params = model.init(jax.random.PRNGKey(0), *args, **kw)["params"]
    return params, jax.tree_util.tree_map(np.asarray, params)


def _assert_grads_match(jax_grads: dict, model, tol=1e-4):
    """Every parameter's grad against jax's; a parameter that the forward
    never reads (the filters' skip bias, which only the Hyena operator uses;
    an unused token-type table) has no grad here and a zero one there."""
    assert set(jax_grads) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        ref = jax_grads[name].numpy()
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        err = float(np.abs(grad.numpy() - ref).max())
        assert err <= tol * float(np.abs(ref).max()) + 1e-7, (name, err, float(np.abs(ref).max()))


@pytest.mark.parametrize("nblocks,bias", [(4, True), (2, False)])
def test_blockdiag_linear_matches_flax(nblocks, bias):
    x = np.random.default_rng(nblocks).standard_normal((2, 5, 16)).astype(np.float32)
    jm = jm2.BlockdiagLinear(24, nblocks=nblocks, use_bias=bias)
    params, pnp = _init(jm, jnp.asarray(x))
    dout = np.random.default_rng(1).standard_normal((2, 5, 24)).astype(np.float32)
    ref = _np(jm.apply({"params": params}, jnp.asarray(x)))
    gp = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * dout))(params)
    tm = tm2.BlockdiagLinear(16, 24, nblocks=nblocks, bias=bias, device=CPU)
    tm.load_state_dict({k: torch.from_numpy(_np(v)) for k, v in pnp.items()}, strict=True)
    y = tm(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), ref, atol=1e-5)
    (y * torch.from_numpy(dout)).sum().backward()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(gp[name]), atol=1e-5)
    w = tm.weight.detach()
    dense = torch.block_diag(*w.unbind(0))
    np.testing.assert_allclose(tm2.blockdiag_multiply(torch.from_numpy(x), w).numpy(),
                               x @ dense.numpy().T, atol=1e-5)
    with pytest.raises(ValueError):
        tm2.BlockdiagLinear(10, 24, nblocks=4, device=CPU)


MIXER = dict(d_model=32, l_max=128)


@pytest.mark.parametrize("bidirectional,residual,inference", [
    (b, r, i) for b in (False, True) for r in (False, True) for i in (False, True)])
def test_m2_mixer_matches_flax(bidirectional, residual, inference):
    """Output and every grad of the f32 mixer (the JAX side's convs through
    _direct_fused_io_tiles and its backward in interpret mode)."""
    kw = dict(bidirectional=bidirectional, residual_long_conv=residual, inference_mode=inference)
    jm = jm2.MonarchMixerSequenceMixing(**MIXER, **kw, conv_dtype=jnp.float32, impl="pallas")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 128, 32)).astype(np.float32)
    dout = rng.standard_normal((2, 128, 32)).astype(np.float32)
    params, pnp = _init(jm, jnp.asarray(x))
    ref = _np(jm.apply({"params": params}, jnp.asarray(x)))
    gp, gx = jax.grad(lambda p, a: jnp.sum(jm.apply({"params": p}, a) * dout),
                      argnums=(0, 1))(params, jnp.asarray(x))
    tm = tm2.MonarchMixerSequenceMixing(**MIXER, **kw, conv_dtype=torch.float32, device=CPU)
    sd = jax_weights.m2_mixer_state_dict(pnp)
    tm.load_state_dict(sd, strict=True)
    tx = torch.from_numpy(x).requires_grad_()
    y = tm(tx)
    np.testing.assert_allclose(y.detach().numpy(), ref, atol=1e-4 * float(np.abs(ref).max()))
    (y * torch.from_numpy(dout)).sum().backward()
    _assert_grads_match(
        jax_weights.m2_mixer_state_dict(jax.tree_util.tree_map(np.asarray, gp)), tm)
    gx = _np(gx)
    np.testing.assert_allclose(tx.grad.numpy(), gx, atol=1e-4 * float(np.abs(gx).max()))


LM = dict(vocab_size=64, d_model=32, n_layer=2, d_inner=64, l_max=128)
LM_CASES = {
    "untied_blockdiag": dict(mlp_nblocks=4),
    "tied_dense": dict(mlp_nblocks=0, tie_mlm_head=True),
    "ref_structure": dict(mlp_nblocks=4, ref_structure=True),
    "glu_dense": dict(mlp_nblocks=0, use_glu_mlp=True, tie_mlm_head=True),
    "attention_mask": dict(mlp_nblocks=0),
}


def _lm_pair(case):
    kw = LM_CASES[case]
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 64, (2, 128))
    extra = {}
    if case == "attention_mask":
        mask = np.ones((2, 128), np.int32)
        mask[1, 100:] = 0
        extra = dict(token_type_ids=rng.integers(0, 2, (2, 128)), attention_mask=mask)
    jm = jbert.M2BertForMaskedLM(**LM, **kw, dropout=0.0, conv_dtype=jnp.float32, impl="pallas")
    params, pnp = _init(jm, jnp.asarray(ids), **{k: jnp.asarray(v) for k, v in extra.items()})
    tm = tbert.M2BertForMaskedLM(**LM, **kw, conv_dtype=torch.float32, device=CPU).eval()
    sd = jax_weights.m2_bert_state_dict(pnp)
    if "token_type_ids" not in extra:  # a table the flax model never used has no params
        sd["bert.token_type_embeddings.weight"] = tm.bert.token_type_embeddings.weight.detach()
    tm.load_state_dict(sd, strict=True)
    return jm, params, tm, ids, extra


@pytest.mark.parametrize("case", list(LM_CASES))
def test_m2_bert_mlm_logits_and_grads_match_flax(case):
    """A 2-layer f32 M2BertForMaskedLM: logits at 2e-3 and the masked-LM
    loss's grads (labels -100 off the masked positions), every parameter at
    5e-4 of its largest |grad| (module docstring)."""
    jm, params, tm, ids, extra = _lm_pair(case)
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}
    ref = _np(jm.apply({"params": params}, jnp.asarray(ids), **jextra))
    logits = tm(torch.from_numpy(ids), **textra)
    assert logits.dtype == torch.float32 and logits.shape == (2, 128, 64)
    np.testing.assert_allclose(logits.detach().numpy(), ref, atol=2e-3)
    labels = np.where(np.random.default_rng(5).random(ids.shape) < 0.15, ids, -100)

    def jloss(p):
        lg = jm.apply({"params": p}, jnp.asarray(ids), **jextra)
        m = (labels >= 0).astype(jnp.float32)
        logp = jax.nn.log_softmax(lg)
        nll = -jnp.take_along_axis(logp, jnp.maximum(labels, 0)[..., None], -1)[..., 0]
        return (nll * m).sum() / jnp.maximum(m.sum(), 1.0)

    loss, grads = jax.value_and_grad(jloss)(params)
    got = metrics.cross_entropy(logits, torch.from_numpy(labels), -100)
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= 1e-5 * float(loss)
    jg = jax_weights.m2_bert_state_dict(jax.tree_util.tree_map(np.asarray, grads))
    if case != "attention_mask":
        jg["bert.token_type_embeddings.weight"] = torch.zeros_like(
            tm.bert.token_type_embeddings.weight)
    _assert_grads_match(jg, tm, tol=5e-4)


@pytest.mark.parametrize("tie", [False, True])
def test_m2_bert_flax_paths_invert_the_key_map(tie):
    """flax_paths(model)[name] leads, in the flax tree, to the leaf that
    m2_bert_state_dict puts under name (transposed for Dense kernels), and
    the optimizer's labels follow the JAX package's."""
    from flashfftconv_tpu.utils import optim as joptim

    jm = jbert.M2BertForMaskedLM(**LM, tie_mlm_head=tie, conv_dtype=jnp.float32, impl="xla")
    ids = jnp.zeros((1, 128), jnp.int32)
    _, pnp = _init(jm, ids, token_type_ids=ids)
    tm = tbert.M2BertForMaskedLM(**LM, tie_mlm_head=tie, conv_dtype=torch.float32, device=CPU)

    def paths(tree, prefix=()):
        if not isinstance(tree, dict):
            return {prefix: tree}
        return {k: v for name, sub in tree.items() for k, v in paths(sub, prefix + (name,)).items()}

    leaves = paths(pnp)
    sd = jax_weights.m2_bert_state_dict(pnp)
    fp = jax_weights.flax_paths(tm)
    assert set(fp) == set(sd) and sorted(fp.values()) == sorted(leaves)
    for name, path in fp.items():
        leaf = np.asarray(leaves[path], np.float32)
        np.testing.assert_array_equal(leaf.T if path[-1] == "kernel" else leaf, sd[name].numpy())
    jlabels = paths(joptim.label_params(pnp, joptim.kernel_label_fn))
    assert {fp[n]: lab for n, lab in optim.label_params(tm).items()} == jlabels


def _example_module():
    """examples/bert/train.py as a module (its PRESETS and mlm_batch)."""
    spec = importlib.util.spec_from_file_location("examples_bert_train",
                                                  ROOT / "examples" / "bert" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_m2_bert_preset_and_fill_mask():
    """base-110M is the example's preset (110M parameters with the tied
    head); fill_mask answers requests in eval mode and restores the mode."""
    ex = _example_module().PRESETS["base-110M"]
    mine = tbert.PRESETS["base-110M"]
    assert {k: mine[k] for k in ex} == ex and mine["d_inner"] == 4 * mine["d_model"]
    with torch.device("meta"):
        big = tbert.M2BertForMaskedLM(**{k: v for k, v in mine.items() if k != "batch_size"},
                                      device="meta")
    assert 109e6 < sum(p.numel() for p in big.parameters()) < 111e6
    model = tbert.build_model("base-110M", dtype=torch.float32, device=CPU, n_layer=1,
                              d_model=32, d_inner=64, vocab_size=300,
                              generator=torch.Generator().manual_seed(0)).train()
    ids = torch.randint(0, 256, (3, 40), generator=torch.Generator().manual_seed(1))
    labels = torch.full_like(ids, -100)
    labels[:, ::5] = ids[:, ::5]
    out = tbert.fill_mask(model, ids.masked_fill(labels >= 0, data.MASK_ID), labels)
    assert model.training and bool(out["finite"])
    assert out["top1"].shape == (3, 40) and out["accuracy"].shape == (3,)
    assert bool(((out["accuracy"] >= 0) & (out["accuracy"] <= 1)).all())


def _reference_m2_state(rng, n_layer=2, d=16, d_inner=32, vocab=40, l_max=32, order=16,
                        nblocks=4):
    """A state dict shaped like the reference M2-BERT checkpoint (bidirectional
    filters, residual long conv, block-diagonal MLP), random values."""
    r = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    state = {
        "bert.embeddings.word_embeddings.weight": r(vocab, d),
        "bert.embeddings.position_embeddings.weight": r(l_max, d),
        "bert.embeddings.token_type_embeddings.weight": r(2, d),
        "bert.embeddings.LayerNorm.weight": r(d), "bert.embeddings.LayerNorm.bias": r(d),
        "bert.embeddings.position_ids": torch.arange(l_max)[None],
        "bert.pooler.dense.weight": r(d, d),
        "cls.predictions.transform.dense.weight": r(d, d),
        "cls.predictions.transform.dense.bias": r(d),
        "cls.predictions.transform.LayerNorm.weight": r(d),
        "cls.predictions.transform.LayerNorm.bias": r(d),
        "cls.predictions.decoder.weight": r(vocab, d), "cls.predictions.bias": r(vocab),
    }
    for i in range(n_layer):
        a = f"model.bert.encoder.layer.{i}.attention"
        state.update({f"{a}.in_linear.weight": r(3 * d, d), f"{a}.in_linear.bias": r(3 * d),
                      f"{a}.short_filter.weights": r(3 * d, 3), f"{a}.short_filter.bias": r(3 * d),
                      f"{a}.out_linear.weight": r(d, d), f"{a}.out_linear.bias": r(d)})
        for fn in ("filter_fn", "filter_fn2"):
            state.update({f"{a}.{fn}.bias": r(d), f"{a}.{fn}.modulation.deltas": r(1, 1, d),
                          f"{a}.{fn}.pos_emb.z": r(1, l_max, 5),
                          f"{a}.{fn}.pos_emb.t": r(1, l_max, 1)})
            for seq in ("implicit_filter", "implicit_filter_rev"):
                shapes = [(order, 5), None, (order, order), None, (order, order), None, (d, order)]
                for j, shape in enumerate(shapes):
                    key = f"{a}.{fn}.{seq}.{j}"
                    if shape is None:
                        state[f"{key}.freq"] = r(1, order)
                    else:
                        state[f"{key}.weight"] = r(*shape)
                        if j < 6:
                            state[f"{key}.bias"] = r(shape[0])
        m = f"model.bert.encoder.layer.{i}.mlp"
        state.update({f"{m}.gated_layers.weight": r(nblocks, d_inner // nblocks, d // nblocks),
                      f"{m}.gated_layers.bias": r(d_inner),
                      f"{m}.wo.weight": r(nblocks, d // nblocks, d_inner // nblocks),
                      f"{m}.wo.bias": r(d), f"{m}.layernorm.weight": r(d),
                      f"{m}.layernorm.bias": r(d)})
    return state


def test_m2_bert_import_matches_the_jax_import():
    """import_m2_bert_state_dict gives, under the port's names, exactly the
    weights that the JAX import puts in the flax tree (mapped by
    m2_bert_state_dict), skips the same keys, loads into
    M2BertForMaskedLM(ref_structure=True) and, through
    blockdiag_to_dense_mlp, into a dense-MLP model as the JAX conversion
    does."""
    state = _reference_m2_state(np.random.default_rng(0))
    jtree, jrep = jci.import_m2_bert_state_dict(state)
    tensors, rep = tci.import_m2_bert_state_dict(state)
    # (the JAX report names a filter's shared keys once for each of its two MLPs)
    assert sorted(rep.skipped) == sorted(set(jrep.skipped))
    assert sorted(rep.used) == sorted(set(jrep.used))
    cfg = dict(vocab_size=40, d_model=16, n_layer=2, d_inner=32, l_max=32, mlp_nblocks=4,
               ref_structure=True, conv_dtype=jnp.float32, impl="xla")
    jm = jbert.M2BertForMaskedLM(**cfg)
    ids = jnp.zeros((1, 32), jnp.int32)
    init = jm.init(jax.random.PRNGKey(0), ids, token_type_ids=ids)["params"]
    merged = jax.tree_util.tree_map(np.asarray, jci.merge_params(init, jtree))
    want = jax_weights.m2_bert_state_dict(merged)
    for name, t in tensors.items():
        if not name.endswith("modulation.deltas"):
            np.testing.assert_array_equal(t.numpy(), want[name].numpy(), err_msg=name)
    tcfg = {**cfg, "conv_dtype": torch.float32}
    del tcfg["impl"]
    model = tbert.M2BertForMaskedLM(**tcfg, device=CPU)
    report = tci.ImportReport()
    tci.load_into(model, tensors, report)
    # only the reverse filters' skip biases, which the mixer never reads
    assert set(report.missing) == {f"bert.layer.{i}.mixer.{f}_rev.bias" for i in range(2)
                                   for f in ("filter", "filter2")}
    dense = tci.blockdiag_to_dense_mlp(tensors)
    jdense = jax_weights.m2_bert_state_dict(
        jax.tree_util.tree_map(np.asarray, jci.blockdiag_to_dense_mlp(merged)))
    for name in ("bert.layer.0.mlp_fc1.weight", "bert.layer.1.mlp_fc2.weight"):
        assert dense[name].ndim == 2
        np.testing.assert_array_equal(dense[name].numpy(), jdense[name].numpy())
    model = tbert.M2BertForMaskedLM(**{**tcfg, "mlp_nblocks": 0}, device=CPU)
    tci.load_into(model, dense)


def test_bert_train_steps_match_the_example_optax_chain():
    """Three steps of the examples/bert chain (clip_by_global_norm(1.0), then
    adamw(8e-4, weight_decay=1e-5) on every parameter), its masked-LM loss
    and accuracy, on mlm_batches of the same seed, dropout off: losses
    within 1e-4 relative, accuracies equal, parameters within 2 * lr * steps."""
    lr, steps = 8e-4, 3
    cfg = dict(vocab_size=260, d_model=32, n_layer=2, d_inner=64, l_max=128, mlp_nblocks=0,
               tie_mlm_head=True)
    jm = jbert.M2BertForMaskedLM(**cfg, dropout=0.0, conv_dtype=jnp.float32, impl="xla")
    tokens = np.random.default_rng(2).integers(0, 256, 20_000).astype(np.int32)
    batches = data.mlm_batches(tokens, 2, 128, np.random.default_rng(5))
    xs = [next(batches) for _ in range(steps)]
    params, pnp = _init(jm, jnp.asarray(xs[0][0]))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr, weight_decay=1e-5))
    opt_state = tx.init(params)

    @jax.jit
    def jstep(params, opt_state, x, labels):
        def loss_fn(p):
            logits = jm.apply({"params": p}, x, deterministic=True)
            m = (labels >= 0).astype(jnp.float32)
            logp = jax.nn.log_softmax(logits.astype(jnp.float32))
            nll = -jnp.take_along_axis(logp, jnp.maximum(labels, 0)[..., None], -1)[..., 0]
            loss = (nll * m).sum() / jnp.maximum(m.sum(), 1.0)
            acc = ((logits.argmax(-1) == labels).astype(jnp.float32) * m).sum() / jnp.maximum(
                m.sum(), 1.0)
            return loss, acc

        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, acc

    jout = []
    for x, y in xs:
        params, opt_state, loss, acc = jstep(params, opt_state, jnp.asarray(x), jnp.asarray(y))
        jout.append((float(loss), float(acc)))
    tm = tbert.M2BertForMaskedLM(**cfg, conv_dtype=torch.float32, device=CPU).eval()
    sd = jax_weights.m2_bert_state_dict(pnp)
    sd["bert.token_type_embeddings.weight"] = tm.bert.token_type_embeddings.weight.detach()
    tm.load_state_dict(sd, strict=True)
    opt = train.bert_optimizer(tm)
    assert opt.defaults["lr"] == lr and opt.defaults["weight_decay"] == 1e-5
    assert len(opt.param_groups) == 1 and len(opt.param_groups[0]["params"]) == len(
        list(tm.parameters()))
    step = train.make_train_step(tm, opt, None, clip=1.0, loss_fn=train.mlm_loss)
    out = [step(torch.from_numpy(x), torch.from_numpy(y)) for x, y in xs]
    np.testing.assert_allclose([float(o["loss"]) for o in out], [j[0] for j in jout], rtol=1e-4)
    np.testing.assert_allclose([float(o["accuracy"]) for o in out], [j[1] for j in jout],
                               atol=1e-6)
    want = jax_weights.m2_bert_state_dict(jax.tree_util.tree_map(np.asarray, params))
    for name, p in tm.named_parameters():
        if name in want:
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       atol=2 * lr * steps, err_msg=name)


@pytest.mark.parametrize("batch,seq_len,prob", [(4, 128, 0.15), (3, 37, 0.5)])
def test_mlm_batches_match_the_example(batch, seq_len, prob):
    """The same generator gives the example's mlm_batch, batch after batch:
    masked positions hold id 256 and their labels the true ids, -100
    elsewhere."""
    ex = _example_module()
    tokens = np.random.default_rng(0).integers(0, 256, 5000).astype(np.int32)
    mine = data.mlm_batches(tokens, batch, seq_len, np.random.default_rng(7), mask_prob=prob)
    rng = np.random.default_rng(7)
    assert data.MASK_ID == ex.MASK_ID
    for _ in range(3):
        x, y = next(mine)
        rx, ry = ex.mlm_batch(tokens, batch, seq_len, prob, rng)
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)
        assert x.shape == (batch, seq_len) and ((x == data.MASK_ID) == (y >= 0)).all()
