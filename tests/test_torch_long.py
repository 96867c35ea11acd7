"""Parity of the port's long FFT convolution (FFT sizes 65536 to 4194304)
with the JAX package, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX function
(its Pallas kernels ``_long_tiles``, ``_butterfly_tiles`` and
``_fwd_dft_tiles`` in interpret mode, as the JAX tests run them on the CPU)
and through the port, where each kernel wrapper (``butterfly``,
``long_conv_inner``, ``long_spectrum``) runs its plain version. Tolerances:
f32 convs at 1e-4 of max(1, largest |y|) (both sides are f32 FFT chains of
17 to 20 radix-2 levels; measured gap about 3e-7 of it); bf16 at the repo's
1e-2 with the kernel scaled so that |y| <= 0.5 (the JAX kernels round their
matmul operands to bf16 at every stage, the port rounds the f32 result
once); spectra and plain stages at 1e-5 of the largest |value| against
``torch.fft`` (f32 roundoff of a 2^19-point FFT is about 3e-7 of it).
The CUDA kernels are held against their plain versions on the card in
test_torch_gpu.py.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashfftconv_tpu as jff
import flashfftconv_tpu_torch as tff
from flashfftconv_tpu.ops import monarch_pallas as mp
from flashfftconv_tpu.ops import plan as jplan
from flashfftconv_tpu_torch.ops import _build, monarch, monarch_cuda
from flashfftconv_tpu_torch.ops import plan as tplan

CPU = "cpu"
# (FFT size, JAX factors): the default 3-factor plan reaches _long_tiles
# alone, the pinned 4-factor plan _butterfly_tiles and _long_tiles.
SIZES = {65536: None, 524288: (4, 4, 256, 128)}
LONG_SIZES = [2**e for e in range(16, 23)]


def _np(x):
    return np.array(x, np.float32)


def _conv_data(rng, n, b, h, length, gated, y_max=None):
    """Unit-normal inputs and gates, a kernel 0.1 * N(0, 1) * exp(-t/50);
    with y_max the kernel is rescaled so that the largest |output| is y_max."""
    u = rng.standard_normal((b, h, length)).astype(np.float32)
    k_len = n // 2
    k = (rng.standard_normal((h, k_len)) * 0.1 * np.exp(-np.arange(k_len) / 50)).astype(
        np.float32)
    gates = [rng.standard_normal((b, h, length)).astype(np.float32)
             for _ in range(2 if gated else 0)]
    if y_max is not None:
        y = jff.fft_conv_reference(n, *(jnp.asarray(a) for a in (u, k, *gates)))
        k = (k * (y_max / float(jnp.abs(y).max()))).astype(np.float32)
    return u, k, gates


def _jax_plan(n, dtype):
    plan = jff.make_plan(n, compute_dtype=dtype, factors=SIZES[n])
    assert mp.supported(plan) and len(plan.factors) == (3 if SIZES[n] is None else 4)
    return plan


# --- plan -----------------------------------------------------------------

@pytest.mark.parametrize("n", LONG_SIZES)
def test_make_plan_long_sizes(n):
    """Every size to 4M builds: an outer part of one or two factors, a band
    of at most MAX_BAND points with a plan of its own, exact tables."""
    p = tplan.make_plan(n, torch.float32, device=CPU)
    m = n // 2
    assert int(np.prod(p.factors)) == m and p.n_outer in (1, 2)
    assert p.outer * p.band == m and p.band <= tplan.MAX_BAND and p.outer <= tplan.MAX_OUTER
    assert p.sub.seqlen == 2 * p.band and p.sub.factors == p.factors[p.n_outer:]
    assert p.outer_tw.shape == (p.outer, p.band) and p.outer_roots.shape == (p.outer,)
    for k0, r in ((1, 1), (p.outer - 1, p.band - 1), (p.outer // 2, p.band // 3)):
        want = np.exp(-2j * np.pi * ((k0 * r) % m) / m)
        assert abs(complex(p.outer_tw[k0, r]) - want) < 1e-7
    assert abs(complex(p.split_tw[m // 2]) - (-1j)) < 1e-7
    q = p.with_tensors(p.tensors())
    assert q.factors == p.factors and q.sub.tw_flat is p.sub.tw_flat
    assert tplan.make_plan(n // 2 if n > 65536 else 32768, device=CPU).seqlen < n


def test_short_plans_are_unchanged():
    assert tplan.default_factors(32768) == (32, 32, 16)
    assert tplan.default_factors(16384) == (32, 16, 16)
    p = tplan.make_plan(16384, device=CPU)
    assert p.n_outer == 0 and p.sub is None and p.outer == 1 and len(p.tw) == 2
    assert set(p.tensors()) == {"tw_flat", "split_tw", "roots", "dft_0", "idft_0", "dft_1",
                                "idft_1", "dft_2", "idft_2"}


def test_bad_long_plans_raise():
    with pytest.raises(ValueError, match="no long plan"):
        tplan.make_plan(4194304, device=CPU, factors=(32, 32, 32, 32, 2))  # F = 1024
    with pytest.raises(ValueError, match="no long plan"):
        tplan.make_plan(2097152, device=CPU, factors=(4, 4, 4, 32, 32, 16))  # three outer stages
    with pytest.raises(ValueError, match="multiply"):
        tplan.make_plan(65536, device=CPU, factors=(8, 16, 16))
    with pytest.raises(ValueError):
        tplan.make_plan(8388608, device=CPU)


# --- the plain versions of the three kernels against torch.fft ---------------

@pytest.mark.parametrize("n,factors", [(65536, None), (131072, None), (524288, None),
                                       (131072, (4, 2, 32, 16, 16))])
def test_plain_long_stages_match_torch_fft(n, factors):
    """butterfly_plain then the band DFT is the M-point FFT; long_spectrum_plain
    is rfft; the chain butterfly -> long_conv_inner -> inverse butterfly is the
    convolution; rfft_plain / irfft_plain are valid at these sizes."""
    p = tplan.make_plan(n, torch.float32, device=CPU, factors=factors)
    m = n // 2
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((2, 3, m + 5)).astype(np.float32))
    k = torch.from_numpy((rng.standard_normal((3, m - 1)) * 0.05).astype(np.float32))
    bands = monarch.monarch_dft(p.sub, monarch.butterfly_plain(p, x))
    z_f = monarch._bands_to_natural(p, bands)
    ref = torch.fft.fft(monarch._pack(x, n))
    assert float((z_f - ref).abs().max()) < 1e-5 * float(ref.abs().max())
    k_f = monarch.long_spectrum_plain(p, k)
    ref = torch.fft.rfft(k, n=n)
    assert k_f.shape == (3, m + 1)
    assert float((k_f - ref).abs().max()) < 1e-5 * float(ref.abs().max())
    xf = torch.fft.rfft(x, n=n)
    assert float((monarch.rfft_plain(p, x) - xf).abs().max()) < 1e-5 * float(xf.abs().max())
    back = monarch.irfft_plain(p, xf.to(torch.complex64))[..., : m + 5]
    assert float((back - x).abs().max()) < 1e-5 * float(x.abs().max())
    z = monarch.long_conv_inner_plain(p, monarch.butterfly_plain(p, x), k_f)
    y = monarch.butterfly_inverse_plain(p, z, m + 5)
    ref = monarch.fft_conv_reference(n, x, k)
    assert float((y - ref).abs().max()) < 1e-5 * float(ref.abs().max())


# --- long_spectrum (kernel: _fwd_dft_tiles) ----------------------------------

@pytest.mark.parametrize("n", [65536, 524288])
def test_long_spectrum_matches_jax_forward_long_dft(n):
    """The port's long_spectrum wrapper (plain on the CPU) against the JAX
    package's _forward_long_dft at its default plan (_fwd_dft_tiles at 65536,
    _butterfly_tiles + _fwd_dft_tiles at 524288, interpret mode), brought to
    natural order with the JAX kf_unpermute; 1e-5 of the largest |X|."""
    h, k_len = 2, n // 2 - 3
    rng = np.random.default_rng(n)
    k = (rng.standard_normal((h, k_len)) * np.exp(-np.arange(k_len) / 200)).astype(np.float32)
    jp = jff.make_plan(n, compute_dtype=jnp.float32)
    fr, fi = mp._forward_long_dft(jp, jnp.asarray(k))
    full = _np(jplan.kf_unpermute(fr, jp.factors)) + 1j * _np(jplan.kf_unpermute(fi, jp.factors))
    p = tplan.make_plan(n, torch.float32, device=CPU)
    got = monarch_cuda.long_spectrum(p, torch.from_numpy(k))
    assert got.shape == (h, n // 2 + 1) and got.dtype == torch.complex64
    want = full[:, : n // 2 + 1]
    assert np.abs(got.numpy() - want).max() < 1e-5 * np.abs(want).max()


# --- fft_conv (kernels: _long_tiles, _butterfly_tiles) -----------------------

F32_CASES = [("ungated", 2), ("gated", 1), ("padded", 3), ("gated_padded", 3), ("ungated", 1)]


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


def test_long_conv_wrappers_compose_to_the_plain_conv():
    """long_conv (the chain of wrappers) equals conv_with_spectrum, the chain
    of plain stages, bit for bit on the CPU; in-place band conv included."""
    n = 65536
    p = tplan.make_plan(n, torch.float32, device=CPU)
    rng = np.random.default_rng(3)
    u, k, gates = (_conv_data(rng, n, 3, 2, n // 2 + 1, True))
    u, k, pre, post = (torch.from_numpy(a) for a in (u, k, *gates))
    k_f = monarch_cuda.long_spectrum(p, k)
    y = monarch_cuda.long_conv(p, u, k_f, pre, post)
    assert torch.equal(y, monarch.conv_with_spectrum(p, u, k_f, pre, post))
    z = monarch_cuda.butterfly(p, u, pre)
    assert z.shape == (3, 2, p.outer, p.band) and z.is_contiguous()
    z2 = monarch_cuda.long_conv_inner(p, z, k_f)
    assert monarch_cuda.long_conv_inner(p, z, k_f, out=z) is z and torch.equal(z, z2)
    y2 = monarch_cuda.butterfly(p, z2, post, inverse=True, length=u.shape[-1], dtype=u.dtype)
    assert torch.equal(y, y2)


def test_long_conv_grads_on_cpu_match_torch_fft():
    """The Function's backward on CPU tensors (the plain backward) is valid
    at long sizes: grads within 1e-5 of each grad's largest |value|."""
    n = 65536
    p = tplan.make_plan(n, torch.float32, device=CPU)
    rng = np.random.default_rng(4)
    u, k, gates = _conv_data(rng, n, 2, 2, n // 2, True)
    a = [torch.from_numpy(t).requires_grad_() for t in (u, k, *gates)]
    b = [torch.from_numpy(t).requires_grad_() for t in (u, k, *gates)]
    tff.fft_conv(p, *a).square().sum().backward()
    monarch.fft_conv_reference(n, *b).square().sum().backward()
    for x, y in zip(a, b):
        assert float((x.grad - y.grad).abs().max()) < 1e-5 * float(y.grad.abs().max())


# --- module ---------------------------------------------------------------

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


# --- the wrappers refuse what the kernels do not take ---------------------

def test_long_wrappers_refuse_bad_inputs():
    long_plan = tplan.make_plan(65536, torch.float32, device=CPU)
    short_plan = tplan.make_plan(4096, torch.float32, device=CPU)
    u = torch.zeros(1, 2, 100)
    k_f = torch.zeros(2, 32769, dtype=torch.complex64)
    with pytest.raises(ValueError, match="no outer part"):
        monarch_cuda.butterfly(short_plan, u)
    with pytest.raises(ValueError, match="no outer part"):
        monarch_cuda.long_spectrum(short_plan, torch.zeros(2, 100))
    with pytest.raises(ValueError, match="no outer part"):
        monarch_cuda.long_conv_inner(short_plan, torch.zeros(1, 2, 8, 256, dtype=torch.complex64),
                                     torch.zeros(2, 2049, dtype=torch.complex64))
    with pytest.raises(ValueError, match="outer part"):
        monarch_cuda._factor_args(long_plan)
    with pytest.raises(ValueError, match="both"):
        monarch_cuda.long_conv(long_plan, u, k_f, pregate=u)
    with pytest.raises(ValueError, match="input length"):
        tff.fft_conv(long_plan, torch.zeros(1, 2, 65537), torch.zeros(2, 10))
    with pytest.raises(ValueError, match="kernel length"):
        tff.fft_conv(long_plan, u, torch.zeros(2, 65537))


def test_long_wrappers_never_fall_back_to_the_cpu():
    """A tensor that is neither on the CPU nor on CUDA raises; without a
    card, asking for one raises instead of running the plain versions."""
    p = tplan.make_plan(65536, torch.float32, device=CPU)
    meta = torch.empty(1, 2, 100, device="meta")
    for call in (lambda: monarch_cuda.butterfly(p, meta),
                 lambda: monarch_cuda.long_spectrum(p, meta[0]),
                 lambda: monarch_cuda.long_conv_inner(
                     p, torch.empty(1, 2, 8, 4096, dtype=torch.complex64, device="meta"),
                     torch.empty(2, 32769, dtype=torch.complex64, device="meta"))):
        with pytest.raises(ValueError, match="CPU or all on CUDA"):
            call()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tff.FlashFFTConv(131072)
        with pytest.raises(RuntimeError, match="CUDA"):
            tplan.get_plan(2097152, torch.bfloat16)


# --- the ctypes signatures agree with the C sources -----------------------

@pytest.mark.parametrize("lib,fn", [(lib, fn) for lib, fns in _build.SIGNATURES.items()
                                    for fn in fns])
def test_ctypes_signature_matches_c_source(lib, fn):
    """A wrong count passes a pointer as a 32-bit int: hold every declared
    argtypes list to the extern "C" declaration in csrc/."""
    src = (_build.SOURCE_DIR / f"{lib}.cu").read_text()
    m = re.search(r'extern "C" int ' + fn + r"\((.*?)\)\s*\{", src, re.S)
    assert m, f"{fn} not found in {lib}.cu"
    want = []
    for arg in m.group(1).split(","):
        arg = " ".join(arg.split())
        want.append(_build._P if "*" in arg else _build._I)
        assert "*" in arg or arg.startswith("int "), arg
    assert _build.SIGNATURES[lib][fn] == want
