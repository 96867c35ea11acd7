"""Parity of the PyTorch port's ops (flashfftconv_tpu_torch) with the JAX package.

The same inputs, made from a seed with numpy, go through the JAX function
(its Pallas kernels in interpret mode, as the JAX tests run them on the CPU,
or its oracle) and through the port on the CPU, where each kernel wrapper
runs its plain version. Tolerances: f32 paths at atol 1e-4 on outputs of
order 1 to 10 (both sides are f32 FFT chains; the measured gap is ~3e-6);
bf16 paths at the repo's 1e-2, with the kernel scaled so that |y| <= 0.5
(the JAX kernels round their matmul operands to bf16 at every stage and
land one or two bf16 ulps, <= 4e-3 each at |y| <= 0.5, from the f32 result
that the port rounds once).
Grads: the port's ``FftConvFunction`` and ``DepthwiseFunction`` on the CPU
(their plain backward) against ``jax.grad`` through the JAX package's
backward kernels in interpret mode (``_bwd_fused_io_tiles``,
``_pallas_depthwise_bwd``). f32 grads at atol 1e-4 on grads of order 1; dk
sums B*L products and reaches a few hundred here, so each grad is held to
1e-4 of max(1, its largest |value|) (measured: 4e-7 of it). bf16 grads at
the repo's 1e-2 of the same scale, with outputs scaled to |y| <= 0.5.
The CUDA kernels are held against their plain versions on the card in
test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashfftconv_tpu as jff
import flashfftconv_tpu_torch as tff
from flashfftconv_tpu.ops import depthwise as jdw
from flashfftconv_tpu.ops import monarch_pallas
from flashfftconv_tpu.ops import plan as jplan
from flashfftconv_tpu_torch.ops import depthwise as tdw
from flashfftconv_tpu_torch.ops import dispatch, monarch, monarch_cuda
from flashfftconv_tpu_torch.ops import plan as tplan

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

CPU = "cpu"


def _np(x):
    return np.array(x, np.float32)


def _conv_data(rng, b, h, length, k_len, gated, y_max=None):
    """Unit-normal inputs and gates, a kernel 0.1 * N(0, 1) * exp(-t/50);
    with y_max the kernel is rescaled so that the largest |output| is y_max."""
    u = rng.standard_normal((b, h, length)).astype(np.float32)
    k = (rng.standard_normal((h, k_len)) * 0.1 * np.exp(-np.arange(k_len) / 50)).astype(
        np.float32
    )
    gates = [rng.standard_normal((b, h, length)).astype(np.float32)
             for _ in range(2 if gated else 0)]
    if y_max is not None:
        y = jff.fft_conv_reference(2 * max(length, k_len), *(jnp.asarray(a) for a in (u, k, *gates)))
        k = (k * (y_max / float(jnp.abs(y).max()))).astype(np.float32)
    return u, k, gates


# --- plan -----------------------------------------------------------------

@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096, 8192, 16384, 32768])
def test_default_factors_cover_sizes(n):
    f = tplan.default_factors(n)
    assert int(np.prod(f)) == n // 2
    assert all(2 <= x <= tplan.MAX_FACTOR and x & (x - 1) == 0 for x in f)


@pytest.mark.parametrize("n", [8, 1000, 8388608])
def test_unsupported_seqlen_raises(n):
    with pytest.raises(ValueError):
        tplan.make_plan(n, device=CPU)


def test_tables_are_exact_dft():
    p = tplan.make_plan(4096, torch.float32, device=CPU)
    for j, f in enumerate(p.factors):
        np.testing.assert_allclose(p.dft[j].numpy(), np.fft.fft(np.eye(f), axis=0), atol=1e-6)
        inv = np.fft.ifft(np.eye(f), axis=0) * f / (p.inner if j == 0 else 1)
        np.testing.assert_allclose(p.idft[j].numpy(), inv, atol=1e-6)
    k = np.arange(p.inner + 1)
    np.testing.assert_allclose(p.split_tw.numpy(), np.exp(-2j * np.pi * k / 4096), atol=1e-6)


@pytest.mark.parametrize("n", [256, 2048, 32768])
def test_monarch_dft_matches_fft(n):
    p = tplan.make_plan(n, torch.float32, device=CPU)
    rng = np.random.default_rng(n)
    z = torch.from_numpy((rng.standard_normal((3, n // 2)) + 1j * rng.standard_normal(
        (3, n // 2))).astype(np.complex64))
    got = tplan.kf_unpermute(monarch.monarch_dft(p, z), p.factors)
    ref = torch.fft.fft(z)
    assert float((got - ref).abs().max()) < 1e-5 * float(ref.abs().max())
    back = monarch.monarch_idft(p, monarch.monarch_dft(p, z))
    assert float((back - z).abs().max()) < 1e-5


@pytest.mark.parametrize("n", [256, 4096])
def test_rfft_irfft_plain_match_torch_fft(n):
    p = tplan.make_plan(n, torch.float32, device=CPU)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 5, n - 7)).astype(np.float32))
    ref = torch.fft.rfft(x, n=n)
    assert float((monarch.rfft_plain(p, x) - ref).abs().max()) < 1e-5 * float(ref.abs().max())
    y = torch.fft.irfft(ref, n=n)
    assert float((monarch.irfft_plain(p, ref.to(torch.complex64)) - y).abs().max()) < 1e-5


def test_kf_permute_roundtrip_matches_jax():
    x = np.arange(2 * 4096, dtype=np.float32).reshape(2, 4096)
    for factors in [(32, 128), (16, 16, 16)]:
        got = tplan.kf_permute(torch.from_numpy(x), factors).numpy()
        np.testing.assert_array_equal(got, np.asarray(jplan.kf_permute(jnp.asarray(x), factors)))
        np.testing.assert_array_equal(tplan.kf_unpermute(torch.from_numpy(got), factors).numpy(), x)


# --- spectrum (kernel: _spectrum_tiles) -----------------------------------

@pytest.mark.parametrize("n", [1024, 4096])
def test_spectrum_matches_jax_spectrum_tiles(n):
    """The port's spectrum wrapper (plain on the CPU) against the JAX kernel
    _spectrum_tiles, called directly so it runs in interpret mode; compared
    in natural order through the plan's unpermute."""
    h, k_len = 8, n // 2
    rng = np.random.default_rng(n)
    k = (rng.standard_normal((h, k_len)) * np.exp(-np.arange(k_len) / 200)).astype(np.float32)
    jp = jff.make_plan(n, compute_dtype=jnp.float32)
    n1, n2 = jp.factors
    k4 = jnp.pad(jnp.asarray(k), ((0, 0), (0, n - k_len))).reshape(h, n1, n2)
    re, im = monarch_pallas._spectrum_tiles(
        k4, jp.dft_re[0], jp.dft_im[0], jp.tw_re[0], jp.tw_im[0], jp.dft_re[1], jp.dft_im[1],
        plan_factors=jp.factors, compute_dtype="float32", out_dtype="float32",
    )
    full = tplan.kf_unpermute(torch.complex(torch.from_numpy(_np(re)), torch.from_numpy(_np(im))),
                              jp.factors)
    p = tplan.make_plan(n, torch.float32, device=CPU)
    got = monarch_cuda.spectrum(p, torch.from_numpy(k))
    assert got.shape == (h, n // 2 + 1) and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), full[:, : n // 2 + 1].numpy(), atol=1e-4)


# --- monarch_conv (kernel: _conv_fused_io_tiles) --------------------------


@pytest.mark.parametrize("b,h,length,k_len", [(3, 5, 301, 77), (1, 1, 1024, 1024), (5, 3, 1, 4)])
def test_conv_any_shape(b, h, length, k_len):
    """Odd B, ragged H and any L <= N, which the JAX fused kernel sends to
    its fallback: the port's path against the JAX fft oracle."""
    n = 1024
    u, k, gates = _conv_data(np.random.default_rng(7), b, h, length, k_len, True)
    y_ref = _np(jff.fft_conv_reference(n, *(jnp.asarray(a) for a in (u, k, *gates))))
    p = tplan.make_plan(n, torch.float32, device=CPU)
    got = tff.fft_conv(p, *(torch.from_numpy(a) for a in (u, k, *gates)))
    np.testing.assert_allclose(got.numpy(), y_ref, atol=1e-4)


def test_conv_reference_matches_jax_reference():
    u, k, gates = _conv_data(np.random.default_rng(3), 2, 4, 700, 300, True)
    y_ref = _np(jff.fft_conv_reference(2048, *(jnp.asarray(a) for a in (u, k, *gates))))
    got = tff.fft_conv_reference(2048, *(torch.from_numpy(a) for a in (u, k, *gates)))
    np.testing.assert_allclose(got.numpy(), y_ref, atol=1e-6)


def test_module_matches_jax_module():
    u, k, gates = _conv_data(np.random.default_rng(4), 2, 6, 1000, 1000, True)
    jconv = jff.FlashFFTConv(2048, dtype=jnp.float32)
    tconv = tff.FlashFFTConv(2048, dtype=torch.float32, device=CPU)
    for args in [(u, k), (u, k, *gates)]:
        ref = _np(jconv(*(jnp.asarray(a) for a in args)))
        got = tconv(*(torch.from_numpy(a) for a in args)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4)
    assert sorted(dict(tconv.named_buffers())) == sorted(tconv.plan.tensors())
    with pytest.raises(ValueError):
        tconv(torch.from_numpy(u), torch.from_numpy(k), torch.from_numpy(gates[0]))


def test_plain_path_is_differentiable_on_cpu():
    p = tplan.make_plan(512, torch.float32, device=CPU)
    g = torch.Generator().manual_seed(0)
    u = (torch.randn(2, 3, 256, generator=g) * 0.1).requires_grad_()
    k = (torch.randn(3, 256, generator=g) * 0.1).requires_grad_()
    loss = tff.fft_conv(p, u, k).square().sum()
    loss.backward()
    u2, k2 = u.detach().requires_grad_(), k.detach().requires_grad_()
    tff.fft_conv_reference(512, u2, k2).square().sum().backward()
    torch.testing.assert_close(u.grad, u2.grad, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(k.grad, k2.grad, atol=1e-4, rtol=1e-4)


def test_dispatch_routes_and_errors():
    """Every route gives the oracle's output within 2e-5 of its largest
    |y| (f32 FFT roundoff, as chip_smoke.f32_tol), on seeded inputs. 'auto'
    on the CPU runs FftConvFunction over the plain versions; 'plain' is
    fft_conv_plain under torch's autograd, and both give the same grads."""
    p = tplan.make_plan(512, torch.float32, device=CPU)
    g = torch.Generator().manual_seed(0)
    u, k = torch.randn(1, 2, 256, generator=g), torch.randn(2, 256, generator=g)
    assert dispatch.resolve_impl(u, "auto") == "cpu"
    before = (monarch_cuda.spectrum.launches, monarch_cuda.monarch_conv.launches)
    ref = tff.fft_conv_reference(512, u, k)
    grads = {}
    for impl in ("auto", "plain", "fft"):
        uu = u.clone().requires_grad_()
        y = dispatch.fft_conv(p, uu, k, impl=impl)
        torch.testing.assert_close(y, ref, atol=2e-5 * float(ref.abs().max()), rtol=0)
        assert (type(y.grad_fn).__name__ == "FftConvFunctionBackward") == (impl == "auto")
        grads[impl] = torch.autograd.grad(y, uu, ref)[0]
    torch.testing.assert_close(grads["auto"], grads["plain"],
                               atol=2e-5 * float(grads["fft"].abs().max()), rtol=0)
    assert (monarch_cuda.spectrum.launches, monarch_cuda.monarch_conv.launches) == before
    with pytest.raises(ValueError, match="cuda"):
        dispatch.fft_conv(p, u, k, impl="cuda")
    with pytest.raises(ValueError):
        dispatch.fft_conv(p, u, k, impl="pallas")
    with pytest.raises(ValueError, match="together|both"):
        dispatch.fft_conv(p, u, k, pregate=u)
    with pytest.raises(ValueError):
        dispatch.fft_conv(p, torch.randn(1, 2, 513), k)


def test_entry_points_default_to_cuda():
    """Without a card, every entry point that defaults to CUDA raises; it
    never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel

    for make in (
        lambda: tplan.make_plan(1024),
        lambda: tff.FlashFFTConv(1024),
        lambda: tff.FlashDepthWiseConv1d(8, 3, 1),
        lambda: ConvLMHeadModel(d_model=8, n_layer=1, d_inner=16, vocab_size=16, l_max=128),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


# --- backward (kernels: _bwd_fused_io_tiles, _pallas_depthwise_bwd) ------

def _assert_grads_close(got, ref, tol, names):
    for name, a, r in zip(names, got, ref):
        a, r = np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32), _np(r)
        np.testing.assert_allclose(a, r, atol=tol * max(1.0, float(np.abs(r).max())),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("b,h,length,k_len,gated", [
    (3, 5, 301, 77, True), (1, 1, 1024, 1024, False), (5, 3, 1, 4, True), (2, 7, 515, 600, False),
])
def test_conv_plain_backward_matches_autograd(b, h, length, k_len, gated):
    """conv_bwd_plain and dk_finish_plain (the Function's CPU backward and
    the kernels' oracle) equal torch's autograd of fft_conv_plain on odd B,
    ragged H and L, k_len both below and above L."""
    n = 1024
    u, k, gates = _conv_data(np.random.default_rng(b * h), b, h, length, k_len, gated)
    p = tplan.make_plan(n, torch.float32, device=CPU)
    ts = [torch.from_numpy(a).requires_grad_() for a in (u, k, *gates)]
    dout = torch.from_numpy(np.random.default_rng(1).standard_normal(u.shape).astype(np.float32))
    ref = torch.autograd.grad(monarch.fft_conv_plain(p, *ts), ts, dout)
    tu, tk, *tg = (t.detach() for t in ts)
    du, dpre, dpost, parts = monarch.conv_bwd_plain(p, tu, monarch.kernel_spectrum(p, tk),
                                                   *(tg or (None, None)), dout)
    assert parts.shape == (b // monarch.bwd_group(b), h, n // 2 + 1)
    assert parts.dtype == torch.complex64
    got = [du, monarch.dk_finish_plain(p, parts, k_len), *([dpre, dpost] if gated else [])]
    _assert_grads_close(got, ref, 1e-4, "u k pre post".split())


@pytest.mark.parametrize("b,want", [(1, 1), (2, 2), (3, 1), (4, 4), (6, 2), (8, 8), (16, 8),
                                    (64, 8), (96, 8)])
def test_bwd_group(b, want):
    """The rows of a channel summed into one dk partial: the largest power
    of two <= 8 that divides B."""
    assert monarch.bwd_group(b) == monarch_cuda.bwd_group(b) == want


@pytest.mark.parametrize("b", [1, 3, 4, 8, 64])
@pytest.mark.parametrize("gated", [False, True])
def test_conv_bwd_plain_groups_rows_in_order(b, gated):
    """conv_bwd_plain's partials are the rows' G conj(U) added in b order in
    consecutive groups of bwd_group(B), (B / c, H, M+1); dk_finish_plain of
    them and of the ungrouped rows agree at f32 rounding (1e-5 of dk's
    largest |value|)."""
    n, h, length = 256, 3, 100
    p = tplan.make_plan(n, torch.float32, device=CPU)
    g = torch.Generator().manual_seed(b + 100 * gated)
    u, d, pre, post = (torch.randn(b, h, length, generator=g) for _ in range(4))
    k_f = monarch.kernel_spectrum(p, torch.randn(h, 60, generator=g) * 0.1)
    gates = (pre, post) if gated else (None, None)
    parts = monarch.conv_bwd_plain(p, u, k_f, *gates, d)[3]
    ug, gg = (u * pre, d * post) if gated else (u, d)
    rows = monarch.rfft_plain(p, gg) * monarch.rfft_plain(p, ug).conj()
    c = monarch.bwd_group(b)
    want = torch.stack([_in_order(rows[i * c:(i + 1) * c]) for i in range(b // c)])
    assert parts.shape == (b // c, h, n // 2 + 1) and torch.equal(parts, want)
    dk, ref = monarch.dk_finish_plain(p, parts, 80), monarch.dk_finish_plain(p, rows, 80)
    assert float((dk - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def _in_order(rows):
    out = rows[0]
    for r in rows[1:]:
        out = out + r
    return out


def test_conv_backward_wrappers_on_cpu():
    """On CPU tensors the backward wrappers run their plain versions and
    count no launch; gates must come in pairs."""
    p = tplan.make_plan(256, torch.float32, device=CPU)
    g = torch.Generator().manual_seed(3)
    u, d = torch.randn(2, 3, 100, generator=g), torch.randn(2, 3, 100, generator=g)
    k_f = monarch_cuda.spectrum(p, torch.randn(3, 50, generator=g))
    before = (monarch_cuda.monarch_conv_bwd.launches, monarch_cuda.dk_finish.launches)
    du, dpre, dpost, parts = monarch_cuda.monarch_conv_bwd(p, u, k_f, None, None, d)
    assert dpre is None and dpost is None
    ref = monarch.conv_bwd_plain(p, u, k_f, None, None, d)
    torch.testing.assert_close(du, ref[0], atol=0, rtol=0)
    torch.testing.assert_close(monarch_cuda.dk_finish(p, parts, 50),
                               monarch.dk_finish_plain(p, ref[3], 50), atol=0, rtol=0)
    assert (monarch_cuda.monarch_conv_bwd.launches, monarch_cuda.dk_finish.launches) == before
    with pytest.raises(ValueError, match="both"):
        monarch_cuda.monarch_conv_bwd(p, u, k_f, u, None, d)


def _dw_data(rng, is_bhl, b, d, length, k, pad):
    out_len = length + sum(pad) - k + 1
    x = rng.standard_normal((b, d, length) if is_bhl else (b, length, d)).astype(np.float32)
    w = rng.standard_normal((d, k) if is_bhl else (k, d)).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    dout = rng.standard_normal((b, d, out_len) if is_bhl else (b, out_len, d)).astype(np.float32)
    return x, w, bias, dout


@pytest.mark.parametrize("is_bhl", [True, False])
@pytest.mark.parametrize("k,pad", [(3, (2, 0)), (5, 2)])
def test_depthwise_grads_match_jax_pallas_bwd(monkeypatch, is_bhl, k, pad):
    """FLASHFFTCONV_DW_BWD=fused sends jax.grad through _pallas_depthwise_bwd
    (interpret mode); the port's DepthwiseFunction with its plain backward
    agrees at atol 1e-3 (tests/test_depthwise.py's tolerance)."""
    monkeypatch.setenv("FLASHFFTCONV_DW_BWD", "fused")
    pad = pad if isinstance(pad, tuple) else (pad, pad)
    x, w, bias, dout = _dw_data(np.random.default_rng(k), is_bhl, 2, 128, 64, k, pad)
    ref = jax.grad(lambda *a: jnp.sum(jdw.depthwise_conv1d(
        *a, padding=pad, is_bhl=is_bhl, impl="pallas") * dout), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (x, w, bias)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, bias)]
    y = tff.depthwise_conv1d(*ts, padding=pad, is_bhl=is_bhl)
    assert type(y.grad_fn).__name__ == "DepthwiseFunctionBackward"
    got = torch.autograd.grad(y, ts, torch.from_numpy(dout))
    for name, a, r in zip(("x", "w", "bias"), got, ref):
        np.testing.assert_allclose(a.numpy(), _np(r), atol=1e-3, err_msg=f"d{name}")


@pytest.mark.parametrize("is_bhl", [True, False])
@pytest.mark.parametrize("shape,k,pad", [((3, 37, 101), 5, (1, 3)), ((2, 5, 9), 7, (6, 3)),
                                         ((1, 4, 30), 3, (0, 7)), ((2, 6, 12), 3, 0)])
def test_depthwise_backward_any_padding(is_bhl, shape, k, pad):
    """Paddings the JAX kernel refuses (pl + pr != K - 1): the port's
    backward against torch's autograd of depthwise_plain, f32 and bf16."""
    pad = pad if isinstance(pad, tuple) else (pad, pad)
    x, w, bias, dout = _dw_data(np.random.default_rng(sum(shape)), is_bhl, *shape, k, pad)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        xt = torch.from_numpy(x).to(dtype).requires_grad_()
        wt, bt = (torch.from_numpy(a).requires_grad_() for a in (w, bias))
        dt = torch.from_numpy(dout).to(dtype)
        got = torch.autograd.grad(tff.depthwise_conv1d(xt, wt, bt, pad, is_bhl), (xt, wt, bt), dt)
        ref = torch.autograd.grad(tdw.depthwise_plain(xt, wt, bt, pad, is_bhl), (xt, wt, bt), dt)
        assert [a.dtype for a in got] == [dtype, torch.float32, torch.float32]
        for a, r in zip(got, ref):
            torch.testing.assert_close(a.float(), r.float(), atol=tol * max(1.0, float(
                r.float().abs().max())), rtol=0)


# --- depthwise (kernel: _pallas_depthwise) --------------------------------

@pytest.mark.parametrize("is_bhl", [True, False])
@pytest.mark.parametrize("k,pad", [(3, (2, 0)), (3, 1), (5, (4, 0)), (5, 2)])
def test_depthwise_matches_jax_pallas(is_bhl, k, pad):
    """The depthwise wrapper (plain on the CPU) against the JAX Pallas
    kernel in interpret mode, f32 at atol 1e-4."""
    rng = np.random.default_rng(k)
    b, d, length = 2, 128, 256
    x = rng.standard_normal((b, d, length) if is_bhl else (b, length, d)).astype(np.float32)
    w = rng.standard_normal((d, k) if is_bhl else (k, d)).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    ref = _np(jdw.depthwise_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                                   padding=pad, is_bhl=is_bhl, impl="pallas"))
    got = tdw.depthwise(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
                        pad, is_bhl)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("is_bhl", [True, False])
def test_depthwise_bf16_matches_jax_pallas(is_bhl):
    rng = np.random.default_rng(11)
    b, d, length = 2, 256, 512
    x = rng.standard_normal((b, d, length) if is_bhl else (b, length, d)).astype(np.float32)
    w = (rng.standard_normal((d, 3) if is_bhl else (3, d)) * 0.3).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    ref = _np(jdw.depthwise_conv1d(xj, jnp.asarray(w), None, padding=(2, 0), is_bhl=is_bhl,
                                   impl="pallas").astype(jnp.float32))
    xt = torch.from_numpy(_np(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = tff.depthwise_conv1d(xt, torch.from_numpy(w), None, padding=(2, 0), is_bhl=is_bhl)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-2)


@pytest.mark.parametrize("is_bhl", [True, False])
@pytest.mark.parametrize("shape,k,pad", [((3, 37, 101), 3, (2, 0)), ((1, 5, 9), 7, (6, 3)),
                                         ((2, 130, 4), 3, 0)])
def test_depthwise_any_shape(is_bhl, shape, k, pad):
    """Shapes the JAX kernel does not take (D % 128, ragged L, wide pads)
    against the JAX shift form."""
    b, d, length = shape
    rng = np.random.default_rng(d)
    x = rng.standard_normal((b, d, length) if is_bhl else (b, length, d)).astype(np.float32)
    w = rng.standard_normal((d, k) if is_bhl else (k, d)).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    ref = _np(jdw.depthwise_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                                   padding=pad, is_bhl=is_bhl, impl="shifts"))
    got = tff.depthwise_conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
                               padding=pad, is_bhl=is_bhl)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_depthwise_errors():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(1, 4, 16, generator=g), torch.randn(4, 2, generator=g)
    w3 = torch.randn(4, 3, generator=g)
    torch.testing.assert_close(tff.depthwise_conv1d(x, w3, padding=1, impl="plain"),
                               tff.depthwise_conv1d(x, w3, padding=1), atol=0, rtol=0)
    with pytest.raises(ValueError, match="odd"):
        tff.depthwise_conv1d(x, w, padding=1)
    with pytest.raises(ValueError):
        tff.depthwise_conv1d(x, w3, impl="pallas")
    with pytest.raises(ValueError, match="cuda"):
        tff.depthwise_conv1d(x, w3, impl="cuda")


@pytest.mark.parametrize("is_bhl", [True, False])
@pytest.mark.parametrize("b,length,pad", [(8, 128, (1, 1)), (1, 8192, (2, 0))],
                         ids=["m2bert_rows", "causal_8192"])
def test_depthwise_model_rows_match_jax_pallas(is_bhl, b, length, pad):
    """The main paths' row shapes, cut to 128 channels: M2-BERT's short rows
    (L=128, padding 1, B=8) and a causal row of 8192 (two L tiles of the
    JAX kernels). depthwise_plain and DepthwiseFunction against
    _pallas_depthwise; depthwise_bwd_plain and DepthwiseFunction's backward
    against _pallas_depthwise_bwd (interpret mode), f32. The output and du
    at atol 1e-4; dk and dbias, sums over B*L in another order, within 1e-5
    of the sum of their terms' magnitudes."""
    d, k = 128, 3
    x, w, bias, dout = _dw_data(np.random.default_rng(length + b), is_bhl, b, d, length, k, pad)
    w_kd = jnp.asarray(w.T if is_bhl else w)
    ref = _np(jdw._pallas_depthwise(jnp.asarray(x), w_kd, jnp.asarray(bias), pad, is_bhl,
                                    jnp.float32))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, bias)]
    y = tff.depthwise_conv1d(*ts, padding=pad, is_bhl=is_bhl)
    assert type(y.grad_fn).__name__ == "DepthwiseFunctionBackward"
    np.testing.assert_allclose(y.detach().numpy(), ref, atol=1e-4)
    np.testing.assert_allclose(tdw.depthwise_plain(*(t.detach() for t in ts), pad, is_bhl).numpy(),
                               ref, atol=1e-4)
    rdu, rdk, rdb = (_np(a) for a in jdw._pallas_depthwise_bwd(
        jnp.asarray(x), jnp.asarray(dout), w_kd, pad, is_bhl))
    if is_bhl:
        rdk = rdk.T
    plain = tdw.depthwise_bwd_plain(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(dout), pad, is_bhl)
    grads = torch.autograd.grad(y, ts, torch.from_numpy(dout))
    _, mag_k, mag_b = tdw.depthwise_bwd_plain(torch.from_numpy(np.abs(x)), torch.from_numpy(w),
                                              torch.from_numpy(np.abs(dout)), pad, is_bhl)
    for got in (plain, grads):
        np.testing.assert_allclose(got[0].numpy(), rdu, atol=1e-4, err_msg="du")
        np.testing.assert_allclose(got[1].numpy(), rdk, atol=1e-5 * float(mag_k.max()),
                                   err_msg="dk")
        np.testing.assert_allclose(got[2].numpy(), rdb, atol=1e-5 * float(mag_b.max()),
                                   err_msg="dbias")


def test_depthwise_module_matches_jax_module():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 40)).astype(np.float32)
    w = rng.standard_normal((16, 3)).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    ref = _np(jff.FlashDepthWiseConv1d(16, 3, 1, jnp.asarray(w), jnp.asarray(bias))(
        jnp.asarray(x)))
    mod = tff.FlashDepthWiseConv1d(16, 3, 1, torch.from_numpy(w), torch.from_numpy(bias),
                                   device=CPU)
    assert isinstance(mod.weights, torch.nn.Parameter) and mod.weights.shape == (16, 3)
    np.testing.assert_allclose(mod(torch.from_numpy(x)).detach().numpy(), ref, atol=1e-4)
