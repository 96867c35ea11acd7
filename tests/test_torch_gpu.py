"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: f32 outputs within 2e-5 of the largest |output| (FFT roundoff
is ~1e-6 of it at N = 32768); bf16 and f16 outputs within one ulp of the
largest |output| (kernel and plain round the same f32 value once); sums
over B*L (the depthwise dk and dbias) within 1e-5 of the sum of their
terms' magnitudes.
"""

import pytest
import torch

import flashfftconv_tpu_torch as tff
from flashfftconv_tpu_torch.models.hyena import HyenaOperator
from flashfftconv_tpu_torch.ops import depthwise as tdw
from flashfftconv_tpu_torch.ops import monarch, monarch_cuda
from flashfftconv_tpu_torch.ops import plan as tplan

ULP = {torch.float32: 2e-5, torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _close(got, ref, dtype):
    err = float((got.float() - ref.float()).abs().max())
    assert err <= ULP[dtype] * float(ref.float().abs().max()) + 1e-6, err


@pytest.mark.gpu
@pytest.mark.parametrize("n", [256, 4096, 16384, 32768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_conv_kernels_match_plain(n, dtype):
    _needs_card()
    dev = torch.device("cuda")
    p = tplan.make_plan(n, dtype, device=dev)
    g = torch.Generator().manual_seed(n)
    for b, h, length, gated in [(4, 16, n // 2, False), (3, 7, n - 5, True)]:
        u = torch.randn(b, h, length, generator=g).to(dev, dtype)
        k = (torch.randn(h, length, generator=g) * 0.02).to(dev)
        gates = [torch.randn(b, h, length, generator=g).to(dev, dtype) for _ in range(2 * gated)]
        s0, c0 = monarch_cuda.spectrum.launches, monarch_cuda.monarch_conv.launches
        k_f = monarch_cuda.spectrum(p, k)
        y = monarch_cuda.monarch_conv(p, u, k_f, *gates)
        torch.cuda.synchronize()
        assert monarch_cuda.spectrum.launches == s0 + 1
        assert monarch_cuda.monarch_conv.launches == c0 + 1
        _close(torch.view_as_real(k_f), torch.view_as_real(monarch.kernel_spectrum(p, k)),
               torch.float32)
        _close(y, monarch.conv_with_spectrum(p, u, k_f, *gates), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [16 << i for i in range(12)])
def test_cuda_spectrum_matches_plain_at_every_plan_size(n):
    """The spectrum kernel (one instantiation per FFT size) against
    kernel_spectrum at every one-block plan size, k_len 1, 3, N/2 - 1, N/2
    and N, H 1, 5 and 768, with the taps' storage starting on a 16-byte
    boundary and one float past it (every row start unaligned at H = 1)."""
    _needs_card()
    dev = torch.device("cuda")
    p = tplan.make_plan(n, torch.float32, device=dev)
    g = torch.Generator().manual_seed(n)
    for k_len in sorted({1, 3, n // 2 - 1, n // 2, n}):
        for h in (1, 5, 768):
            for skew in (0, 1):
                k = torch.randn(h * k_len + skew, generator=g).to(dev)[skew:].view(h, k_len)
                n0 = monarch_cuda.spectrum.launches
                got = monarch_cuda.spectrum(p, k)
                torch.cuda.synchronize()
                assert monarch_cuda.spectrum.launches == n0 + 1
                assert got.shape == (h, n // 2 + 1)
                _close(torch.view_as_real(got),
                       torch.view_as_real(monarch.kernel_spectrum(p, k)), torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [16 << i for i in range(12)])
def test_cuda_monarch_conv_matches_plain_at_every_plan_size(n):
    """The monarch_conv kernel (one instantiation per FFT size, dtype and
    gating) against conv_with_spectrum at every one-block plan size: k_len
    1, N/2 and N; gated and ungated; f32 and bf16; L = N/2 and N - 5; the
    rows' storage on a 16-byte boundary and one element past it; two calls
    give the same bits."""
    _needs_card()
    dev = torch.device("cuda")
    p = tplan.make_plan(n, torch.float32, device=dev)
    g = torch.Generator().manual_seed(n)
    b, h = 3, 5
    for k_len in sorted({1, n // 2, n}):
        k_f = monarch_cuda.spectrum(p, (torch.randn(h, k_len, generator=g) * 0.1).to(dev))
        for dtype in (torch.float32, torch.bfloat16):
            for length in (n // 2, n - 5):
                for gated in (False, True):
                    for skew in (0, 1):
                        u, pre, post = (torch.randn(b * h * length + skew, generator=g).to(
                            dev, dtype)[skew:].view(b, h, length) for _ in "abc")
                        gates = (pre, post) if gated else ()
                        n0 = monarch_cuda.monarch_conv.launches
                        y = monarch_cuda.monarch_conv(p, u, k_f, *gates)
                        again = monarch_cuda.monarch_conv(p, u, k_f, *gates)
                        torch.cuda.synchronize()
                        assert monarch_cuda.monarch_conv.launches == n0 + 2
                        assert torch.equal(y, again)
                        _close(y, monarch.conv_with_spectrum(p, u, k_f, *gates), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("is_bhl", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_cuda_depthwise_matches_plain(is_bhl, dtype):
    _needs_card()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    for (b, d, length), k, pad in [((2, 2304, 4096), 3, (2, 0)), ((3, 37, 1031), 5, (1, 3))]:
        x = torch.randn((b, d, length) if is_bhl else (b, length, d), generator=g).to(dev, dtype)
        w = torch.randn((d, k) if is_bhl else (k, d), generator=g).to(dev) * 0.3
        bias = torch.randn(d, generator=g).to(dev)
        n0 = tdw.depthwise.launches
        y = tdw.depthwise(x, w, bias, pad, is_bhl)
        assert tdw.depthwise.launches == n0 + 1
        _close(y, tdw.depthwise_plain(x, w, bias, pad, is_bhl), dtype)


@pytest.mark.gpu
def test_cuda_hyena_operator_matches_cpu():
    """The same operator weights on the card (kernels) and the CPU (plain).

    Tolerance: 2e-5 of the largest |output| for the kernels' FFT roundoff,
    plus 16 ulps of the largest in-projection value for the f32 matmuls. The
    operator's output here is small (|y| <= 0.09) beside its intermediates
    (the in-projection reaches 5.0), and cuBLAS adds a matmul's products in
    an order of its own choosing: when that order is the CPU's the card reads
    3e-8 (12 of 12 runs in one process on an H100), and when one
    in-projection value lands one ulp away (2^-23 * 5.0 = 6e-7) the short
    filter (gain <= 0.43), the gates and the filter bias (each up to about 3)
    carry it to about 1e-5 at the output whatever the output's own size; 7.4e-6
    was read once. TF32 is pinned off: with it the same check reads 9.4e-5."""
    _needs_card()
    ops = {dev: HyenaOperator(64, 512, conv_dtype=torch.float32, device=dev,
                              generator=torch.Generator().manual_seed(0)) for dev in ("cpu", "cuda")}
    u = torch.randn(3, 500, 64, generator=torch.Generator().manual_seed(1))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            ref = ops["cpu"](u)
            got = ops["cuda"](u.cuda()).cpu()
            x_max = float(torch.matmul(ops["cpu"].in_proj, u.transpose(1, 2)).abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    err = float((got - ref).abs().max())
    assert err <= ULP[torch.float32] * float(ref.abs().max()) + 16 * 2.0**-23 * x_max, err


@pytest.mark.gpu
def test_cuda_wrappers_refuse_grad_and_bad_inputs():
    """Bad inputs still raise; grads now flow through the kernels (the
    wrappers no longer refuse them) and match the plain path's."""
    _needs_card()
    dev = torch.device("cuda")
    p = tplan.make_plan(1024, torch.float32, device=dev)
    g = torch.Generator().manual_seed(0)
    k = (torch.randn(4, 512, generator=g) * 0.1).to(dev).requires_grad_()
    k_f = monarch_cuda.spectrum(p, k)
    assert k_f.grad_fn is None  # a wrapper is a plain kernel call, outside autograd
    u = torch.randn(2, 4, 512, generator=g).to(dev)
    with pytest.raises(ValueError, match="contiguous"):
        monarch_cuda.monarch_conv(p, u.transpose(0, 1).contiguous().transpose(0, 1), k_f)
    with pytest.raises(TypeError):
        monarch_cuda.monarch_conv(p, u.half(), k_f)
    with pytest.raises(ValueError, match="dout"):
        monarch_cuda.monarch_conv_bwd(p, u, k_f, None, None, u[:, :, :100].contiguous())
    with pytest.raises(ValueError, match="partials"):
        monarch_cuda.dk_finish(p, k_f, 512)
    with pytest.raises(ValueError, match="dout"):
        tdw.depthwise_bwd(u, torch.randn(4, 3, device=dev), u.bfloat16(), 1, True)
    w = torch.randn(4, 3, generator=g).to(dev).requires_grad_()
    uu = u.clone().requires_grad_()
    n0 = (monarch_cuda.monarch_conv_bwd.launches, tdw.depthwise_bwd.launches)
    y = tff.FlashFFTConv(1024, torch.float32)(tdw.depthwise_conv1d(uu, w, None, 1, True), k)
    y.square().sum().backward()
    assert (monarch_cuda.monarch_conv_bwd.launches, tdw.depthwise_bwd.launches) == \
        (n0[0] + 1, n0[1] + 1)
    uc, wc, kc = (t.detach().cpu().requires_grad_() for t in (u, w, k))
    pc = tplan.make_plan(1024, torch.float32, device="cpu")
    tff.fft_conv(pc, tdw.depthwise_conv1d(uc, wc, None, 1, True), kc).square().sum().backward()
    for a, b in ((uu, uc), (w, wc), (k, kc)):
        _close(a.grad.cpu(), b.grad, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [16 << i for i in range(12)])
def test_cuda_dk_finish_matches_plain_at_every_plan_size(n):
    """The dk_finish kernel (one instantiation per FFT size) against
    dk_finish_plain at every one-block plan size: B 1 and 3, k_len 1,
    N/2 - 1, N/2 and N (an odd k_len leaves dk's rows off 16-byte
    boundaries); two calls give the same bits."""
    _needs_card()
    dev = torch.device("cuda")
    p = tplan.make_plan(n, torch.float32, device=dev)
    g = torch.Generator().manual_seed(n + 2)
    for b, h in ((1, 5), (3, 7)):
        parts = torch.view_as_complex(torch.randn(b, h, n // 2 + 1, 2, generator=g)).to(dev)
        for k_len in sorted({1, max(1, n // 2 - 1), n // 2, n}):
            n0 = monarch_cuda.dk_finish.launches
            dk = monarch_cuda.dk_finish(p, parts, k_len)
            again = monarch_cuda.dk_finish(p, parts, k_len)
            torch.cuda.synchronize()
            assert monarch_cuda.dk_finish.launches == n0 + 2
            assert torch.equal(dk, again)
            _close(dk, monarch.dk_finish_plain(p, parts, k_len), torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [16 << i for i in range(12)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_conv_backward_kernels_match_plain(n, dtype):
    """monarch_conv_bwd and dk_finish against conv_bwd_plain and
    dk_finish_plain at every one-block plan size, B 1, 3, 4, 8 and 64, gated
    and ungated, L = N/2 and N - 5; the partials, (B / bwd_group(B), H, M+1)
    summed over thread block clusters, against the plain version's grouped
    ones; dk and the partials are f32 at f32 tolerance; two calls give the
    same bits."""
    _needs_card()
    dev = torch.device("cuda")
    p = tplan.make_plan(n, dtype, device=dev)
    g = torch.Generator().manual_seed(n + 1)
    for b, h, length, gated in [(1, 5, n // 2, False), (1, 3, n - 5, True),
                                (3, 7, n - 5, True), (3, 4, n // 2, False),
                                (4, 16, n // 2, False), (4, 5, n - 5, True),
                                (8, 6, n // 2, False), (8, 3, n - 5, True),
                                (64, 2, n // 2, False), (64, 2, n - 5, True)]:
        u, d, *gates = (torch.randn(b, h, length, generator=g).to(dev, dtype)
                        for _ in range(2 + 2 * gated))
        k_f = monarch_cuda.spectrum(p, (torch.randn(h, length, generator=g) * 0.02).to(dev))
        gates = gates or [None, None]
        n0 = (monarch_cuda.monarch_conv_bwd.launches, monarch_cuda.dk_finish.launches)
        got = monarch_cuda.monarch_conv_bwd(p, u, k_f, *gates, d)
        dk = monarch_cuda.dk_finish(p, got[3], length)
        torch.cuda.synchronize()
        assert (monarch_cuda.monarch_conv_bwd.launches, monarch_cuda.dk_finish.launches) == \
            (n0[0] + 1, n0[1] + 1)
        ref = monarch.conv_bwd_plain(p, u, k_f, *gates, d)
        assert got[3].shape == ref[3].shape == (b // monarch.bwd_group(b), h, n // 2 + 1)
        for a, r in zip(got[:3], ref[:3]):
            if r is not None:
                _close(a, r, dtype)
        _close(torch.view_as_real(got[3]), torch.view_as_real(ref[3]), torch.float32)
        _close(dk, monarch.dk_finish_plain(p, ref[3], length), torch.float32)
        again = monarch_cuda.monarch_conv_bwd(p, u, k_f, *gates, d)
        assert all(a is None or torch.equal(a, r) for a, r in zip(got, again))
        assert torch.equal(dk, monarch_cuda.dk_finish(p, again[3], length))


@pytest.mark.gpu
@pytest.mark.parametrize("is_bhl", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_cuda_depthwise_bwd_matches_plain(is_bhl, dtype):
    """du within one output ulp; dk and dbias (sums over B*L in another
    order) within 1e-5 of the sum of the terms' magnitudes."""
    _needs_card()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    for (b, d, length), k, pad in [((2, 2304, 4096), 3, (2, 0)), ((3, 37, 1031), 5, (1, 3)),
                                   ((2, 5, 300), 7, (0, 9))]:
        x = torch.randn((b, d, length) if is_bhl else (b, length, d), generator=g).to(dev, dtype)
        w = torch.randn((d, k) if is_bhl else (k, d), generator=g).to(dev) * 0.3
        out_len = length + sum(pad) - k + 1
        dy = torch.randn((b, d, out_len) if is_bhl else (b, out_len, d), generator=g).to(dev, dtype)
        n0 = tdw.depthwise_bwd.launches
        du, dk, db = tdw.depthwise_bwd(x, w, dy, pad, is_bhl)
        assert tdw.depthwise_bwd.launches == n0 + 1
        rdu, rdk, rdb = tdw.depthwise_bwd_plain(x, w, dy, pad, is_bhl)
        _, adk, adb = tdw.depthwise_bwd_plain(x.abs(), w, dy.abs(), pad, is_bhl)
        _close(du, rdu, dtype)
        for a, r, mag in ((dk, rdk, adk), (db, rdb, adb)):
            assert float((a - r).abs().max()) <= 1e-5 * float(mag.abs().max()) + 1e-7


@pytest.mark.gpu
@pytest.mark.parametrize("is_bhl", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_cuda_depthwise_kernels_at_model_and_ragged_shapes(is_bhl, dtype):
    """Both depthwise kernels against their plain versions at M2-BERT's rows
    (B=16 of its 128, D=2304, L=128, padding 1), a long causal row (L=65536,
    32 tiles a channel), L=100 and odd L (bf16 rows 200 bytes apart, off 16
    bytes), K=5 and 7, out_len != L ((0, 9) and (1, 3)), and an input and
    dout one element off a 16-byte boundary; dk and dbias the same bits from
    two calls."""
    _needs_card()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(20)
    for (b, d, length), k, pad, skew in [((16, 2304, 128), 3, (1, 1), 0),
                                         ((1, 768, 65536), 3, (2, 0), 0),
                                         ((8, 768, 100), 3, (1, 1), 0),
                                         ((1, 64, 100), 3, (2, 0), 0),
                                         ((3, 37, 1031), 3, (2, 0), 0),
                                         ((4, 64, 1024), 5, (2, 2), 0),
                                         ((4, 64, 1024), 7, (6, 0), 0),
                                         ((2, 300, 1000), 7, (0, 9), 0),
                                         ((3, 37, 1031), 5, (1, 3), 0),
                                         ((2, 128, 512), 3, (2, 0), 1)]:
        out_len = length + sum(pad) - k + 1
        x = torch.randn(b * d * length + skew, generator=g).to(dev, dtype)[skew:].view(
            (b, d, length) if is_bhl else (b, length, d))
        dy = torch.randn(b * d * out_len + skew, generator=g).to(dev, dtype)[skew:].view(
            (b, d, out_len) if is_bhl else (b, out_len, d))
        w = torch.randn((d, k) if is_bhl else (k, d), generator=g).to(dev) * 0.3
        bias = torch.randn(d, generator=g).to(dev)
        n0, m0 = tdw.depthwise.launches, tdw.depthwise_bwd.launches
        # NaN blocks of the outputs' sizes, freed: the caching allocator hands
        # them to the outputs, so a part left unwritten shows
        torch.full_like(dy, float("nan"))
        y = tdw.depthwise(x, w, bias, pad, is_bhl)
        torch.full_like(x, float("nan"))
        du, dk, db = tdw.depthwise_bwd(x, w, dy, pad, is_bhl)
        again = tdw.depthwise_bwd(x, w, dy, pad, is_bhl)
        torch.cuda.synchronize()
        assert (tdw.depthwise.launches, tdw.depthwise_bwd.launches) == (n0 + 1, m0 + 2)
        assert all(torch.equal(a, r) for a, r in zip((du, dk, db), again))
        _close(y, tdw.depthwise_plain(x, w, bias, pad, is_bhl), dtype)
        rdu, rdk, rdb = tdw.depthwise_bwd_plain(x, w, dy, pad, is_bhl)
        _, adk, adb = tdw.depthwise_bwd_plain(x.abs(), w, dy.abs(), pad, is_bhl)
        _close(du, rdu, dtype)
        for a, r, mag in ((dk, rdk, adk), (db, rdb, adb)):
            assert float((a - r).abs().max()) <= 1e-5 * float(mag.abs().max()) + 1e-7


@pytest.mark.gpu
def test_cuda_lm_grads_match_cpu():
    """A tiny f32 LM with the same weights: every parameter's grad on the
    card (backward kernels) within 1e-4 of its largest |grad| on the CPU."""
    _needs_card()
    from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy

    ids = torch.randint(0, 64, (2, 257), generator=torch.Generator().manual_seed(2))
    grads = {}
    for dev in ("cpu", "cuda"):
        m = ConvLMHeadModel(d_model=32, n_layer=2, d_inner=64, vocab_size=64, l_max=256,
                            mixer_kwargs={"conv_dtype": torch.float32}, dtype=torch.float32,
                            device=dev, generator=torch.Generator().manual_seed(3)).eval()
        cross_entropy(m(ids[:, :-1].to(dev)), ids[:, 1:].to(dev)).backward()
        grads[dev] = {n: p.grad.cpu() for n, p in m.named_parameters()}
    for name, ref in grads["cpu"].items():
        err = float((grads["cuda"][name] - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()) + 1e-8, (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [65536, 524288, 4194304])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_long_kernels_match_plain(n, dtype):
    """butterfly (both directions), long_conv_inner and long_spectrum against
    their plain versions, and the chain against torch.fft; B = 1 ungated at
    L = N/2 and B = 3 gated at a ragged length."""
    _needs_card()
    dev = torch.device("cuda")
    p = tplan.make_plan(n, dtype, device=dev)
    g = torch.Generator().manual_seed(n)
    real = torch.view_as_real
    for b, h, length, gated in [(1, 3, n // 2, False), (3, 2, n // 2 + 3, True)]:
        u = torch.randn(b, h, length, generator=g).to(dev, dtype)
        k = (torch.randn(h, n // 2 - 1, generator=g) * 0.05).to(dev)
        pre, post = ([torch.randn(b, h, length, generator=g).to(dev, dtype) for _ in "ab"]
                     if gated else (None, None))
        n0 = (monarch_cuda.butterfly.launches, monarch_cuda.long_conv_inner.launches,
              monarch_cuda.long_spectrum.launches)
        k_f = monarch_cuda.long_spectrum(p, k)
        z = monarch_cuda.butterfly(p, u, pre)
        zr = monarch.butterfly_plain(p, u, pre)
        z2 = monarch_cuda.long_conv_inner(p, zr, k_f)
        z2r = monarch.long_conv_inner_plain(p, zr, k_f)
        y = monarch_cuda.butterfly(p, z2r, post, inverse=True, length=length, dtype=dtype)
        torch.cuda.synchronize()
        assert (monarch_cuda.butterfly.launches, monarch_cuda.long_conv_inner.launches,
                monarch_cuda.long_spectrum.launches) == (n0[0] + 3, n0[1] + 1, n0[2] + 1)
        _close(real(k_f), real(monarch.long_spectrum_plain(p, k)), torch.float32)
        _close(real(z), real(zr), torch.float32)
        _close(real(z2), real(z2r), torch.float32)
        _close(y, monarch.butterfly_inverse_plain(p, z2r, length, post, dtype), dtype)
        _close(monarch_cuda.long_conv(p, u, k_f, pre, post),
               monarch.fft_conv_reference(n, u, k, pre, post), dtype)


@pytest.mark.gpu
def test_cuda_long_conv_module_and_backward():
    """FlashFFTConv(131072) on the card runs the long kernels and matches the
    CPU; its backward on the card runs the long backward kernels and its
    grads match the CPU's (the plain backward); bad inputs raise."""
    _needs_card()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    u = torch.randn(2, 3, 65000, generator=g)
    k = torch.randn(3, 65000, generator=g) * 0.05
    conv = tff.FlashFFTConv(131072, torch.float32)
    n0 = monarch_cuda.long_conv_inner.launches
    got = conv(u.to(dev), k.to(dev))
    assert monarch_cuda.long_conv_inner.launches == n0 + 1
    _close(got.cpu(), tff.FlashFFTConv(131072, torch.float32, device="cpu")(u, k), torch.float32)
    cpu = [t.clone().requires_grad_() for t in (u, k)]
    card = [t.to(dev).requires_grad_() for t in (u, k)]
    n0 = (monarch_cuda.long_conv_bwd_inner.launches, monarch_cuda.long_dk_finish.launches)
    conv(*card).square().sum().backward()
    assert (monarch_cuda.long_conv_bwd_inner.launches, monarch_cuda.long_dk_finish.launches) == \
        (n0[0] + 1, n0[1] + 1)
    tff.FlashFFTConv(131072, torch.float32, device="cpu")(*cpu).square().sum().backward()
    for a, b in zip(card, cpu):
        assert a.grad.shape == b.grad.shape
        _close(a.grad.cpu(), b.grad, torch.float32)
    p = conv.plan
    k_f = monarch_cuda.long_spectrum(p, k.to(dev))
    with pytest.raises(ValueError, match="contiguous"):
        monarch_cuda.butterfly(p, u.to(dev).transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(TypeError):
        monarch_cuda.butterfly(p, u.to(dev).half())
    with pytest.raises(ValueError, match="k_f shape"):
        monarch_cuda.long_conv_inner(p, monarch_cuda.butterfly(p, u.to(dev)), k_f[:2])
    with pytest.raises(ValueError, match="outer part"):
        monarch_cuda.monarch_conv(p, u.to(dev), k_f)
    with pytest.raises(ValueError, match="is on"):
        monarch_cuda.long_spectrum(tplan.make_plan(131072, torch.float32, device="cpu"), k.to(dev))
    z = monarch_cuda.butterfly(p, u.to(dev))
    with pytest.raises(ValueError, match="zg shape"):
        monarch_cuda.long_conv_bwd_inner(p, z, z[:1], k_f)
    with pytest.raises(ValueError, match="partials"):
        monarch_cuda.long_dk_finish(p, k_f[None, :, :-1].contiguous(), 100)
    wide = tplan.make_plan(65536, torch.float32, device=dev, factors=(4, 32, 16, 16))
    zw = torch.zeros(1, 3, 4, 8192, dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError, match="at most 4096"):
        monarch_cuda.long_conv_bwd_inner(wide, zw, zw, torch.zeros(3, 32769, dtype=torch.complex64,
                                                                   device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [65536, 131072, 524288, 2097152, 4194304])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_long_backward_kernels_match_plain(n, dtype):
    """long_conv_bwd_inner and long_dk_finish against their plain versions on
    the same bands and partials (f32 tolerance), and the whole long backward
    against conv_bwd_plain; B = 1 ungated at L = N/2, B = 3 gated at a ragged
    length with a shorter kernel."""
    _needs_card()
    dev = torch.device("cuda")
    p = tplan.make_plan(n, dtype, device=dev)
    g = torch.Generator().manual_seed(n + 2)
    real = torch.view_as_real
    for b, h, length, gated in [(1, 3, n // 2, False), (3, 2, n // 2 + 3, True)]:
        u, d = (torch.randn(b, h, length, generator=g).to(dev, dtype) for _ in "ab")
        k_len = n // 2 - 1
        k_f = monarch_cuda.long_spectrum(p, (torch.randn(h, k_len, generator=g) * 0.05).to(dev))
        pre, post = ([torch.randn(b, h, length, generator=g).to(dev, dtype) for _ in "ab"]
                     if gated else (None, None))
        zu = monarch.butterfly_plain(p, u, pre)
        zg = monarch.butterfly_plain(p, d.float() * post.float() if gated else d)
        n0 = (monarch_cuda.long_conv_bwd_inner.launches, monarch_cuda.long_dk_finish.launches)
        got = monarch_cuda.long_conv_bwd_inner(p, zu, zg, k_f, need_y=gated)
        ref = monarch.long_conv_bwd_inner_plain(p, zu, zg, k_f, need_y=gated)
        dk = monarch_cuda.long_dk_finish(p, ref[2], k_len)
        torch.cuda.synchronize()
        assert (monarch_cuda.long_conv_bwd_inner.launches,
                monarch_cuda.long_dk_finish.launches) == (n0[0] + 1, n0[1] + 1)
        assert (got[1] is None) == (not gated)
        for a, r in zip(got, ref):
            if r is not None:
                _close(real(a), real(r), torch.float32)
        _close(dk, monarch.long_dk_finish_plain(p, ref[2], k_len), torch.float32)
        del zu, zg, got, ref
        whole = monarch_cuda.long_conv_bwd(p, u, k_f, pre, post, d)
        want = monarch.conv_bwd_plain(p, u, k_f, pre, post, d)
        for a, r in zip(whole[:3], want[:3]):
            if r is not None:
                _close(a, r, dtype)
        _close(monarch_cuda.long_dk_finish(p, whole[3], k_len),
               monarch.dk_finish_plain(p, want[3], k_len), torch.float32)


LONG_SIZES = (65536, 131072, 524288, 2097152, 4194304)


def _off16(b, h, length, dtype, dev, g):
    """A contiguous (b, h, length) view whose storage starts one element in,
    off a 16-byte boundary."""
    flat = torch.randn(b * h * length + 1, generator=g).to(dev, dtype)
    return flat[1:].view(b, h, length)


@pytest.mark.gpu
@pytest.mark.parametrize("n", LONG_SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_butterfly_matches_plain(n, dtype):
    """Both butterfly directions against their plain versions: B = 1
    ungated at L = N/2, B = 3 gated at L = N/2 + 3, B = 2 gated at L = N - 5
    on row views that start off 16-byte alignment (the kernels' scalar
    path); two calls give the same bits."""
    _needs_card()
    dev = torch.device("cuda")
    p = tplan.make_plan(n, dtype, device=dev)
    g = torch.Generator().manual_seed(n + 18)
    real = torch.view_as_real
    for b, h, length, gated, off in [(1, 3, n // 2, False, False), (3, 2, n // 2 + 3, True, False),
                                     (2, 2, n - 5, True, True)]:
        make = (lambda: _off16(b, h, length, dtype, dev, g)) if off else (
            lambda: torch.randn(b, h, length, generator=g).to(dev, dtype))
        u, pre, post = make(), make(), make()
        if off:
            assert u.data_ptr() % 16 and u.is_contiguous()
        if not gated:
            pre = post = None
        n0 = monarch_cuda.butterfly.launches
        z = monarch_cuda.butterfly(p, u, pre)
        zr = monarch.butterfly_plain(p, u, pre)
        y = monarch_cuda.butterfly(p, zr, post, inverse=True, length=length, dtype=dtype)
        torch.cuda.synchronize()
        assert monarch_cuda.butterfly.launches == n0 + 2
        _close(real(z), real(zr), torch.float32)
        _close(y, monarch.butterfly_inverse_plain(p, zr, length, post, dtype), dtype)
        assert torch.equal(real(z), real(monarch_cuda.butterfly(p, u, pre)))
        assert torch.equal(y, monarch_cuda.butterfly(p, zr, post, inverse=True, length=length,
                                                     dtype=dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("n,factors", [(n, None) for n in LONG_SIZES]
                         + [(131072, (32, 16, 16, 8)), (131072, (4, 32, 8, 8, 8))])
def test_cuda_long_conv_bwd_inner_matches_plain_bit_for_bit(n, factors):
    """long_conv_bwd_inner against its plain version, with and without y, at
    B = 1, 2 and 3, at every LONG_SIZES plan and at bands of 2048 and 512;
    two calls give the same bits."""
    _needs_card()
    dev = torch.device("cuda")
    p = tplan.make_plan(n, torch.float32, device=dev, factors=factors)
    g = torch.Generator(device=dev).manual_seed(n + 19)
    real = torch.view_as_real
    for b, h, need_y in [(1, 3, False), (3, 2, True), (2, 2, False)]:
        zu, zg = (torch.randn(b, h, p.outer, p.band, dtype=torch.complex64, device=dev,
                              generator=g) for _ in "ab")
        k_f = torch.randn(h, p.inner + 1, dtype=torch.complex64, device=dev, generator=g)
        got = monarch_cuda.long_conv_bwd_inner(p, zu, zg, k_f, need_y=need_y)
        ref = monarch.long_conv_bwd_inner_plain(p, zu, zg, k_f, need_y=need_y)
        again = monarch_cuda.long_conv_bwd_inner(p, zu, zg, k_f, need_y=need_y)
        torch.cuda.synchronize()
        for a, r, c in zip(got, ref, again):
            assert (a is None) == (r is None)
            if r is not None:
                _close(real(a), real(r), torch.float32)
                assert torch.equal(real(a), real(c))


@pytest.mark.gpu
@pytest.mark.parametrize("n,factors", [(n, None) for n in LONG_SIZES]
                         + [(131072, (8, 32, 16, 16)), (131072, (32, 16, 16, 8)),
                            (131072, (4, 32, 8, 8, 8))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_long_conv_inner_and_dk_finish_match_plain_bit_for_bit(n, factors, dtype):
    """long_conv_inner and long_dk_finish against their plain versions at B =
    1, 2 and 3 (long_dk_finish also at 8 partials), at every LONG_SIZES plan
    and at bands of 8192, 2048 and 512, in f32 and bf16 plans; long_conv_inner
    in place (out = z) and on a z and an out off 16-byte alignment; two calls
    give the same bits."""
    _needs_card()
    dev = torch.device("cuda")
    p = tplan.make_plan(n, dtype, device=dev, factors=factors)
    g = torch.Generator(device=dev).manual_seed(n + 20)
    real = torch.view_as_real
    for b, h in [(1, 3), (2, 2), (3, 1)]:
        z = torch.randn(b, h, p.outer, p.band, dtype=torch.complex64, device=dev, generator=g)
        k_f = torch.randn(h, p.inner + 1, dtype=torch.complex64, device=dev, generator=g)
        n0 = monarch_cuda.long_conv_inner.launches
        got = monarch_cuda.long_conv_inner(p, z, k_f)
        again = monarch_cuda.long_conv_inner(p, z, k_f)
        inplace = z.clone()
        monarch_cuda.long_conv_inner(p, inplace, k_f, out=inplace)
        flat = torch.empty(z.numel() + 1, dtype=torch.complex64, device=dev)
        off = flat[1:].view(z.shape)
        off.copy_(z)
        monarch_cuda.long_conv_inner(p, off, k_f, out=off)
        torch.cuda.synchronize()
        assert monarch_cuda.long_conv_inner.launches == n0 + 4
        _close(real(got), real(monarch.long_conv_inner_plain(p, z, k_f)), torch.float32)
        for c in (again, inplace, off):
            assert torch.equal(real(got), real(c))
    for b in (1, 2, 3, 8):
        parts = torch.randn(b, 2, p.inner + 1, dtype=torch.complex64, device=dev, generator=g)
        k_len = n // 2 - 3
        n0 = monarch_cuda.long_dk_finish.launches
        dk = monarch_cuda.long_dk_finish(p, parts, k_len)
        again = monarch_cuda.long_dk_finish(p, parts, k_len)
        bands = monarch_cuda._long_dk_finish_bands(p, parts, torch.empty(
            2, p.outer, p.band, dtype=torch.complex64, device=dev))
        torch.cuda.synchronize()
        assert monarch_cuda.long_dk_finish.launches == n0 + 3
        _close(dk, monarch.long_dk_finish_plain(p, parts, k_len), torch.float32)
        want = monarch.monarch_idft(p.sub, monarch._natural_to_bands(
            p, monarch._unsplit(p, parts.sum(0))))
        _close(real(bands), real(want), torch.float32)
        assert torch.equal(dk, again)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [16, 64, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_direct_kernels_match_plain(n, dtype):
    """spectrum -> direct_conv and direct_conv_bwd -> dk_finish against their
    plain versions (direct_conv_plain; conv_bwd_plain, whose dk partials are
    grouped as the row-FFT backward groups them), one launch each; B = 4
    ungated at L = N/2 (one partial), B = 3 gated at L = N/2 + 3 with H = 7
    (three), and B = 20 gated at L = N (five groups of four rows); a second
    backward gives the same bits."""
    _needs_card()
    dev = torch.device("cuda")
    p = tplan.make_plan(n, dtype, device=dev)
    g = torch.Generator().manual_seed(n + 2)
    for b, h, length, gated in [(4, 16, n // 2, False), (3, 7, n // 2 + 3, True),
                                (20, 3, n, True)]:
        u, d, *gates = (torch.randn(b, h, length, generator=g).to(dev, dtype)
                        for _ in range(2 + 2 * gated))
        gates = gates or [None, None]
        k_f = monarch_cuda.spectrum(p, (torch.randn(h, n, generator=g) * 0.05).to(dev))
        n0 = (monarch_cuda.direct_conv.launches, monarch_cuda.direct_conv_bwd.launches)
        y = monarch_cuda.direct_conv(p, u, k_f, *gates)
        got = monarch_cuda.direct_conv_bwd(p, u, k_f, *gates, d)
        torch.cuda.synchronize()
        assert (monarch_cuda.direct_conv.launches, monarch_cuda.direct_conv_bwd.launches) == \
            (n0[0] + 1, n0[1] + 1)
        _close(y, monarch.direct_conv_plain(p, u, k_f, *gates), dtype)
        ref = monarch.conv_bwd_plain(p, u, k_f, *gates, d)
        assert got[3].shape == ref[3].shape == (b // monarch.bwd_group(b), h, n // 2 + 1)
        for a, r in zip(got[:3], ref[:3]):
            if r is not None:
                _close(a, r, dtype)
        _close(torch.view_as_real(got[3]), torch.view_as_real(ref[3]), torch.float32)
        _close(monarch_cuda.dk_finish(p, got[3], n), monarch.dk_finish_plain(p, ref[3], n),
               torch.float32)
        again = monarch_cuda.direct_conv_bwd(p, u, k_f, *gates, d)
        assert all(a is None or torch.equal(a, r) for a, r in zip(got, again))


@pytest.mark.gpu
def test_cuda_direct_kernels_at_the_m2_bert_shape():
    """The M2-BERT path's shape (B=128, H=768, L=128, N=256, bf16, ungated,
    a bidirectional kernel of 256 taps): the forward, the backward's du and
    dk spectrum partials (16, summed over groups of 8 rows), and dk, against
    the plain versions; two backwards give the same bits."""
    _needs_card()
    dev = torch.device("cuda")
    p = tplan.make_plan(256, torch.bfloat16, device=dev)
    g = torch.Generator().manual_seed(5)
    u, d = ((torch.randn(128, 768, 128, generator=g) * 0.02).to(dev, torch.bfloat16)
            for _ in "ab")
    k_f = monarch_cuda.spectrum(p, (torch.randn(768, 256, generator=g) * 0.02).to(dev))
    _close(monarch_cuda.direct_conv(p, u, k_f), monarch.direct_conv_plain(p, u, k_f),
           torch.bfloat16)
    got = monarch_cuda.direct_conv_bwd(p, u, k_f, None, None, d)
    ref = monarch.conv_bwd_plain(p, u, k_f, None, None, d)
    assert got[3].shape == ref[3].shape == (16, 768, 129)
    _close(got[0], ref[0], torch.bfloat16)
    _close(torch.view_as_real(got[3]), torch.view_as_real(ref[3]), torch.float32)
    _close(monarch_cuda.dk_finish(p, got[3], 256), monarch.dk_finish_plain(p, ref[3], 256),
           torch.float32)
    again = monarch_cuda.direct_conv_bwd(p, u, k_f, None, None, d)
    assert torch.equal(got[0], again[0]) and torch.equal(got[3], again[3])


@pytest.mark.gpu
def test_cuda_m2_bert_matches_cpu():
    """A tiny f32 M2BertForMaskedLM with the same weights: logits and every
    parameter's grad on the card (direct kernels) within 1e-4 of the CPU's
    largest value; its long convs run direct_conv and direct_conv_bwd."""
    _needs_card()
    from flashfftconv_tpu_torch.models.bert import M2BertForMaskedLM
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy

    ids = torch.randint(0, 64, (3, 64), generator=torch.Generator().manual_seed(2))
    labels = torch.where(torch.rand(ids.shape, generator=torch.Generator().manual_seed(3)) < 0.3,
                         ids, -100)
    out, grads = {}, {}
    n0 = (monarch_cuda.direct_conv.launches, monarch_cuda.direct_conv_bwd.launches)
    for dev in ("cpu", "cuda"):
        m = M2BertForMaskedLM(vocab_size=64, d_model=32, n_layer=2, d_inner=64, l_max=64,
                              mlp_nblocks=4, conv_dtype=torch.float32, device=dev,
                              generator=torch.Generator().manual_seed(3)).eval()
        out[dev] = m(ids.to(dev))
        cross_entropy(out[dev], labels.to(dev), -100).backward()
        grads[dev] = {n: p.grad.cpu() for n, p in m.named_parameters() if p.grad is not None}
    assert (monarch_cuda.direct_conv.launches, monarch_cuda.direct_conv_bwd.launches) == \
        (n0[0] + 4, n0[1] + 4)
    ref = out["cpu"].detach()
    assert float((out["cuda"].detach().cpu() - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert set(grads["cuda"]) == set(grads["cpu"])
    for name, r in grads["cpu"].items():
        err = float((grads["cuda"][name] - r).abs().max())
        assert err <= 1e-4 * float(r.abs().max()) + 1e-8, (name, err)


def _band_close(got, ref):
    """The complex band conv: two f32 complex FFTs (and, from 32768 up, four
    real convs): within 1e-4 of the largest |y|."""
    got, ref = torch.view_as_real(got), torch.view_as_real(ref)
    err = float((got - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max()) + 1e-7, err


@pytest.mark.gpu
@pytest.mark.parametrize("n2", [16 << i for i in range(11)])
def test_cuda_band_conv_matches_plain(n2):
    """band_conv, both conj, against band_conv_plain on complex bands with a
    nonzero imaginary part, at every band length its kernel is instantiated
    for (N2 = 16 ... 16384), B = 3 so that a channel's rows run in a ragged
    group of the block order; one launch a call, two calls bit for bit;
    BandConvFunction's grads against the plain chain's autograd."""
    _needs_card()
    dev = torch.device("cuda")
    p = tplan.make_plan(2 * n2, torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(n2)
    b = torch.randn(3, 5, n2, dtype=torch.complex64, device=dev, generator=g)
    k_f = torch.randn(5, n2, dtype=torch.complex64, device=dev, generator=g)
    for conj in (False, True):
        n0 = monarch_cuda.band_conv.launches
        y = monarch_cuda.band_conv(p, b, k_f, conj)
        torch.cuda.synchronize()
        assert monarch_cuda.band_conv.launches == n0 + 1
        _band_close(y, monarch.band_conv_plain(p, b, k_f, conj))
        assert torch.equal(y, monarch_cuda.band_conv(p, b, k_f, conj))
    dy = torch.randn(b.shape, dtype=torch.complex64, device=dev, generator=g)
    grads = []
    for fn in (monarch_cuda.BandConvFunction.apply, monarch.band_conv_plain):
        xb, xk = b.clone().requires_grad_(), k_f.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(p, xb, xk), (xb, xk), dy))
    for a, r in zip(*grads):
        _band_close(a, r)


@pytest.fixture(scope="module")
def seq_mesh():
    """A 1-rank NCCL sequence mesh over an in-memory store."""
    _needs_card()
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    yield init_device_mesh("cuda", (1,), mesh_dim_names=("sp",))
    dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4096, 16384, 65536, 131072])
def test_cuda_seq_conv_world_size_1_matches_reference(seq_mesh, n):
    """seq_fft_conv (gated) and seq_fft_conv_padded at world size 1 on the
    card, output and grads, against the torch.fft oracle: the band_conv
    kernel up to N2 = 16384, the four real convs above."""
    from flashfftconv_tpu_torch.parallel import seq_conv

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(n)
    t = torch.arange(n, device=dev)
    u, pre, post = (torch.randn(2, 4, n, device=dev, generator=g) for _ in "abc")
    k = torch.randn(4, n, device=dev, generator=g) * 0.02 * torch.exp(-t / 1000)
    n0 = monarch_cuda.band_conv.launches
    y = seq_conv.seq_fft_conv(u, k, seq_mesh, pregate=pre, postgate=post)
    assert monarch_cuda.band_conv.launches == n0 + (n <= 16384)
    ref = monarch.fft_conv_reference(n, u, k, pre, post)
    _band_close(torch.complex(y, torch.zeros_like(y)), torch.complex(ref, torch.zeros_like(ref)))
    uh = u[..., : n // 2].clone().requires_grad_()
    kh = k[:, : n // 3].clone().requires_grad_()
    y = seq_conv.seq_fft_conv_padded(uh, kh, seq_mesh)
    ref = monarch.fft_conv_reference(n, uh, kh)
    dy = torch.randn(y.shape, device=dev, generator=g)
    pairs = [(y, ref), *zip(torch.autograd.grad(y, (uh, kh), dy),
                            torch.autograd.grad(ref, (uh, kh), dy))]
    for a, r in pairs:
        _band_close(torch.complex(a, torch.zeros_like(a)), torch.complex(r, torch.zeros_like(r)))


@pytest.mark.gpu
def test_cuda_long_backward_of_a_band_8192_plan():
    """A plan of FFT size 131072 with an 8192-point band: its backward on the
    card no longer raises (it runs under bwd_plan, band 4096) and matches
    the plain backward (conv_bwd_plain, dk_finish_plain)."""
    _needs_card()
    dev = torch.device("cuda")
    n = 131072
    p = tplan.make_plan(n, torch.float32, device=dev, factors=(8, 32, 16, 16))
    assert p.band == 8192
    g = torch.Generator(device=dev).manual_seed(8192)
    u, pre, post, dout = (torch.randn(2, 3, n // 2, device=dev, generator=g) for _ in "abcd")
    k = torch.randn(3, n // 2, device=dev, generator=g) * 0.02
    ts = [a.clone().requires_grad_() for a in (u, k, pre, post)]
    n0 = monarch_cuda.long_conv_bwd_inner.launches
    got = torch.autograd.grad(tff.fft_conv(p, *ts), ts, dout)
    assert monarch_cuda.long_conv_bwd_inner.launches == n0 + 1
    k_f = monarch.kernel_spectrum(p, k)
    du, dpre, dpost, parts = monarch.conv_bwd_plain(p, u, k_f, pre, post, dout)
    for a, r in zip(got, (du, monarch.dk_finish_plain(p, parts, k.shape[-1]), dpre, dpost)):
        _close(a, r, torch.float32)


# --- the flash-attention kernels ---------------------------------------------

def _attn_close(got, ref):
    """Kernel against plain: f32 within 2e-5 of the largest |value| or of 1
    where that is smaller (another summation order; grads that are 0 up to
    rounding, as dq at L = 1, round to about 1e-6), bf16 within one ulp of
    the largest |value|, f16 within one f16 ulp of it."""
    scale = float(ref.float().abs().max())
    tol = 2e-5 * max(1.0, scale) if ref.dtype == torch.float32 else ULP[ref.dtype] * scale + 1e-6
    assert float((got.float() - ref.float()).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("l,d", [(1, 64), (1, 128), (63, 64), (65, 128), (256, 64), (1000, 64),
                                 (1000, 128), (1000, 256), (65, 384), (300, 512), (130, 640),
                                 (65, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", ["causal", "noncausal", "alibi", "segments"])
def test_cuda_attention_kernels_match_plain(l, d, dtype, case):
    """flash_attn_fwd, flash_attn_bwd_dkv and flash_attn_bwd_dq against
    flash_attn_fwd_plain and flash_attn_bwd_plain, each launched once, at
    the edges of the 64-row tiles and 8-row tensor-core steps, and at
    head_dim 256, 384 and 512 (the wide bodies' 16-row parts) and 640 and
    1024 (their D slices)."""
    _needs_card()
    from flashfftconv_tpu_torch.ops import attention as plain
    from flashfftconv_tpu_torch.ops import attention_cuda as ac

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(l + d)
    q, k, v, do = (torch.randn(2, 3, l, d, device=dev, generator=g).to(dtype) for _ in "qkvd")
    causal = case != "noncausal"
    bias = plain.alibi_bias(3, l, l, device=dev) if case == "alibi" else None
    seg = None
    if case == "segments":
        seg = (torch.arange(l, device=dev) * 3 // max(l, 1)).int()[None].repeat(2, 1)
        seg[1] = 7
    counts = [f.launches for f in (ac.flash_attn_fwd, ac.flash_attn_bwd_dkv, ac.flash_attn_bwd_dq)]
    o, lse = ac.flash_attn_fwd(q, k, v, causal, None, bias, seg)
    delta = plain.attention_delta(o, do)
    dk, dv = ac.flash_attn_bwd_dkv(q, k, v, do, lse, delta, causal, None, bias, seg)
    dq, ds = ac.flash_attn_bwd_dq(q, k, v, do, lse, delta, causal, None, bias, seg,
                                  bias_grad=bias is not None)
    torch.cuda.synchronize()
    assert [f.launches for f in (ac.flash_attn_fwd, ac.flash_attn_bwd_dkv,
                                 ac.flash_attn_bwd_dq)] == [c + 1 for c in counts]
    ro, rlse = plain.flash_attn_fwd_plain(q, k, v, causal, None, bias, seg)
    rq, rk, rv, rds = plain.flash_attn_bwd_plain(q, k, v, o, lse, do, causal, None, bias, seg,
                                                 bias is not None)
    for got, ref in ((o, ro), (lse, rlse), (dq, rq), (dk, rk), (dv, rv)):
        _attn_close(got, ref)
    if bias is not None:
        _attn_close(ds, rds)


@pytest.mark.gpu
def test_cuda_flash_mha_grads_match_autograd_of_the_reference():
    """flash_mha through FlashAttnFunction on the card (the bias's grad
    summed to its (1, H, L, L) shape) against autograd through mha_reference,
    and two backwards bit for bit."""
    _needs_card()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(2, 4, 300, 64, device=dev, generator=g).requires_grad_()
               for _ in "qkv")
    bias = tff.alibi_bias(4, 300, 300, device=dev).requires_grad_()
    w = torch.randn(q.shape, device=dev, generator=g)
    grads = []
    for fn in (tff.flash_mha, tff.flash_mha, tff.mha_reference):
        grads.append(torch.autograd.grad((fn(q, k, v, bias=bias) * w).sum(), (q, k, v, bias)))
    assert all(torch.equal(a, b) for a, b in zip(grads[0], grads[1]))
    for got, ref in zip(grads[0], grads[2]):
        _attn_close(got, ref)


@pytest.mark.gpu
def test_cuda_attention_refuses_what_the_kernels_do_not_take():
    """impl='flash' raises for what the kernels do not take (head_dim,
    dtype), and so does impl='auto' where the JAX package's TPU kernel would
    take the call (a k shorter than q at L = 256); head_dim 640 runs the
    kernels under both and matches the plain version; B * H = 65792, past one grid
    dimension's 65535, runs the kernels and matches the plain version; a
    window with a bias or segment ids raises where the kernels would run, as
    on a TPU."""
    _needs_card()
    dev = torch.device("cuda")
    q = torch.randn(1, 2, 16, 32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        tff.flash_mha(q, q, q, impl="flash")
    q = torch.randn(1, 2, 16, 64, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError, match="f32, bf16 or f16"):
        tff.flash_mha(q, q, q, impl="flash")
    q = torch.randn(1, 2, 256, 640, device=dev)
    for impl in ("auto", "flash"):
        _attn_close(tff.flash_mha(q, q, q, impl=impl), tff.flash_mha(q, q, q, impl="xla"))
    k = torch.randn(1, 2, 128, 128, device=dev)
    for impl in ("auto", "flash"):
        with pytest.raises(ValueError, match="one shape"):
            tff.flash_mha(torch.randn(1, 2, 256, 128, device=dev), k, k, impl=impl)
    q = torch.randn(256, 257, 1, 64, device=dev)
    _attn_close(tff.flash_mha(q, q, q, impl="flash"), tff.flash_mha(q, q, q, impl="xla"))
    q = torch.randn(1, 2, 64, 64, device=dev)
    bias = tff.alibi_bias(2, 64, 64, device=dev)
    seg = torch.ones(1, 64, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="bias or segment ids"):
        tff.flash_mha(q, q, q, window=8, bias=bias)
    with pytest.raises(NotImplementedError, match="bias or segment ids"):
        tff.flash_mha(q, q, q, window=8, segment_ids=seg)
    ref = tff.flash_mha(q, q, q, window=8, bias=bias, impl="xla")  # the plain version when asked
    assert ref.shape == q.shape
    q = torch.randn(1, 2, 64, 32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        tff.flash_mha(q, q, q, window=8, impl="flash")
    with pytest.raises(ValueError, match="head_dim"):
        tff.blocksparse_mha(q, q, q, [[1, 0], [1, 1]], block_size=32, impl="flash")


@pytest.mark.gpu
def test_cuda_attention_auto_runs_the_kernels_in_f16():
    """f16 at head_dim 128, L = 256, a call the JAX package's TPU kernels
    take: flash_mha (causal and windowed) and blocksparse_mha under
    impl='auto' launch one forward kernel each and match their plain
    versions, forward and grads."""
    from flashfftconv_tpu_torch.ops import attention as plain
    from flashfftconv_tpu_torch.ops import attention_cuda as ac
    from flashfftconv_tpu_torch.ops.splash_mask import SplashMask

    _needs_card()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (torch.randn(2, 4, 256, 128, device=dev, generator=g).half().requires_grad_()
               for _ in "qkv")
    do = torch.randn(q.shape, device=dev, generator=g).half()
    blocks = [[1, 0], [1, 1]]
    for fn, keep in (
        (lambda *a: tff.flash_mha(*a), None),
        (lambda *a: tff.flash_mha(*a, window=40), SplashMask.local(256, 40).dense(dev)),
        (lambda *a: tff.blocksparse_mha(*a, blocks, block_size=128, causal=True),
         SplashMask.blocks(blocks, 128, True).dense(dev)),
    ):
        n0 = ac.flash_attn_fwd.launches + ac.splash_attn_fwd.launches
        o = fn(q, k, v)
        grads = torch.autograd.grad(o, (q, k, v), do)
        assert ac.flash_attn_fwd.launches + ac.splash_attn_fwd.launches == n0 + 1
        assert o.dtype == torch.float16
        with torch.no_grad():
            if keep is None:
                ro, lse = plain.flash_attn_fwd_plain(q, k, v, True)
                refs = plain.flash_attn_bwd_plain(q, k, v, o, lse, do, True)[:3]
            else:
                ro, lse = plain.splash_attn_fwd_plain(q, k, v, keep)
                refs = plain.splash_attn_bwd_plain(q, k, v, o, lse, do, keep)
        for got, ref in zip((o.detach(), *grads), (ro, *refs)):
            _attn_close(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [256, 384, 512, 640, 768, 1024, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_cuda_attention_runs_the_kernels_at_wide_head_dims(d, dtype, impl):
    """head_dim 256, 384 and 512, and above 512 (D slices) 640, 768, 1024
    and 2048, at L = 256 (a call the JAX package's TPU
    kernels take): flash_mha causal, non-causal, with ALiBi and with segment
    ids, a window and blocksparse_mha under impl='auto' and impl='flash'
    launch the kernels (one forward, one dK/dV, one dQ each) and match the
    plain versions, forward and grads (the bias's too)."""
    from flashfftconv_tpu_torch.ops import attention as plain
    from flashfftconv_tpu_torch.ops import attention_cuda as ac
    from flashfftconv_tpu_torch.ops.splash_mask import SplashMask

    _needs_card()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(d)
    l = 256
    q, k, v = (torch.randn(2, 3, l, d, device=dev, generator=g).to(dtype).requires_grad_()
               for _ in "qkv")
    do = torch.randn(q.shape, device=dev, generator=g).to(dtype)
    bias = plain.alibi_bias(3, l, l, device=dev).requires_grad_()
    seg = (torch.arange(l, device=dev) * 3 // l).int()[None].repeat(2, 1)
    blocks = [[1, 0], [1, 1]]
    fns = ("flash_attn_fwd", "splash_attn_fwd", "flash_attn_bwd_dkv", "splash_attn_bwd_dkv",
           "flash_attn_bwd_dq", "splash_attn_bwd_dq")
    for call, flash, kw in (
        (lambda *a: tff.flash_mha(*a, impl=impl), True, dict(causal=True)),
        (lambda *a: tff.flash_mha(*a, causal=False, impl=impl), True, dict(causal=False)),
        (lambda *a: tff.flash_mha(*a, bias=bias, impl=impl), True, dict(causal=True, bias=bias)),
        (lambda *a: tff.flash_mha(*a, segment_ids=seg, impl=impl), True,
         dict(causal=True, segment_ids=seg)),
        (lambda *a: tff.flash_mha(*a, window=40, impl=impl), False,
         dict(keep=SplashMask.local(l, 40).dense(dev))),
        (lambda *a: tff.blocksparse_mha(*a, blocks, block_size=128, causal=True, impl=impl),
         False, dict(keep=SplashMask.blocks(blocks, 128, True).dense(dev))),
    ):
        n0 = [getattr(ac, f).launches for f in fns]
        o = call(q, k, v)
        wrt = (q, k, v, bias) if "bias" in kw else (q, k, v)
        grads = torch.autograd.grad(o, wrt, do)
        torch.cuda.synchronize()
        want = [n + int(flash == f.startswith("flash")) for n, f in zip(n0, fns)]
        assert [getattr(ac, f).launches for f in fns] == want
        assert o.dtype == dtype
        with torch.no_grad():
            if flash:
                causal, b_, s_ = kw["causal"], kw.get("bias"), kw.get("segment_ids")
                ro, lse = plain.flash_attn_fwd_plain(q, k, v, causal, None, b_, s_)
                rq, rk, rv, rds = plain.flash_attn_bwd_plain(q, k, v, o, lse, do, causal, None,
                                                             b_, s_, b_ is not None)
                refs = (rq, rk, rv) + (() if b_ is None else (rds.sum_to_size(b_.shape),))
            else:
                ro, lse = plain.splash_attn_fwd_plain(q, k, v, kw["keep"])
                refs = plain.splash_attn_bwd_plain(q, k, v, o, lse, do, kw["keep"])
        for got, ref in zip((o.detach(), *grads), (ro, *refs)):
            _attn_close(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [768, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_cuda_attention_d_slices_agree_bit_for_bit(d, dtype):
    """Above head_dim 512 each D slice of a tile is a block of its own that
    computes the scores over all of D in the same order, and slice 0 alone
    writes the logsumexp: the slices' p, running max and row sums agree bit
    for bit. With q, k, v and do one 256-column block repeated, o, dk, dv
    and dq are that too, slice for slice, and match the plain versions."""
    _needs_card()
    from flashfftconv_tpu_torch.ops import attention as plain
    from flashfftconv_tpu_torch.ops import attention_cuda as ac

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(d)
    q, k, v, do = (torch.randn(2, 3, 300, ac.SLICE_DIM, device=dev, generator=g).to(dtype)
                   .repeat(1, 1, 1, d // ac.SLICE_DIM).contiguous() for _ in "qkvd")
    o, lse = ac.flash_attn_fwd(q, k, v, True)
    delta = plain.attention_delta(o, do)
    dk, dv = ac.flash_attn_bwd_dkv(q, k, v, do, lse, delta, True)
    dq, _ = ac.flash_attn_bwd_dq(q, k, v, do, lse, delta, True)
    for t in (o, dk, dv, dq):
        parts = t.split(ac.SLICE_DIM, -1)
        assert all(torch.equal(parts[0], x) for x in parts[1:])
    ro, rlse = plain.flash_attn_fwd_plain(q, k, v, True)
    rq, rk, rv, _ = plain.flash_attn_bwd_plain(q, k, v, o, lse, do, True)
    for got, ref in ((o, ro), (lse, rlse), (dq, rq), (dk, rk), (dv, rv)):
        _attn_close(got, ref)


@pytest.mark.gpu
def test_cuda_attention_auto_runs_the_plain_version_where_the_kernels_refuse():
    """impl='auto' on CUDA tensors the kernels do not take runs the plain
    version and matches it, forward and grads, launching no kernel, where
    the JAX package's 'auto' runs XLA too: head_dim 32
    (MHAOperator(d_model=256, num_heads=8)) in f32, f16 and bf16, through
    flash_mha, a window and blocksparse_mha against its dense-mask
    softmax."""
    from flashfftconv_tpu_torch.ops import attention_cuda as ac

    _needs_card()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    launches = (ac.flash_attn_fwd.launches, ac.flash_attn_bwd_dq.launches,
                ac.splash_attn_fwd.launches)
    for d, dtype in ((32, torch.float32), (32, torch.float16), (32, torch.bfloat16)):
        q, k, v = (torch.randn(2, 8, 256, d, device=dev, generator=g).to(dtype).requires_grad_()
                   for _ in "qkv")
        w = torch.randn(q.shape, device=dev, generator=g).to(dtype)
        mask = [[1, 0, 0, 0], [1, 1, 0, 0], [0, 1, 1, 0], [1, 0, 1, 1]]
        for fn, plain in (
            (lambda *a: tff.flash_mha(*a), lambda *a: tff.mha_reference(*a)),
            (lambda *a: tff.flash_mha(*a, window=40), lambda *a: tff.mha_reference(*a, window=40)),
            (lambda *a: tff.blocksparse_mha(*a, mask, block_size=64, causal=True),
             lambda *a: tff.blocksparse_mha(*a, mask, block_size=64, causal=True, impl="xla")),
        ):
            got, ref = fn(q, k, v), plain(q, k, v)
            assert got.dtype == dtype
            _attn_close(got, ref)
            for a, b in zip(torch.autograd.grad((got * w).sum(), (q, k, v)),
                            torch.autograd.grad((ref * w).sum(), (q, k, v))):
                _attn_close(a, b)
    assert launches == (ac.flash_attn_fwd.launches, ac.flash_attn_bwd_dq.launches,
                        ac.splash_attn_fwd.launches)


@pytest.mark.gpu
def test_cuda_gpt_matches_cpu():
    """A 2-layer f32 GPT with the same weights on the card (attention kernels)
    and the CPU (plain versions): logits and every grad."""
    _needs_card()
    kw = dict(d_model=128, n_layer=2, d_inner=256, vocab_size=100, l_max=200, num_heads=2,
              dtype=torch.float32)
    ids = torch.randint(0, 100, (2, 161), generator=torch.Generator().manual_seed(2))
    out = {}
    for dev in ("cpu", "cuda"):
        m = tff.GPTLMHeadModel(**kw, device=dev,
                               generator=torch.Generator().manual_seed(0)).eval()
        x, y = ids[:, :-1].to(dev), ids[:, 1:].to(dev)
        logits = m(x)
        torch.nn.functional.cross_entropy(logits.flatten(0, 1), y.flatten()).backward()
        out[dev] = (logits.detach().cpu(), {n: p.grad.cpu() for n, p in m.named_parameters()})
    assert float((out["cuda"][0] - out["cpu"][0]).abs().max()) <= 2e-3
    for name, grad in out["cuda"][1].items():
        ref = out["cpu"][1][name]
        assert float((grad - ref).abs().max()) <= 1e-3 * float(ref.abs().max()) + 1e-7, name


# --- the splash-attention kernels ---------------------------------------------

# (mask, L, head_dim, dtype, window or block size, causal)
SPLASH_CASES = [
    ("window", 2048, 64, torch.float32, 256, True), ("window", 300, 64, torch.float32, 100, True),
    ("window", 1000, 64, torch.bfloat16, 1, True), ("window", 65, 128, torch.float32, 1000, True),
    ("window", 256, 128, torch.bfloat16, 64, True),
    ("blocks", 1024, 128, torch.bfloat16, 256, True),
    ("blocks", 256, 64, torch.float32, 16, False), ("blocks", 80, 64, torch.float32, 16, True),
    ("empty_row", 256, 64, torch.float32, 64, False),
    # the edges of the backward's 64-row tiles, in every dtype
    ("window", 1, 64, torch.float16, 1, True), ("window", 63, 128, torch.float16, 20, True),
    ("window", 65, 64, torch.bfloat16, 30, True), ("window", 1000, 128, torch.float32, 300, True),
    ("blocks", 63, 128, torch.float16, 21, True), ("blocks", 65, 64, torch.bfloat16, 13, False),
    ("blocks", 1000, 64, torch.float16, 250, False),
    ("blocks", 1000, 128, torch.float32, 125, True),
    # head_dim 256, 384 and 512: the wide bodies (16 or 32 kept rows), the
    # wide backward
    ("window", 1000, 256, torch.float32, 300, True),
    ("window", 300, 384, torch.bfloat16, 100, True), ("window", 129, 512, torch.float16, 40, True),
    ("blocks", 1024, 512, torch.float32, 256, True), ("blocks", 65, 256, torch.bfloat16, 13, False),
    ("blocks", 400, 384, torch.float16, 100, False),
    # head_dim 640, 768 and 1024: the D slices
    ("window", 300, 640, torch.float32, 100, True), ("window", 129, 768, torch.bfloat16, 40, True),
    ("blocks", 256, 1024, torch.float16, 64, True), ("blocks", 130, 640, torch.bfloat16, 13, False),
]


def _splash_mask(kind, l, arg, causal):
    from flashfftconv_tpu_torch.ops.splash_mask import SplashMask

    if kind == "window":
        return SplashMask.local(l, arg)
    n = l // arg
    m = torch.rand(n, n, generator=torch.Generator().manual_seed(l + arg)) < 0.5
    m.fill_diagonal_(True)
    if kind == "empty_row":
        m[1] = False
    return SplashMask.blocks(m.numpy(), arg, causal)


def _exact_backward(q, k, v, do, lse, delta, keep):
    """(dq, dk, dv) in f64 from the backward kernels' own inputs: q, k, v,
    do and the f32 lse and delta they are given, under the (L, L) mask."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    s = ((q @ k.transpose(-1, -2)) * scale).masked_fill(~keep, float("-inf"))
    p = torch.exp(s - lse.double()[..., None])
    ds = p * (do @ v.transpose(-1, -2) - delta.double()[..., None])
    return (ds @ k) * scale, (ds.transpose(-1, -2) @ q) * scale, p.transpose(-1, -2) @ do


@pytest.mark.gpu
@pytest.mark.parametrize("kind,l,d,dtype,arg,causal", SPLASH_CASES)
def test_cuda_splash_kernels_match_plain(kind, l, d, dtype, arg, causal, record_property):
    """splash_attn_fwd against splash_attn_fwd_plain, and splash_attn_bwd_dkv
    and splash_attn_bwd_dq against the same backward in f64 on their own
    inputs, under the dense mask, each launched once; an empty row block
    gives exact zeros; two backwards bit for bit. The grads' reference is
    f64 because at window 1 dq and dk cancel to 0 up to the rounding of
    dp - delta, where the f32 plain version (splash_attn_bwd_plain) is
    itself as far from the exact value as the bound; its error and the
    kernels' are recorded as properties (junitxml)."""
    _needs_card()
    from flashfftconv_tpu_torch.ops import attention as plain
    from flashfftconv_tpu_torch.ops import attention_cuda as ac

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(l + d + arg)
    b, h = (2, 3) if l < 2048 else (1, 4)
    q, k, v, do = (torch.randn(b, h, l, d, device=dev, generator=g).to(dtype) for _ in "qkvd")
    mask = _splash_mask(kind, l, arg, causal)
    fns = (ac.splash_attn_fwd, ac.splash_attn_bwd_dkv, ac.splash_attn_bwd_dq)
    counts = [f.launches for f in fns]
    o, lse = ac.splash_attn_fwd(q, k, v, mask)
    delta = plain.attention_delta(o, do)
    dk, dv = ac.splash_attn_bwd_dkv(q, k, v, do, lse, delta, mask)
    dq = ac.splash_attn_bwd_dq(q, k, v, do, lse, delta, mask)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [c + 1 for c in counts]
    keep = mask.dense(dev)
    ro, rlse = plain.splash_attn_fwd_plain(q, k, v, keep)
    _attn_close(o, ro)
    rq, rk, rv = plain.splash_attn_bwd_plain(q, k, v, o, lse, do, keep)
    exact = _exact_backward(q, k, v, do, lse, delta, keep)
    for name, got, ref, ex in zip(("dq", "dk", "dv"), (dq, dk, dv), (rq, rk, rv), exact):
        record_property(f"{name}_kernel_err", float((got.double() - ex).abs().max()))
        record_property(f"{name}_plain_err", float((ref.double() - ex).abs().max()))
        _attn_close(got, ex.to(dtype))
    seen = torch.isfinite(rlse)  # +inf on a row that sees no key
    assert torch.equal(torch.isfinite(lse), seen)
    _attn_close(lse[seen], rlse[seen])
    if kind == "empty_row":
        assert not o[:, :, 64:128].any() and not dq[:, :, 64:128].any()
        assert torch.isinf(lse[:, :, 64:128]).all()
    again = ac.splash_attn_bwd_dkv(q, k, v, do, lse, delta, mask) + (
        ac.splash_attn_bwd_dq(q, k, v, do, lse, delta, mask),)
    assert all(torch.equal(x, y) for x, y in zip((dk, dv, dq), again))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["flash", "window"])
def test_cuda_attention_kernels_take_any_batch_times_heads(kind):
    """B * H = 65792 (B=257, H=256), past one grid dimension's 65535: the
    forward, dK/dV and dQ kernels, flash (causal) and splash (a window of
    16), each launched once, against their plain versions."""
    _needs_card()
    from flashfftconv_tpu_torch.ops import attention as plain
    from flashfftconv_tpu_torch.ops import attention_cuda as ac
    from flashfftconv_tpu_torch.ops.splash_mask import SplashMask

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, do = (torch.randn(257, 256, 40, 64, device=dev, generator=g) for _ in "qkvd")
    if kind == "flash":
        fns = (ac.flash_attn_fwd, ac.flash_attn_bwd_dkv, ac.flash_attn_bwd_dq)
        counts = [f.launches for f in fns]
        o, lse = ac.flash_attn_fwd(q, k, v)
        delta = plain.attention_delta(o, do)
        got = (o, *ac.flash_attn_bwd_dkv(q, k, v, do, lse, delta),
               ac.flash_attn_bwd_dq(q, k, v, do, lse, delta)[0])
        ro, rlse = plain.flash_attn_fwd_plain(q, k, v)
        rq, rk, rv, _ = plain.flash_attn_bwd_plain(q, k, v, o, lse, do)
    else:
        mask = SplashMask.local(40, 16)
        fns = (ac.splash_attn_fwd, ac.splash_attn_bwd_dkv, ac.splash_attn_bwd_dq)
        counts = [f.launches for f in fns]
        o, lse = ac.splash_attn_fwd(q, k, v, mask)
        delta = plain.attention_delta(o, do)
        got = (o, *ac.splash_attn_bwd_dkv(q, k, v, do, lse, delta, mask),
               ac.splash_attn_bwd_dq(q, k, v, do, lse, delta, mask))
        keep = mask.dense(dev)
        ro, rlse = plain.splash_attn_fwd_plain(q, k, v, keep)
        rq, rk, rv = plain.splash_attn_bwd_plain(q, k, v, o, lse, do, keep)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [c + 1 for c in counts]
    for a, r in zip((*got, lse), (ro, rk, rv, rq, rlse)):
        _attn_close(a, r)


@pytest.mark.gpu
@pytest.mark.parametrize("l,d,dtype", [(1000, 64, torch.float32), (256, 128, torch.bfloat16)])
def test_cuda_splash_window_of_at_least_l_is_the_causal_flash_kernel(l, d, dtype):
    """A window W >= L keeps the causal half: the splash kernels give the
    causal flash kernels' numbers."""
    _needs_card()
    from flashfftconv_tpu_torch.ops import attention as plain
    from flashfftconv_tpu_torch.ops import attention_cuda as ac
    from flashfftconv_tpu_torch.ops.splash_mask import SplashMask

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(l)
    q, k, v, do = (torch.randn(2, 3, l, d, device=dev, generator=g).to(dtype) for _ in "qkvd")
    mask = SplashMask.local(l, l + 5)
    o, lse = ac.splash_attn_fwd(q, k, v, mask)
    fo, flse = ac.flash_attn_fwd(q, k, v, True)
    delta = plain.attention_delta(o, do)
    got = (o, lse, *ac.splash_attn_bwd_dkv(q, k, v, do, lse, delta, mask),
           ac.splash_attn_bwd_dq(q, k, v, do, lse, delta, mask))
    ref = (fo, flse, *ac.flash_attn_bwd_dkv(q, k, v, do, flse, delta, True),
           ac.flash_attn_bwd_dq(q, k, v, do, flse, delta, True)[0])
    for a, r in zip(got, ref):
        _attn_close(a, r)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["window", "blocks"])
def test_cuda_splash_grads_match_autograd_of_the_reference(kind):
    """flash_mha(window=W) and blocksparse_mha through SplashAttnFunction on
    the card against autograd through their plain versions (impl="xla")."""
    _needs_card()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(2, 4, 384, 64, device=dev, generator=g).requires_grad_()
               for _ in "qkv")
    w = torch.randn(q.shape, device=dev, generator=g)
    mask = [[1, 0, 0], [1, 1, 0], [0, 1, 1]]
    if kind == "window":
        fn = lambda impl: tff.flash_mha(q, k, v, window=100, impl=impl)
    else:
        fn = lambda impl: tff.blocksparse_mha(q, k, v, mask, block_size=128, causal=True,
                                              impl=impl)
    got, ref = (torch.autograd.grad((fn(impl) * w).sum(), (q, k, v)) for impl in ("auto", "xla"))
    for a, r in zip(got, ref):
        _attn_close(a, r)


@pytest.mark.gpu
def test_cuda_windowed_gpt_matches_cpu():
    """A 2-layer f32 GPT with mixer_kwargs={"window": 64} on the card (splash
    kernels) and the CPU (plain versions): logits and every grad."""
    _needs_card()
    from flashfftconv_tpu_torch.ops import attention_cuda as ac

    kw = dict(d_model=128, n_layer=2, d_inner=256, vocab_size=100, l_max=300, num_heads=2,
              mixer_kwargs={"window": 64}, dtype=torch.float32)
    ids = torch.randint(0, 100, (2, 257), generator=torch.Generator().manual_seed(2))
    out = {}
    n0 = ac.splash_attn_fwd.launches
    for dev in ("cpu", "cuda"):
        m = tff.GPTLMHeadModel(**kw, device=dev,
                               generator=torch.Generator().manual_seed(0)).eval()
        x, y = ids[:, :-1].to(dev), ids[:, 1:].to(dev)
        logits = m(x)
        torch.nn.functional.cross_entropy(logits.flatten(0, 1), y.flatten()).backward()
        out[dev] = (logits.detach().cpu(), {n: p.grad.cpu() for n, p in m.named_parameters()})
    assert ac.splash_attn_fwd.launches == n0 + 2
    assert float((out["cuda"][0] - out["cpu"][0]).abs().max()) <= 2e-3
    for name, grad in out["cuda"][1].items():
        ref = out["cpu"][1][name]
        assert float((grad - ref).abs().max()) <= 1e-3 * float(ref.abs().max()) + 1e-7, name


# --- the shared-memory probe, a kernel as long as the FFT, H3 and Long Conv ----------

@pytest.mark.gpu
def test_cuda_smem_probe_touch_sweep():
    """The sweep on the card: every size that launched returns 4.0, the
    largest working size is the opt-in attribute on the grid (227 KB on an
    H100), the refusal is the expected error, and a second launch at the
    largest size works."""
    _needs_card()
    from flashfftconv_tpu_torch.utils import smem_probe as sp

    attrs = sp.device_attrs("cuda")
    x = torch.ones(sp.PROBE_SHAPE, device="cuda")
    n0 = sp.smem_probe_touch.launches
    records, best = sp.sweep(lambda nbytes: sp.smem_probe_touch(x, nbytes))
    assert best == sp.grid_floor(attrs["max_shared_per_block_optin"]) > 48 * 1024
    assert all(r["max_abs_err"] == 0.0 for r in records if r["ok"])
    assert sp.smem_probe_touch.launches == n0 + sum(r["ok"] for r in records)
    assert torch.equal(sp.smem_probe_touch(x, best), sp.touch_plain(x))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("tile_kb", [16, 64, 227])
def test_cuda_smem_copy_matches_plain_bit_for_bit(tile_kb):
    """x * 1.0001 through shared-memory tiles, over a ragged last tile."""
    _needs_card()
    from flashfftconv_tpu_torch.utils import smem_probe as sp

    x = torch.randn(3_000_004, generator=torch.Generator().manual_seed(tile_kb)).cuda()
    n0 = sp.smem_copy.launches
    y = sp.smem_copy(x, tile_kb * 1024)
    torch.cuda.synchronize()
    assert sp.smem_copy.launches == n0 + 1
    assert torch.equal(y, torch.mul(x, 1.0001))
    with pytest.raises(ValueError):
        sp.smem_copy(x[:3], 16 * 1024)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [256, 4096, 16384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fft_conv_with_a_kernel_as_long_as_the_fft(n, dtype):
    """k_len = N (a LongConv kernel): the second half of the taps reaches the
    output by the circular wrap. Output and grads of FftConvFunction on the
    card against the torch.fft oracle: f32 within 2e-5 of the largest value,
    bf16 within one bf16 ulp of it; dk within 1e-4 of its largest value."""
    _needs_card()
    from flashfftconv_tpu_torch.ops import dispatch

    p = tplan.get_plan(n, dtype, "cuda")
    g = torch.Generator().manual_seed(n)
    u = torch.randn(4, 8, n // 2, generator=g).to("cuda", dtype).requires_grad_()
    k = (torch.randn(8, n, generator=g) * 0.02).cuda().requires_grad_()
    dy = torch.randn(4, 8, n // 2, generator=g).to("cuda", dtype)
    y = dispatch.fft_conv(p, u, k)
    du, dk = torch.autograd.grad(y, (u, k), dy)
    uf, kf = u.detach().float().requires_grad_(), k.detach().requires_grad_()
    r = monarch.fft_conv_reference(n, uf, kf)
    ru, rk = torch.autograd.grad(r, (uf, kf), dy.float())
    _close(y, r, dtype)
    _close(du, ru, dtype)
    err = float((dk - rk).abs().max())
    assert err <= 1e-4 * float(rk.abs().max()), err


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["h3", "h3_shift_s4d", "long-conv", "listops"])
def test_cuda_h3_and_long_conv_models_match_cpu(kind):
    """Small f32 models with the same weights on the card (kernels) and the
    CPU (plain versions): logits within 1e-4 of the largest |logit| and
    every parameter's grad within 1e-4 of its largest |grad|."""
    _needs_card()
    from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel
    from flashfftconv_tpu_torch.models.long_conv import LongConvModel
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy

    ids = torch.randint(1, 64, (2, 257), generator=torch.Generator().manual_seed(4))
    out, grads = {}, {}
    for dev in ("cpu", "cuda"):
        gen = torch.Generator().manual_seed(5)
        if kind == "listops":
            m = LongConvModel(16, d_model=32, n_layers=2, l_max=256, kernel_lam=0.001,
                              conv_dtype=torch.float32, device=dev, generator=gen).eval()
            x = torch.nn.functional.one_hot(ids[:, :-1] % 16, 16).float().to(dev)
            out[dev] = m(x, mask=(ids[:, :-1] % 16 != 0).to(dev))
            cross_entropy(out[dev], ids[:, 0].to(dev) % 10).backward()
        else:
            mk = {"conv_dtype": torch.float32}
            if kind == "h3_shift_s4d":
                mk.update(head_dim=2, k_kernel_type="shift", ssm_kernel_type="s4d", d_state=16)
            m = ConvLMHeadModel(d_model=32, n_layer=2, d_inner=64, vocab_size=64, l_max=256,
                                mixer=kind.split("_")[0], mixer_kwargs=mk, dtype=torch.float32,
                                device=dev, generator=gen).eval()
            out[dev] = m(ids[:, :-1].to(dev))
            cross_entropy(out[dev], ids[:, 1:].to(dev)).backward()
        grads[dev] = {n: p.grad.cpu() for n, p in m.named_parameters() if p.grad is not None}
    ref = out["cpu"].detach()
    assert float((out["cuda"].detach().cpu() - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert set(grads["cuda"]) == set(grads["cpu"])
    for name, r in grads["cpu"].items():
        err = float((grads["cuda"][name] - r).abs().max())
        assert err <= 1e-4 * float(r.abs().max()) + 1e-8, (name, err)


# --- the attention encoders and the MoE LM -------------------------------------

def _padding_segments(b, l, lo, g, dev):
    """int32 (B, L) segment ids of a padding mask: 1 on each row's first n
    positions (n drawn in [lo, L]), 0 on the padded tail."""
    n = torch.randint(lo, l + 1, (b, 1), generator=g)
    return (torch.arange(l)[None] < n).int().to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["vit_bf16", "vit_f32", "bert"])
def test_cuda_attention_kernels_at_the_encoder_shapes(shape):
    """The three flash kernels, non-causal, against their plain versions at
    ViT-B/16's shape (B=8, H=12, L=197 = 196 patches and a cls token, D=64:
    the last 64-row tile holds 5 rows), in bf16 and in f32 (the ViT's path
    promotes q, k, v to f32), and at BERT-base's (B=16, H=12, L=128, D=64,
    f32, segment ids from a padding mask: pads attend only to pads); then
    FlashAttnFunction's grads against autograd through mha_reference."""
    _needs_card()
    from flashfftconv_tpu_torch.ops import attention as plain
    from flashfftconv_tpu_torch.ops import attention_cuda as ac

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(197)
    b, l, dtype = {"vit_bf16": (8, 197, torch.bfloat16), "vit_f32": (8, 197, torch.float32),
                   "bert": (16, 128, torch.float32)}[shape]
    q, k, v, do = (torch.randn(b, 12, l, 64, generator=g).to(dev, dtype) for _ in "qkvd")
    seg = _padding_segments(b, l, 64, g, dev) if shape == "bert" else None
    counts = [f.launches for f in (ac.flash_attn_fwd, ac.flash_attn_bwd_dkv, ac.flash_attn_bwd_dq)]
    o, lse = ac.flash_attn_fwd(q, k, v, False, None, None, seg)
    delta = plain.attention_delta(o, do)
    dk, dv = ac.flash_attn_bwd_dkv(q, k, v, do, lse, delta, False, None, None, seg)
    dq, _ = ac.flash_attn_bwd_dq(q, k, v, do, lse, delta, False, None, None, seg)
    torch.cuda.synchronize()
    assert [f.launches for f in (ac.flash_attn_fwd, ac.flash_attn_bwd_dkv,
                                 ac.flash_attn_bwd_dq)] == [c + 1 for c in counts]
    ro, rlse = plain.flash_attn_fwd_plain(q, k, v, False, None, None, seg)
    rq, rk, rv, _ = plain.flash_attn_bwd_plain(q, k, v, o, lse, do, False, None, None, seg)
    for got, ref in ((o, ro), (lse, rlse), (dq, rq), (dk, rk), (dv, rv)):
        _attn_close(got, ref)
    qs, ks, vs = (t.float().requires_grad_() for t in (q, k, v))
    grads = [torch.autograd.grad((fn(qs, ks, vs, causal=False, segment_ids=seg) * do.float())
                                 .sum(), (qs, ks, vs))
             for fn in (tff.flash_mha, tff.mha_reference)]
    for got, ref in zip(*grads):
        _attn_close(got, ref)


def _model_vs_cpu(build, inputs, loss_of, rel=1e-4):
    """The model built on the card and on the CPU from one seed: outputs
    within ``rel`` of the largest |output|, every parameter's grad within
    ``rel`` of its largest |grad|."""
    out, grads = {}, {}
    for dev in ("cpu", "cuda"):
        m = build(dev).eval()
        out[dev] = m(*(t.to(dev) if torch.is_tensor(t) else t for t in inputs))
        loss_of(out[dev], dev).backward()
        grads[dev] = {n: p.grad.cpu() for n, p in m.named_parameters() if p.grad is not None}
    ref = out["cpu"].detach()
    err = float((out["cuda"].detach().cpu() - ref).abs().max())
    assert err <= rel * float(ref.abs().max()), err
    assert set(grads["cuda"]) == set(grads["cpu"])
    for name, r in grads["cpu"].items():
        err = float((grads["cuda"][name] - r).abs().max())
        assert err <= rel * float(r.abs().max()) + 1e-8, (name, err)


@pytest.mark.gpu
def test_cuda_encoders_match_cpu():
    """A 2-layer f32 ViT (token pool, 17 tokens) and a 2-layer f32 attention
    BertForMaskedLM with a padded row, both with 2 heads of 64, on the card (flash kernels, one
    forward and one backward a layer) and on the CPU (plain versions)."""
    _needs_card()
    from flashfftconv_tpu_torch.ops import attention_cuda as ac
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy

    g = torch.Generator().manual_seed(6)
    imgs = torch.randn(2, 32, 32, 3, generator=g)
    labels = torch.tensor([1, 7])
    n0 = ac.flash_attn_fwd.launches, ac.flash_attn_bwd_dq.launches
    _model_vs_cpu(
        lambda dev: tff.VisionTransformer(10, img_size=32, patch_size=8, d_model=128, n_layer=2,
                                          num_heads=2, dtype=torch.float32, device=dev,
                                          generator=torch.Generator().manual_seed(7)),
        (imgs,), lambda y, dev: cross_entropy(y, labels.to(dev)))
    ids = torch.randint(0, 50, (2, 40), generator=g)
    mask = torch.ones(2, 40, dtype=torch.int64)
    mask[1, 25:] = 0
    mlm = torch.where(torch.rand(2, 40, generator=g) < 0.3, ids, -100).masked_fill(mask == 0, -100)
    _model_vs_cpu(
        lambda dev: tff.BertForMaskedLM(50, d_model=128, n_layer=2, d_inner=96, num_heads=2,
                                        l_max=64, device=dev,
                                        generator=torch.Generator().manual_seed(8)),
        (ids, None, mask), lambda y, dev: cross_entropy(y, mlm.to(dev), -100))
    assert (ac.flash_attn_fwd.launches - n0[0], ac.flash_attn_bwd_dq.launches - n0[1]) == (4, 4)


@pytest.mark.gpu
def test_cuda_moe_lm_matches_cpu():
    """A 2-layer f32 Hyena LM with MoE MLPs (4 experts, top-2, capacity
    1.25, so some tokens drop; l_max 1024, 256 tokens) on the card (Monarch
    and depthwise kernels) and on the CPU: logits and every parameter's
    grad, routing included."""
    _needs_card()
    from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy

    ids = torch.randint(0, 64, (2, 129), generator=torch.Generator().manual_seed(9))
    n0 = monarch_cuda.monarch_conv.launches
    _model_vs_cpu(
        lambda dev: ConvLMHeadModel(d_model=32, n_layer=2, d_inner=48, vocab_size=64, l_max=1024,
                                    mixer_kwargs={"conv_dtype": torch.float32},
                                    moe_kwargs={"n_experts": 4, "top_k": 2},
                                    dtype=torch.float32, device=dev,
                                    generator=torch.Generator().manual_seed(10)),
        (ids[:, :-1],), lambda y, dev: cross_entropy(y, ids[:, 1:].to(dev)))
    assert monarch_cuda.monarch_conv.launches == n0 + 2
