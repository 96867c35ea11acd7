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
@pytest.mark.parametrize("n", [256, 4096, 16384, 32768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_conv_backward_kernels_match_plain(n, dtype):
    """monarch_conv_bwd and dk_finish against conv_bwd_plain and
    dk_finish_plain; dk and the partials are f32 at f32 tolerance."""
    _needs_card()
    dev = torch.device("cuda")
    p = tplan.make_plan(n, dtype, device=dev)
    g = torch.Generator().manual_seed(n + 1)
    for b, h, length, gated in [(4, 16, n // 2, False), (3, 7, n - 5, True)]:
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
        for a, r in zip(got[:3], ref[:3]):
            if r is not None:
                _close(a, r, dtype)
        _close(torch.view_as_real(got[3]), torch.view_as_real(ref[3]), torch.float32)
        _close(dk, monarch.dk_finish_plain(p, ref[3], length), torch.float32)


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


@pytest.mark.gpu
@pytest.mark.parametrize("n", [16, 64, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_direct_kernels_match_plain(n, dtype):
    """spectrum -> direct_conv and direct_conv_bwd -> dk_finish against their
    plain versions, one launch each; B = 4 ungated at L = N/2, B = 3 gated at
    L = N/2 + 3 with H = 7, and B = 20 gated at L = N (two chunks of the
    backward's batch walk at N = 256); a second backward gives the same
    bits."""
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
        ref = monarch.direct_conv_bwd_plain(p, u, k_f, *gates, d)
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
    dk spectrum, and dk, against the plain versions; eight chunks of the
    backward's batch walk, summed in the same order twice."""
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
    ref = monarch.direct_conv_bwd_plain(p, u, k_f, None, None, d)
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
