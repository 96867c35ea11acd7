"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: f32 outputs within 2e-5 of the largest |output| (FFT roundoff
is ~1e-6 of it at N = 32768); bf16 and f16 outputs within one ulp of the
largest |output| (kernel and plain round the same f32 value once).
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
    """The same operator weights on the card (kernels) and the CPU (plain)."""
    _needs_card()
    ops = {dev: HyenaOperator(64, 512, conv_dtype=torch.float32, device=dev,
                              generator=torch.Generator().manual_seed(0)) for dev in ("cpu", "cuda")}
    u = torch.randn(3, 500, 64, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        ref = ops["cpu"](u)
        got = ops["cuda"](u.cuda()).cpu()
    _close(got, ref, torch.float32)


@pytest.mark.gpu
def test_cuda_wrappers_refuse_grad_and_bad_inputs():
    _needs_card()
    dev = torch.device("cuda")
    p = tplan.make_plan(1024, torch.float32, device=dev)
    k = torch.randn(4, 512, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="slice 2"):
        monarch_cuda.spectrum(p, k)
    with torch.no_grad():
        k_f = monarch_cuda.spectrum(p, k)
    u = torch.randn(2, 4, 512, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        monarch_cuda.monarch_conv(p, u.transpose(0, 1).contiguous().transpose(0, 1), k_f)
    with pytest.raises(TypeError):
        monarch_cuda.monarch_conv(p, u.half(), k_f)
    with pytest.raises(NotImplementedError, match="slice 2"):
        tdw.depthwise(u, torch.randn(4, 3, device=dev, requires_grad=True), None, 1, True)
    y = tff.FlashFFTConv(1024, torch.float32)(u, k.detach())
    _close(y, tff.fft_conv_reference(1024, u, k.detach()), torch.float32)
