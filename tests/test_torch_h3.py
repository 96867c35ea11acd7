"""Parity of the port's SSM kernel generators, H3 operator and the LM's
h3 and m2 mixers with the flax modules, on the CPU.

The flax modules are initialised from a JAX key; their parameters go to the
port through ``utils.jax_weights``; inputs come from numpy with a seed. The
JAX side runs its Pallas FFT-conv kernels in interpret mode where a test
says ``impl="pallas"``, else its XLA path; the port runs its plain versions.

Tolerances: the kernel generators at 1e-5 of their largest |tap| (S4D's
complex64 Vandermonde exp(dt A t) and c_eff = C (exp(dt A) - 1) / A at f32
parameters round at about 1e-6 of it; the numpy HiPPO and DPLR tables are
float64 copies and must be equal); f32 operator outputs at 1e-4 of their
largest |value| and f32 logits at 2e-3 (the FFT conv's and the matmuls'
summation orders); every parameter's grad at 1e-4 of its largest |grad|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashfftconv_tpu.models import h3 as jh3
from flashfftconv_tpu.models import ssm as jssm
from flashfftconv_tpu_torch.models import h3, ssm
from flashfftconv_tpu_torch.models.lm import Block
from flashfftconv_tpu_torch.utils import jax_weights

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

CPU = "cpu"


def _np(x):
    return np.array(x, np.float32)


def _init(model, *args):
    params = model.init(jax.random.PRNGKey(0), *args)["params"]
    return params, jax.tree_util.tree_map(np.asarray, params)


def _load(module, state):
    module.load_state_dict({k: v for k, v in state.items()}, strict=True)
    return module


def _close(got, ref, rel):
    ref = _np(ref)
    np.testing.assert_allclose(_np(got), ref, atol=rel * float(np.abs(ref).max()) + 1e-7)


# --- the numpy initialisations ------------------------------------------------

@pytest.mark.parametrize("measure", ["legs", "legt", "fourier"])
def test_hippo_transition_is_the_jax_package_table(measure):
    a, b = ssm.hippo_transition(measure, 16)
    ja, jb = jssm.hippo_transition(measure, 16)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)


@pytest.mark.parametrize("measure", ["lin", "inv", "legs"])
def test_dplr_diag_init_is_the_jax_package_table(measure):
    np.testing.assert_array_equal(ssm.dplr_diag_init(measure, 32),
                                  jssm.dplr_diag_init(measure, 32))
    with pytest.raises(NotImplementedError):
        ssm.dplr_diag_init("nope", 8)


# --- kernel generators ----------------------------------------------------------


@pytest.mark.parametrize("length", [40, 100])
def test_ss_kernel_shift_matches_flax(length):
    jm = jssm.SSKernelShift(h=8, d_state=64, channels=2)
    params, pnp = _init(jm, length)
    tm = _load(ssm.SSKernelShift(8, d_state=64, channels=2, device=CPU),
               jax_weights._leaves(pnp, ""))
    got = tm(length)
    assert got.shape == (2, 8, length)
    _close(got.detach(), jm.apply({"params": params}, length), 1e-5)


def test_simple_long_conv_kernel_matches_flax():
    jm = jssm.SimpleLongConvKernel(h=6, channels=2)
    params, pnp = _init(jm, 64)
    tm = _load(ssm.SimpleLongConvKernel(6, 64, channels=2, device=CPU),
               jax_weights._leaves(pnp, ""))
    _close(tm(64).detach(), jm.apply({"params": params}, 64), 1e-6)
    with pytest.raises(ValueError):
        tm(32)


@pytest.mark.parametrize("n,learn", [(256, True), (2048, False), (65536, True)])
def test_block_fft_matches_flax(n, learn):
    """The blocked DFT against the flax BlockFFT, and the exact FFT in the
    Monarch layout (out[k1, k2] = X[k1 + f1 k2])."""
    jm = jssm.BlockFFT(n=n, learn_dft=learn)
    rng = np.random.default_rng(n)
    xr, xi = (rng.standard_normal((3, n)).astype(np.float32) for _ in "ab")
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(xr), jnp.asarray(xi))
    ref = jm.apply(params, jnp.asarray(xr), jnp.asarray(xi))
    tm = ssm.BlockFFT(n, learn_dft=learn, device=CPU)
    if learn:
        _load(tm, jax_weights._leaves(jax.tree_util.tree_map(np.asarray, params["params"]), ""))
    assert tm.factors == jm.bind(params)._plan.factors
    got = tm(torch.from_numpy(xr), torch.from_numpy(xi))
    for g, r in zip(got, ref):
        _close(g.detach(), r, 1e-5)
    f1, f2 = tm.factors
    spec = np.fft.fft(xr + 1j * xi)
    want = spec.reshape(3, f2, f1).transpose(0, 2, 1)
    np.testing.assert_allclose(got[0].detach().numpy(), want.real,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("width", [3, 4, 6, 7])
def test_convolve_same_matches_jnp(width):
    """jnp.convolve(mode="same") centres an even window one sample earlier
    than a symmetric pad would: the port follows it."""
    rng = np.random.default_rng(width)
    rows = rng.standard_normal((5, 33)).astype(np.float32)
    w = rng.standard_normal(width).astype(np.float32)
    ref = np.stack([np.asarray(jnp.convolve(r, w, mode="same")) for r in rows])
    got = h3.convolve_same(torch.from_numpy(rows), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


KERNEL_OPTIONS = {
    "random": {},
    "double_exp": dict(weight_init="double_exp"),
    "time_smoothing_7": dict(use_ma_smoothing=True, ma_window_len=7),
    "time_smoothing_5": dict(use_ma_smoothing=True, ma_window_len=5),
    "freq_smoothing_7": dict(use_ma_smoothing=True, smooth_freq=True, ma_window_len=7),
    "freq_smoothing_4": dict(use_ma_smoothing=True, smooth_freq=True, ma_window_len=4),
    "bandlimit": dict(bandlimit=0.25),
    "not_causal_channels": dict(causal=False, channels=2),
}


@pytest.mark.parametrize("name", list(KERNEL_OPTIONS))
def test_long_conv_kernel_matches_flax(name):
    opts = KERNEL_OPTIONS[name]
    jm = jh3.LongConvKernel(h=12, l_max=96, lam=0.001, **opts)
    params, pnp = _init(jm)
    ref = jm.apply({"params": params})
    tm = _load(h3.LongConvKernel(12, 96, lam=0.001, **opts, device=CPU),
               jax_weights._leaves(pnp, ""))
    got = tm()
    assert got.shape == ref.shape
    _close(got.detach(), ref, 1e-5)
    if name == "double_exp":  # the init's envelope: every tap within 0.02 * 5 sigma * decay
        t = torch.arange(96) / 96
        envelope = torch.exp(-t[None] * (12 / 2) ** (torch.arange(12)[:, None] / 12))
        fresh = h3.LongConvKernel(12, 96, weight_init="double_exp", device=CPU,
                                  generator=torch.Generator().manual_seed(0)).kernel
        assert bool((fresh.abs() <= 0.1 * envelope + 1e-12).all())


def test_long_conv_kernel_refuses_what_flax_refuses():
    with pytest.raises(ValueError, match="odd"):
        h3.LongConvKernel(4, 16, use_ma_smoothing=True, ma_window_len=4, device=CPU)
    with pytest.raises(NotImplementedError):
        h3.LongConvKernel(4, 16, weight_init="nope", device=CPU)


# --- the operator ---------------------------------------------------------------


# --- the LM's new mixers ------------------------------------------------------


def test_block_builds_every_mixer_of_the_registry():
    """Block takes every mixer name of the JAX registry and refuses others."""
    for mixer in ("hyena", "m2", "h3", "long-conv", "mha"):
        kw = {"l_max": 64, **({"num_heads": 2} if mixer == "mha" else {})}
        blk = Block(16, 32, mixer=mixer, mixer_kwargs=kw, device=CPU)
        with torch.no_grad():
            assert blk(torch.randn(2, 64, 16)).shape == (2, 64, 16)
    with pytest.raises(ValueError, match="unknown mixer"):
        Block(16, 32, mixer="nope", device=CPU)
