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

The long backward: the port's chain (``long_conv_bwd`` and
``long_dk_finish``, whose CPU path is the plain versions
``long_conv_bwd_inner_plain`` and ``long_dk_finish_plain``) against the JAX
package's fused backward functions ``_long_bwd_fused`` (3-factor plan,
``_long_bwd_tiles``) and ``_long4_bwd_fused`` (4-factor plan, with
``_butterfly_tiles``), called directly in interpret mode as the JAX tests
call them, with the forward's tolerances: f32 grads at 1e-4 of
max(1, largest |grad|), bf16 grads at 1e-2 with the inputs scaled so that
every grad stays within 0.5; ``long_dk_finish`` against
``_inverse_long_dft`` (``_inv_dft_tiles``) on the same spectrum at 1e-5 of
the largest |value|.
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


@pytest.mark.parametrize("n,factors", [(n, None) for n in LONG_SIZES]
                         + [(131072, (8, 32, 16, 16)), (2097152, (16, 8, 32, 16, 16))])
def test_long_spectrum_band_split_stores_each_frequency_once(n, factors):
    """The long_spectrum kernels' index maps, modelled in numpy from
    csrc/long_spectrum.cu: the block of band pair {kp, F - kp} (kp = 0 ..
    F/2) splits the pairs of for_each_pair and stores X[kp + F j] at band
    kp, slot j, and X[M - kp - F j] at band F - kp, slot R - 1 - j (band 0:
    slot R - j, and X[M] straight to the output); the transpose then stores
    slot (k0, k1) at k0 + F k1. Every band slot holds the frequency k0 + F k1
    and is stored once but slot (0, R/2) (twice, by one thread, with X[M/2]
    both times). The split twiddle, split_tw[kp] of the plan times split_tw[j]
    of the band's plan, is exp(-2 pi i (kp + F j) / N) within 4e-7."""
    p = tplan.make_plan(n, torch.float32, device=CPU, factors=factors)
    f, r, m = p.outer, p.band, p.inner
    kp, j = np.meshgrid(np.arange(f // 2 + 1), np.arange(r), indexing="ij")
    keep = np.where(kp == 0, j <= r // 2, np.where(2 * kp == f, j < r // 2, True))
    kp, j = kp[keep], j[keep]
    k = kp + f * j
    m_band = np.where(kp == 0, 0, f - kp)
    m_slot = np.where(kp == 0, r - j, r - 1 - j)
    to_out = (kp == 0) & (j == 0)
    bands = np.concatenate((kp, m_band[~to_out]))
    slots = np.concatenate((j, m_slot[~to_out]))
    freqs = np.concatenate((k, (m - k)[~to_out]))
    np.testing.assert_array_equal(bands + f * slots, freqs)
    counts = np.bincount(bands * r + slots, minlength=f * r)
    want = np.ones(f * r, np.int64)
    want[r // 2] = 2
    np.testing.assert_array_equal(counts, want)
    assert (m - k)[to_out].tolist() == [m]
    w = p.split_tw.numpy()
    got = w[kp].astype(np.complex128) * p.sub.split_tw.numpy()[j]
    assert np.abs(got - np.exp(-2j * np.pi * k / n)).max() < 4e-7


# --- the redesigned butterfly and long backward: index maps and twiddles ---

def _bfly_tile_points(inv):
    """Points of a butterfly tile of either direction, as csrc/butterfly.cu
    sets them."""
    src = (_build.SOURCE_DIR / "butterfly.cu").read_text()
    logs = re.search(r"kLogPts = INV \? (\d+) : (\d+);", src).groups()
    return 1 << int(logs[0] if inv else logs[1])


class _BflyCfg:
    """csrc/butterfly.cu's Cfg and St in Python: the F-point DFT's stages
    (the real-facing stage of 32 / E points, E = 16 bytes / (2 sizeof T),
    first forward and last inverse; the rest in the fewest stages of at most
    32 points, as evenly as possible), 32 points a thread in each."""

    def __init__(self, log_f, itemsize, inv):
        self.log_f, self.inv = log_f, inv
        self.pts = _bfly_tile_points(inv)
        self.log_c = int(np.log2(self.pts)) - log_f
        self.log_e = 1 if itemsize == 4 else 2
        real = min(log_f, 5 - self.log_e)
        rest = log_f - real
        n = (rest + 4) // 5
        band = [rest // n + (i < rest % n) for i in range(n)] if n else []
        self.bits = band + [real] if inv else [real] + band
        self.last = len(self.bits) - 1
        self.threads = self.pts // 32

    def real_side(self, j):
        return j == (self.last if self.inv else 0)

    def done(self, j):
        return sum(self.bits[:j])

    def log_stride(self, j):
        return self.log_f - self.done(j + 1)

    def geometry(self, j):
        """Per thread and register: (tile row, column) of stage j's points,
        (threads, 32) arrays; and the thread's line (p, r)."""
        f, w = 1 << self.bits[j], 32 >> self.bits[j]
        g_n = (1 << self.log_c) // w
        tau = np.arange(self.threads)[:, None]
        reg = np.arange(32)[None, :]
        c, t = reg // f, reg % f
        g, line = tau % g_n, tau // g_n
        lr = self.log_stride(j)
        r, p = line & ((1 << lr) - 1), line >> lr
        row = (p << (self.bits[j] + lr)) + (t << lr) + r
        col = g * w + c if self.real_side(j) else g + c * g_n
        return row, col, p, r

    def first_of_line(self, p):
        out = 0
        for j in range(self.last):
            shift = self.log_stride(j) - self.bits[self.last]
            out = out + (((p >> shift) & ((1 << self.bits[j]) - 1)) << self.done(j))
        return out

    def dft(self, x):
        """The F-point DFT down the columns of the (F, C) tile x, stage by
        stage as the kernel runs it; returns [frequency, column]."""
        s = x.astype(np.complex128).copy()
        f_all = 1 << self.log_f
        for j in range(self.last + 1):
            row, col, p, r = self.geometry(j)
            f = 1 << self.bits[j]
            v = s[row, col].reshape(self.threads, 32 // f, f)
            v = np.fft.fft(v, axis=-1)
            if j < self.last:
                span = f << self.log_stride(j)
                t = np.arange(f)[None, None, :]
                v = v * np.exp(-2j * np.pi * (t * r[:, :, None] % span) / span)
                s[row, col] = v.reshape(self.threads, 32)
        k = self.first_of_line(p) + (np.arange(32)[None, :] % (1 << self.bits[self.last])
                                     << self.done(self.last))
        out = np.empty((f_all, 1 << self.log_c), np.complex128)
        out[k, col] = v.reshape(self.threads, 32)
        return out


@pytest.mark.parametrize("log_f", range(2, 10))
def test_butterfly_stages_compute_the_column_dft(log_f):
    """csrc/butterfly.cu's stage split, line geometry and frequency of each
    last-stage output (first_of_line), modelled in numpy for f32 and bf16,
    forward and inverse: every stage's points are a permutation of the
    (F, C) tile (no slot taken twice), and the stages compose to the F-point
    DFT of every column within 1e-12."""
    rng = np.random.default_rng(log_f)
    for itemsize in (4, 2):
        for inv in (False, True):
            cfg = _BflyCfg(log_f, itemsize, inv)
            assert all(1 <= b <= 5 for b in cfg.bits) and sum(cfg.bits) == log_f
            assert cfg.bits[cfg.last if inv else 0] == min(log_f, 5 - cfg.log_e)
            for j in range(cfg.last + 1):
                row, col, _, _ = cfg.geometry(j)
                slots = np.sort((row << cfg.log_c) + col, axis=None)
                np.testing.assert_array_equal(slots, np.arange(cfg.pts))
            x = rng.standard_normal((1 << log_f, 1 << cfg.log_c)) + 1j * rng.standard_normal(
                (1 << log_f, 1 << cfg.log_c))
            np.testing.assert_allclose(cfg.dft(x), np.fft.fft(x, axis=0), atol=1e-12 * x.size)


@pytest.mark.parametrize("log_f,log_band", [(3, 12), (4, 12), (2, 13), (5, 11), (6, 12), (7, 13),
                                            (8, 12), (8, 7), (9, 12), (9, 11), (9, 8)])
def test_butterfly_reads_each_sample_and_writes_each_band_point_once(log_f, log_band):
    """The butterfly kernels' device-memory maps over all tiles of a row
    (tile r0 = C * tile): the forward reads sample 2 (n1 R + c) + {0, 1} of
    its real-side stage, 2 E samples a load (one 16-byte vector, or a scalar
    path at a ragged end), only below L, and writes band point (k, r) of its
    last stage; the inverse reads every band point once and writes every
    sample below L once. Aligned (L = N/2, N) and ragged (N/2 + 3, N - 5)."""
    f, band = 1 << log_f, 1 << log_band
    m = f * band
    for itemsize in (4, 2):
        for inv in (False, True):
            cfg = _BflyCfg(log_f, itemsize, inv)
            tiles = band >> cfg.log_c
            real_j = cfg.last if inv else 0
            band_j = 0 if inv else cfg.last
            row, col, p, _ = cfg.geometry(real_j)
            if inv:
                row = cfg.first_of_line(p) + (np.arange(32)[None, :] % (1 << cfg.bits[real_j])
                                              << cfg.done(real_j))
            r0 = (np.arange(tiles) << cfg.log_c)[:, None, None]
            point = (row << log_band)[None] + r0 + col[None]
            for length in (m, 2 * m, m + 3, 2 * m - 5):
                samples = np.concatenate([2 * point.ravel(), 2 * point.ravel() + 1])
                got = np.bincount(samples[samples < length], minlength=2 * m)
                np.testing.assert_array_equal(got, (np.arange(2 * m) < length).astype(int))
            row, col, p, _ = cfg.geometry(band_j)
            if not inv:
                row = cfg.first_of_line(p) + (np.arange(32)[None, :] % (1 << cfg.bits[band_j])
                                              << cfg.done(band_j))
            got = np.bincount(((row << log_band)[None] + r0 + col[None]).ravel(), minlength=m)
            np.testing.assert_array_equal(got, np.ones(m, int))


@pytest.mark.parametrize("n,factors", [(65536, None), (2097152, None), (4194304, None),
                                       (2097152, (16, 8, 32, 16, 16))])
def test_butterfly_two_table_twiddles_match_outer_tw(n, factors):
    """The butterfly's twiddles: root(e) = exp(-2 pi i e / M) = hi[e >> B]
    lo[e mod 2^B], B = ceil(log2 M / 2), both tables cut from the plan's
    split_tw (an entry past M/2 negated), multiplied in complex64. The outer
    twiddle root(k0 r) against plan.outer_tw, every (k0, r), within 2e-7;
    and as the kernels take a line's twiddles (line_twiddle: band k = k_p +
    S t, t = 4a + u, as root(k_p r + 4a S r) root(u S r)) for every stride S
    = F / f of a last stage, within 4e-7."""
    p = tplan.make_plan(n, torch.float32, device=CPU, factors=factors)
    m = p.inner
    log_m = m.bit_length() - 1
    b = (log_m + 1) // 2
    w = p.split_tw.numpy()

    def entry(e):
        v = w[np.where(2 * e <= m, 2 * e, 2 * e - m)]
        return np.where(2 * e <= m, v, -v).astype(np.complex64)

    lo, hi = entry(np.arange(1 << b)), entry(np.arange(m >> b) << b)
    root = lambda e: hi[e >> b] * lo[e & ((1 << b) - 1)]
    k, r = np.arange(p.outer)[:, None], np.arange(p.band)[None, :]
    want = p.outer_tw.numpy()
    got = root(k * r)
    assert got.dtype == np.complex64
    assert np.abs(got - want).max() < 2e-7
    for stride in 2 ** np.arange(int(np.log2(p.outer)) + 1):
        t = k // stride
        u = t % 4
        step = stride * r
        got = root((k % stride * r + (t - u) * step) & (m - 1)) * np.where(
            u == 0, np.complex64(1), root((u * step) & (m - 1)))
        assert np.abs(got - want).max() < 4e-7, stride


def _check_band_unit_source():
    """csrc/long_band.cuh's unit map: its three functions are the expressions
    the model below computes."""
    src = (_build.SOURCE_DIR / "long_band.cuh").read_text()
    body = lambda fn: " ".join(re.search(
        r"constexpr int " + fn + r"\((.*?)\)\s*\{\s*return (.*?);\s*\}", src, re.S).groups())
    assert body("unit_band") == (
        "int c, int side, int outer c == 0 ? side * (outer / 2) : (side == 0 ? c : outer - c)")
    assert body("pass_slots") == "int k0, int band k0 == 0 ? band / 2 + 1 : band / 2"
    assert body("partner_slot") == (
        "int k0, int j, int band k0 == 0 ? (band - j) & (band - 1) : band - 1 - j")


# (kernel, FFT size, factors); the long backward's cases keep their ids
_UNIT_CASES = [(kernel, n, factors) for kernel in ("long_conv_bwd", "long_conv", "long_dk_finish")
               for n, factors in ((65536, None), (131072, (32, 16, 16, 8)), (2097152, None),
                                  (4194304, None))]
_UNIT_IDS = [("" if kernel == "long_conv_bwd" else kernel + "-")
             + f"{n}-{'None' if factors is None else 'factors1'}"
             for kernel, n, factors in _UNIT_CASES]


@pytest.mark.parametrize("kernel,n,factors", _UNIT_CASES, ids=_UNIT_IDS)
def test_long_conv_bwd_units_take_each_pair_once(kernel, n, factors):
    """The band unit map of csrc/long_band.cuh that long_conv_bwd_kernel,
    long_conv_kernel and long_dk_finish_kernel run on, modelled in numpy:
    block c = 0 .. F/2 - 1 of a row holds the units (rank 0 and 1) of bands
    0 and F/2 (c = 0) or c and F - c; every band is taken once. The unit of
    band k0 takes its own slots j < R/2 (band 0: j <= R/2) and its partner's
    slot R - 1 - j (band 0: (R - j) mod R, in itself). Every band slot is
    read and written by one unit in the pair pass, it holds frequency k0 +
    F j, the partner slot frequency M - k, and the frequencies k, M - k that
    the pass reads (k_f in long_conv, the partials in long_dk_finish) or
    writes (the backward's partials) are each taken once but M/2 (twice, by
    one thread, band 0 slot R/2) and M (with 0, from slot 0). The split
    twiddle split_tw[k0] times the row FFT's two-table root
    exp(-2 pi i j / 2R) is exp(-2 pi i k / N) within 4e-7."""
    _check_band_unit_source()
    src = (_build.SOURCE_DIR / f"{'long_conv' if kernel == 'long_conv' else 'long_conv_bwd'}.cu")
    assert all(f in src.read_text() for f in ("unit_band(", "pass_slots(", "partner_slot("))
    p = tplan.make_plan(n, torch.float32, device=CPU, factors=factors)
    f, r, m = p.outer, p.band, p.inner
    c, rank = np.meshgrid(np.arange(f // 2), np.arange(2), indexing="ij")
    k0 = np.where(c == 0, rank * (f // 2), np.where(rank == 0, c, f - c)).ravel()
    np.testing.assert_array_equal(np.sort(k0), np.arange(f))
    touched = np.zeros((f, r), int)
    freqs = []
    for b in k0:
        j = np.arange(r // 2 + 1 if b == 0 else r // 2)
        jm = (r - j) % r if b == 0 else r - 1 - j
        pb = 0 if b == 0 else (f // 2 if 2 * b == f else f - b)
        k = b + f * j
        np.testing.assert_array_equal(np.where((b == 0) & (j == 0), m, pb + f * jm), m - k)
        touched[b, j] += 1
        keep = ~((jm == j) & (pb == b))
        touched[pb, jm[keep]] += 1
        freqs += [k, m - k]
    np.testing.assert_array_equal(touched, np.ones((f, r), int))
    counts = np.bincount(np.concatenate(freqs), minlength=m + 1)
    want = np.ones(m + 1, int)
    want[m // 2] = 2
    np.testing.assert_array_equal(counts, want)
    # the split twiddle: split_tw[k0] (plan) x hi[j >> B] lo[j mod 2^B] of the
    # band plan's table (row_fft.cuh, N' = 2R: B = ceil(log2(N') / 2))
    ws = p.sub.split_tw.numpy()
    bb = (int(np.log2(2 * r)) + 1) // 2
    kk, jj = np.meshgrid(np.arange(f), np.arange(r // 2 + 1), indexing="ij")
    hi_i = (jj >> bb) << bb
    hi = np.where(hi_i <= r, ws[np.minimum(hi_i, r)], -ws[np.maximum(hi_i - r, 0)])
    got = p.split_tw.numpy()[kk] * (hi.astype(np.complex64) * ws[jj & ((1 << bb) - 1)])
    assert np.abs(got - np.exp(-2j * np.pi * (kk + f * jj) / n)).max() < 4e-7


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


# --- the long backward (kernels: _long_bwd_tiles, _inv_dft_tiles) ------------

BWD_FUSED = {65536: "_long_bwd_fused", 524288: "_long4_bwd_fused"}


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


@pytest.mark.parametrize("n", [65536, 524288])
def test_long_dk_finish_matches_jax_inverse_long_dft(n):
    """long_dk_finish (plain on the CPU) against _inverse_long_dft
    (_inv_dft_tiles in interpret mode, with an inverse _butterfly_tiles at
    524288) on the spectrum _forward_long_dft gives, brought to the port's
    natural-order half spectrum; B = 2 partials that sum to it; k_len < N
    cuts. 1e-5 of the largest |value|."""
    h, k_len = 2, n // 2 - 3
    rng = np.random.default_rng(n + 1)
    x = (rng.standard_normal((h, n)) * 0.02).astype(np.float32)
    jp = jff.make_plan(n, compute_dtype=jnp.float32)
    fr, fi = mp._forward_long_dft(jp, jnp.asarray(x))
    want = _np(mp._inverse_long_dft(jp, fr, fi))[:, :k_len]
    full = _np(jplan.kf_unpermute(fr, jp.factors)) + 1j * _np(jplan.kf_unpermute(fi, jp.factors))
    half = torch.from_numpy(full[:, : n // 2 + 1].astype(np.complex64))
    noise = torch.from_numpy((rng.standard_normal(half.shape) + 1j * rng.standard_normal(
        half.shape)).astype(np.complex64))
    partials = torch.stack((half - noise, noise))
    p = tplan.make_plan(n, torch.float32, device=CPU)
    got = monarch_cuda.long_dk_finish(p, partials, k_len)
    assert got.shape == (h, k_len) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() < 1e-5 * max(np.abs(want).max(), float(noise.abs().max()))
    assert np.abs(got.numpy() - x[:, :k_len]).max() < 1e-4


@pytest.mark.parametrize("n,factors", [(65536, None), (131072, (4, 2, 32, 16, 16)),
                                       (524288, None)])
@pytest.mark.parametrize("gated", [False, True])
def test_long_backward_stages_compose_to_conv_bwd_plain(n, factors, gated):
    """The stage-wise plain versions (butterfly_plain on u * pre and on
    dout * post, long_conv_bwd_inner_plain, butterfly_inverse_plain,
    long_dk_finish_plain), as the wrappers chain them, give conv_bwd_plain
    and dk_finish_plain bit for bit; one and two outer stages, B = 3."""
    p = tplan.make_plan(n, torch.float32, device=CPU, factors=factors)
    g = torch.Generator().manual_seed(n)
    length, k_len = n // 2 + 3, n // 2 - 5
    u, d, pre, post = (torch.randn(3, 2, length, generator=g).bfloat16() for _ in range(4))
    if not gated:
        pre = post = None
    k_f = monarch_cuda.long_spectrum(p, torch.randn(2, k_len, generator=g) * 0.05)
    zu = monarch.butterfly_plain(p, u, pre)
    zg = monarch.butterfly_plain(p, d.float() * post.float() if gated else d)
    zdu, zy, partials = monarch.long_conv_bwd_inner_plain(p, zu, zg, k_f, need_y=gated)
    assert (zy is None) == (not gated) and partials.shape == (3, 2, n // 2 + 1)
    want = monarch.conv_bwd_plain(p, u, k_f, pre, post, d)
    assert torch.equal(partials, want[3])
    du_inner = monarch.butterfly_inverse_plain(p, zdu, length)
    if gated:
        assert torch.equal((du_inner * pre.float()).bfloat16(), want[0])
        assert torch.equal((du_inner * u.float()).bfloat16(), want[1])
        assert torch.equal(monarch.butterfly_inverse_plain(p, zy, length, d, torch.bfloat16),
                           want[2])
    else:
        assert torch.equal(du_inner.bfloat16(), want[0]) and want[1] is None and want[2] is None
    # a band above MAX_BWD_BAND (this 131072 split has 8192) runs its whole
    # backward under bwd_plan(p), the default plan of its size
    q = monarch_cuda.bwd_plan(p)
    want_q = want if q is p else monarch.conv_bwd_plain(q, u, k_f, pre, post, d)
    got = monarch_cuda.long_conv_bwd(p, u, k_f, pre, post, d)
    assert all(torch.equal(a, r) for a, r in zip(got, want_q) if r is not None)
    dk = monarch.long_dk_finish_plain(p, partials, k_len)
    assert dk.shape == (2, k_len) and torch.equal(dk, monarch.dk_finish_plain(p, want[3], k_len))
    assert torch.equal(dk, monarch_cuda.long_dk_finish(p, partials, k_len))


def test_fft_conv_function_backward_takes_the_long_route():
    """FftConvFunction.backward at a long plan calls long_conv_bwd and
    long_dk_finish (never the one-block wrappers), skips dk when k needs no
    grad, and gives conv_bwd_plain's grads."""
    n = 65536
    p = tplan.make_plan(n, torch.float32, device=CPU)
    rng = np.random.default_rng(9)
    u, k, gates = _conv_data(rng, n, 2, 2, n // 2 + 1, True)
    calls = []
    real = {name: getattr(monarch_cuda, name) for name in
            ("long_conv_bwd", "long_dk_finish", "monarch_conv_bwd", "dk_finish")}
    try:
        for name, fn in real.items():
            setattr(monarch_cuda, name,
                    lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
        ts = [torch.from_numpy(a).requires_grad_() for a in (u, k, *gates)]
        tff.fft_conv(p, *ts).square().sum().backward()
        assert calls == ["long_conv_bwd", "long_dk_finish"]
        calls.clear()
        frozen = [torch.from_numpy(a).requires_grad_(i != 1) for i, a in enumerate((u, k, *gates))]
        tff.fft_conv(p, *frozen).square().sum().backward()
        assert calls == ["long_conv_bwd"] and frozen[1].grad is None
    finally:
        for name, fn in real.items():
            setattr(monarch_cuda, name, fn)
    for a, b in zip(ts, frozen):
        assert b.grad is None or torch.equal(a.grad, b.grad)


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


def test_long_backward_wrappers_refuse_bad_inputs():
    long_plan = tplan.make_plan(65536, torch.float32, device=CPU)
    short_plan = tplan.make_plan(4096, torch.float32, device=CPU)
    z = torch.zeros(1, 2, 8, 4096, dtype=torch.complex64)
    k_f = torch.zeros(2, 32769, dtype=torch.complex64)
    u = torch.zeros(1, 2, 100)
    with pytest.raises(ValueError, match="no outer part"):
        monarch_cuda.long_conv_bwd_inner(short_plan, z, z, k_f)
    with pytest.raises(ValueError, match="no outer part"):
        monarch_cuda.long_dk_finish(short_plan, k_f[None], 10)
    with pytest.raises(ValueError, match="both"):
        monarch_cuda.long_conv_bwd(long_plan, u, k_f, u, None, u)
    with pytest.raises(ValueError, match="dout shape"):
        monarch_cuda.long_conv_bwd(long_plan, u, k_f, None, None, u[..., :50])
    meta = torch.empty(1, 2, 8, 4096, dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        monarch_cuda.long_conv_bwd_inner(long_plan, meta, meta, k_f.to("meta"))
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        monarch_cuda.long_dk_finish(long_plan, torch.empty(1, 2, 32769, dtype=torch.complex64,
                                                           device="meta"), 10)


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
