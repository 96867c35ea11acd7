"""FFT plans for the CUDA port: exact DFT and twiddle tables and the factorization.

A length-``N`` causal FFT convolution of a real signal is computed through a
complex FFT of length ``M = N/2``: the even samples go to the real part and
the odd samples to the imaginary part, and an O(M) split step turns the
complex spectrum ``Z`` into the half spectrum ``X[0..M]`` of the real signal
(and back). The length-``M`` complex FFT is Monarch-decomposed: pick factors
``M = f_1 * ... * f_m``, view the signal as ``(f_1, ..., f_m)`` and apply,
for each stage ``j``, a DFT of size ``f_j`` along axis ``j`` followed by an
elementwise twiddle multiply. The Monarch output ``X[k1, ..., km]`` holds
frequency ``k1 + f1*k2 + f1*f2*k3 + ...``.

The factorization is chosen for Hopper, not for the TPU: one thread block
holds one row of ``M`` complex f32 values in shared memory (128 KB at
N = 32768), and each thread owns one line of a stage in registers, so the
factors are at most 32 and as even as possible. The Monarch layout stays
inside the kernels; the spectrum that leaves them is in natural order.

From N = 65536 up a row no longer fits one block's shared memory, so the
plan splits its factors into an outer part (``n_outer`` leading factors,
product ``F = plan.outer``) and an inner part (product ``R = plan.band``,
``LONG_BAND`` = 4096 by default): the signal is viewed as ``(F, R)``, the
``butterfly`` kernel takes the F-point DFT down the columns and multiplies
by ``outer_tw``, and band ``k0`` (one row of R points, frequencies
``k0 + F*k1``) goes through an R-point FFT in shared memory. The inner
tables are a plan of their own, ``plan.sub`` (a plan of seqlen 2R); plans
up to N = 32768 have ``n_outer = 0`` and are unchanged.

Up to ``DIRECT_MAX`` = 512 the conv itself runs as one dense DFT a row
(the ``direct_conv`` kernels, as the JAX package's 1-factor plans do); such
a plan also carries ``direct_roots``, the N roots of unity that the direct
backward kernel indexes by the exact integer (f * t) mod N, and
``direct_tf32``, the forward kernel's real DFT tables on the tensor cores,
split into TF32 hi and lo (``direct_tf32_tables``). Its Monarch factors
still serve ``spectrum`` and ``dk_finish``.

All DFT and twiddle phases are computed with exact integer arithmetic mod n
in float64 before the final exp, then stored as complex64.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

MIN_SEQLEN = 16
MAX_SEQLEN = 4_194_304
MAX_FACTOR = 32
# Up to this FFT size a conv is one dense DFT a row (the direct kernels).
DIRECT_MAX = 512
# One block's shared memory holds a whole row up to this FFT size.
MAX_FUSED_SEQLEN = 32768
# Longest band (inner complex FFT) of a long plan: the band kernels hold two
# bands, k0 and F - k0, in one block's shared memory (2 x 64 KB at 8192).
MAX_BAND = 8192
LONG_BAND = 4096
# Shortest band of a long plan (custom factors included).
MIN_BAND = 128
# Largest outer part: the butterfly kernel holds an (F, 32) tile of complex
# f32 values in shared memory (128 KB at 512).
MAX_OUTER = 512


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device needs a card. The port's entry
    points default to CUDA and never carry on on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions"
        )
    return device


def is_supported_seqlen(seqlen: int) -> bool:
    return MIN_SEQLEN <= seqlen <= MAX_SEQLEN and (seqlen & (seqlen - 1)) == 0


def _even_factors(n: int) -> tuple[int, ...]:
    """n (a power of two) as the fewest factors <= MAX_FACTOR, its bits
    spread as evenly as possible, larger factors first."""
    bits = n.bit_length() - 1
    max_bits = MAX_FACTOR.bit_length() - 1
    stages = -(-bits // max_bits)
    per, extra = divmod(bits, stages)
    return tuple(1 << (per + (1 if j < extra else 0)) for j in range(stages))


def default_factors(seqlen: int) -> tuple[int, ...]:
    """Factors of the inner complex FFT length ``M = seqlen // 2``.

    Up to 32768: the fewest stages whose factors are all <= MAX_FACTOR, with
    the bits of M spread as evenly as possible (larger factors first):
    32768 -> (32, 32, 16), 16384 -> (32, 16, 16), 2048 -> (32, 32),
    256 -> (16, 8), 128 -> (8, 8), 64 -> (32,), 16 -> (8,) (up to 512 these
    serve only the kernel's spectrum and dk; the conv is one dense DFT).
    From 65536 up: the factors of the outer part
    F = M / LONG_BAND followed by those of the band, each part split the
    same way: 65536 -> (8, 16, 16, 16), 2097152 -> (16, 16, 16, 16, 16),
    4194304 -> (32, 16, 16, 16, 16); ``default_n_outer`` says where the
    outer part ends.
    """
    if not is_supported_seqlen(seqlen):
        raise ValueError(
            f"seqlen {seqlen} not supported: must be a power of two in "
            f"[{MIN_SEQLEN}, {MAX_SEQLEN}]"
        )
    m = seqlen // 2
    if seqlen <= MAX_FUSED_SEQLEN:
        return _even_factors(m)
    return _even_factors(m // LONG_BAND) + _even_factors(LONG_BAND)


def default_n_outer(seqlen: int, factors: tuple[int, ...]) -> int:
    """How many leading factors form the outer part: none up to 32768, else
    the fewest that leave a band of at most MAX_BAND points."""
    if seqlen <= MAX_FUSED_SEQLEN:
        return 0
    band, n_outer = seqlen // 2, 0
    while band > MAX_BAND and n_outer < len(factors):
        band //= factors[n_outer]
        n_outer += 1
    return n_outer


def _dft_matrix(n: int, sign: int) -> np.ndarray:
    """n x n (I)DFT matrix, complex128. sign=-1 forward, +1 inverse (unnormalized)."""
    idx = np.arange(n, dtype=np.int64)
    phase = (idx[:, None] * idx[None, :]) % n
    return np.exp(sign * 2j * np.pi * phase.astype(np.float64) / n)


def _twiddle(f: int, r: int, sign: int) -> np.ndarray:
    """(f, r) twiddle table w[k, t] = exp(sign * 2*pi*i * k * t / (f*r))."""
    n = f * r
    k = np.arange(f, dtype=np.int64)[:, None]
    t = np.arange(r, dtype=np.int64)[None, :]
    phase = (k * t) % n
    return np.exp(sign * 2j * np.pi * phase.astype(np.float64) / n)


def _roots(n: int) -> np.ndarray:
    """(n,) roots of unity exp(-2*pi*i * k / n), k = 0..n-1."""
    k = np.arange(n, dtype=np.int64)
    return np.exp(-2j * np.pi * k.astype(np.float64) / n)


def tf32_split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f32 x as x ~ hi + lo, both exact in TF32 (10 mantissa bits): each
    rounded to nearest, ties away from zero, as ``cvt.rna.tf32.f32`` rounds
    (add half a TF32 ulp to the bits, clear the low 13); lo is x - hi, exact
    in f32, rounded the same way. |x - hi - lo| <= 2^-22 |x|."""
    x = np.ascontiguousarray(x, np.float32)

    def rna(v: np.ndarray) -> np.ndarray:
        return ((v.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def direct_dft_columns(seqlen: int) -> tuple[np.ndarray, np.ndarray]:
    """The real DFT the direct forward kernel computes, N = seqlen real
    unknowns of the half spectrum: (C, I) in float64, C (N, N) with
    C[t, c] the weight of sample t in spectrum column c, I (N, N) with
    I[c, t] the weight of column c in output sample t (irfft's first N
    samples). Column 0 is Re X[0] (C = 1), column 1 Re X[M] (C = (-1)^t),
    columns 2f and 2f + 1 (f = 1 .. M-1) Re and Im X[f] (C = cos and -sin
    of 2 pi f t / N, from the exact integer (f t) mod N); I[c, t] =
    s_c C[t, c] with s_c = 1/N for c = 0, 1 and 2/N otherwise."""
    n, m = seqlen, seqlen // 2
    f = np.empty(n, np.int64)
    f[0], f[1] = 0, m
    f[2::2] = f[3::2] = np.arange(1, m)
    phase = 2 * np.pi * ((np.arange(n)[:, None] * f[None, :]) % n) / n
    c = np.cos(phase)
    c[:, 3::2] = -np.sin(phase[:, 3::2])
    scale = np.full(n, 2.0 / n)
    scale[:2] = 1.0 / n
    return c, (c * scale).T


def direct_tf32_tables(seqlen: int) -> np.ndarray:
    """The direct forward kernel's tables (csrc/direct_conv.cu): C and I of
    ``direct_dft_columns`` rounded to f32 and split by ``tf32_split``, in
    the order in which the lanes of a warp read mma.sync.m16n8k8 B
    fragments, {hi b0, hi b1, lo b0, lo b1} a lane (g = lane // 4, q =
    lane % 4):
      [0, s, k, j, lane] = C[8 k + q + {0, 4}, 16 s + 8 j + g]  (16 columns
          a step s, k-step k, n-tile j);
      [1, s, j, h, lane] = I[16 s + 8 h + perm(q) + {0, 1}, 8 j + g]  (step
          s, output n-tile j, k-step h of the step), where the k slot q
          holds column 2 q and slot q + 4 column 2 q + 1 (perm(q) = 2 q),
          the order in which a C fragment becomes an A fragment.
    Returns float32 (2, N/16, N/8, 2, 32, 4)."""
    n = seqlen
    c, inv = (a.astype(np.float32) for a in direct_dft_columns(n))
    s, k, j, lane = np.meshgrid(np.arange(n // 16), np.arange(n // 8), np.arange(2),
                                np.arange(32), indexing="ij")
    g, q = lane // 4, lane % 4
    fwd = np.stack((c[8 * k + q, 16 * s + 8 * j + g], c[8 * k + q + 4, 16 * s + 8 * j + g]))
    col = 16 * s + 8 * j + 2 * q  # here k is the output n-tile and j the k-step
    bwd = np.stack((inv[col, 8 * k + g], inv[col + 1, 8 * k + g]))
    out = np.empty((2, n // 16, n // 8, 2, 32, 4), np.float32)
    for i, tab in enumerate((fwd, bwd)):
        hi, lo = tf32_split(tab)
        out[i] = np.stack((hi[0], hi[1], lo[0], lo[1]), axis=-1)
    return out


@dataclasses.dataclass(frozen=True)
class FftPlan:
    """Tables for a length-``seqlen`` real FFT convolution on one device.

    ``factors`` factor the inner complex length ``M = seqlen // 2``.
    All tables are complex64. Up to seqlen 32768 (``n_outer == 0``):

      dft[j], idft[j]: (f_j, f_j) forward / inverse DFT matrices; the
                       stage-0 inverse carries the 1/M normalization.
      tw[j]:           (f_j, R_j) forward twiddles of stage j < m-1,
                       R_j = prod(factors[j+1:]); the inverse uses conj.
      tw_flat:         every tw[j] flattened and concatenated (the kernels
                       read stage j at offset sum_{i<j} f_i * R_i).
      split_tw:        (M+1,) exp(-2*pi*i*k/N), the split-step twiddle.
      roots:           (MAX_FACTOR,) exp(-2*pi*i*k/MAX_FACTOR), from which
                       the kernels build every in-register line DFT.
      direct_roots:    (N,) exp(-2*pi*i*k/N) for seqlen <= DIRECT_MAX (None
                       above): the direct backward kernel's DFT entries.
      direct_tf32:     (2, N/16, N/8, 2, 32, 4) f32 for seqlen <= DIRECT_MAX
                       (None above): the direct forward kernel's tables in
                       TF32 hi and lo, fragment by fragment
                       (``direct_tf32_tables``).

    From 65536 up the first ``n_outer`` (1 or 2) factors are the outer part,
    F = ``outer``, and the rest the band, R = ``band``:

      dft[j], idft[j]: the outer stages' matrices only (j < n_outer); the
                       stage-0 inverse carries 1/F.
      outer_roots:     (F,) exp(-2*pi*i*k/F): the twiddle between two outer
                       stages is outer_roots[(ka * nb) % F].
      outer_tw:        (F, R) exp(-2*pi*i*k0*r/M), applied after the outer DFT.
      sub:             the plan of seqlen 2R whose dft, idft, tw, tw_flat and
                       roots are the band's (its stage-0 inverse carries 1/R).
      tw, tw_flat:     unused (empty, one zero).

    ``dtype`` is the activation dtype the plan was built for. The port
    computes in f32 whatever it is, and keeps the kernel spectrum in f32.
    """

    seqlen: int
    factors: tuple[int, ...]
    dtype: torch.dtype
    dft: tuple[torch.Tensor, ...]
    idft: tuple[torch.Tensor, ...]
    tw: tuple[torch.Tensor, ...]
    tw_flat: torch.Tensor
    split_tw: torch.Tensor
    roots: torch.Tensor
    n_outer: int = 0
    outer_roots: torch.Tensor | None = None
    outer_tw: torch.Tensor | None = None
    sub: "FftPlan | None" = None
    direct_roots: torch.Tensor | None = None
    direct_tf32: torch.Tensor | None = None

    @property
    def direct(self) -> bool:
        """True when the conv runs as one dense DFT a row (seqlen <= DIRECT_MAX)."""
        return self.direct_roots is not None

    @property
    def inner(self) -> int:
        return self.seqlen // 2

    @property
    def n_stages(self) -> int:
        return len(self.factors)

    @property
    def outer_factors(self) -> tuple[int, ...]:
        return self.factors[: self.n_outer]

    @property
    def outer(self) -> int:
        """F, the product of the outer factors (1 for a plan without)."""
        return math.prod(self.outer_factors)

    @property
    def band(self) -> int:
        """R = M / F, the length of the FFT that runs in shared memory."""
        return self.inner // self.outer

    @property
    def device(self) -> torch.device:
        return self.split_tw.device

    def tensors(self) -> dict[str, torch.Tensor]:
        """Every table by a flat name (for registering them as buffers)."""
        out = {"tw_flat": self.tw_flat, "split_tw": self.split_tw, "roots": self.roots}
        for j in range(len(self.dft)):
            out[f"dft_{j}"] = self.dft[j]
            out[f"idft_{j}"] = self.idft[j]
        if self.n_outer:
            out["outer_roots"] = self.outer_roots
            out["outer_tw"] = self.outer_tw
            out.update({f"sub_{name}": t for name, t in self.sub.tensors().items()})
        if self.direct:
            out["direct_roots"] = self.direct_roots
            out["direct_tf32"] = self.direct_tf32
        return out

    def with_tensors(self, tensors: dict[str, torch.Tensor]) -> "FftPlan":
        """The same plan over the given tables (as ``tensors()`` names them)."""
        m = len(self.dft)
        tw_flat = tensors["tw_flat"]
        long = {}
        if self.n_outer:
            sub = {n[len("sub_"):]: t for n, t in tensors.items() if n.startswith("sub_")}
            long = dict(outer_roots=tensors["outer_roots"], outer_tw=tensors["outer_tw"],
                        sub=self.sub.with_tensors(sub))
        return dataclasses.replace(
            self,
            dft=tuple(tensors[f"dft_{j}"] for j in range(m)),
            idft=tuple(tensors[f"idft_{j}"] for j in range(m)),
            tw=() if self.n_outer else _split_twiddles(tw_flat, self.factors),
            tw_flat=tw_flat,
            split_tw=tensors["split_tw"],
            roots=tensors["roots"],
            direct_roots=tensors.get("direct_roots"),
            direct_tf32=tensors.get("direct_tf32"),
            **long,
        )


def _split_twiddles(tw_flat: torch.Tensor, factors) -> tuple[torch.Tensor, ...]:
    out, off, r = [], 0, math.prod(factors)
    for f in factors[:-1]:
        r //= f
        out.append(tw_flat[off : off + f * r].view(f, r))
        off += f * r
    return tuple(out)


def make_plan(
    seqlen: int,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
    factors: tuple[int, ...] | None = None,
) -> FftPlan:
    """Build an FftPlan on ``device``; ``factors`` (of seqlen // 2) default
    to default_factors. From seqlen 65536 up default_n_outer says how many
    of them form the outer part."""
    if dtype == torch.float16:
        dtype = torch.bfloat16
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"plan dtype must be bfloat16 or float32, got {dtype}")
    if not is_supported_seqlen(seqlen):
        raise ValueError(
            f"seqlen {seqlen} not supported: must be a power of two in "
            f"[{MIN_SEQLEN}, {MAX_SEQLEN}]"
        )
    m = seqlen // 2
    factors = default_factors(seqlen) if factors is None else tuple(int(f) for f in factors)
    if math.prod(factors) != m:
        raise ValueError(f"factors {factors} do not multiply to {m}")
    if any(f < 2 or f > MAX_FACTOR or f & (f - 1) for f in factors):
        raise ValueError(f"factors {factors} must be powers of two in [2, {MAX_FACTOR}]")
    n_outer = default_n_outer(seqlen, factors)
    device = resolve_device(device)

    def c64(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a.astype(np.complex64))).to(device)

    k = np.arange(m + 1, dtype=np.int64)
    split_tw = c64(np.exp(-2j * np.pi * k.astype(np.float64) / seqlen))
    roots = c64(_roots(MAX_FACTOR))
    if seqlen > MAX_FUSED_SEQLEN:
        outer = math.prod(factors[:n_outer])
        band = m // outer
        if not (1 <= n_outer <= 2 and outer <= MAX_OUTER and MIN_BAND <= band <= MAX_BAND
                and len(factors) - n_outer <= 4):
            raise ValueError(
                f"factors {factors} (the first {n_outer} outer) are no long plan: 1 or 2 outer "
                f"factors of product <= {MAX_OUTER}, then at most 4 factors of a band of "
                f"{MIN_BAND}..{MAX_BAND} points"
            )
        inv0 = _dft_matrix(factors[0], +1) / outer  # 1/F here, 1/R in the band's plan
        return FftPlan(
            seqlen=seqlen,
            factors=factors,
            dtype=dtype,
            dft=tuple(c64(_dft_matrix(f, -1)) for f in factors[:n_outer]),
            idft=(c64(inv0), *(c64(_dft_matrix(f, +1)) for f in factors[1:n_outer])),
            tw=(),
            tw_flat=c64(np.zeros(1, np.complex128)),
            split_tw=split_tw,
            roots=roots,
            n_outer=n_outer,
            outer_roots=c64(np.exp(-2j * np.pi * np.arange(outer, dtype=np.float64) / outer)),
            outer_tw=c64(_twiddle(outer, band, -1)),
            sub=make_plan(2 * band, dtype, device, factors[n_outer:]),
        )

    dft, idft, tw = [], [], []
    r = m
    for j, f in enumerate(factors):
        r //= f
        inv = _dft_matrix(f, +1)
        if j == 0:
            inv = inv / m  # fold the 1/M normalization into one matrix
        dft.append(c64(_dft_matrix(f, -1)))
        idft.append(c64(inv))
        if j < len(factors) - 1:
            tw.append(_twiddle(f, r, -1).reshape(-1))
    tw_flat = c64(np.concatenate(tw) if tw else np.zeros(1, np.complex128))
    return FftPlan(
        seqlen=seqlen,
        factors=factors,
        dtype=dtype,
        dft=tuple(dft),
        idft=tuple(idft),
        tw=_split_twiddles(tw_flat, factors),
        tw_flat=tw_flat,
        split_tw=split_tw,
        roots=roots,
        direct_roots=c64(_roots(seqlen)) if seqlen <= DIRECT_MAX else None,
        direct_tf32=(torch.from_numpy(direct_tf32_tables(seqlen)).to(device)
                     if seqlen <= DIRECT_MAX else None),
    )


@functools.lru_cache(maxsize=64)
def _cached_plan(seqlen: int, dtype: torch.dtype, device: str) -> FftPlan:
    return make_plan(seqlen, dtype=dtype, device=device)


def get_plan(seqlen: int, dtype: torch.dtype = torch.bfloat16, device="cuda") -> FftPlan:
    """Cached plan lookup: every layer of a model on one device shares one plan."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _cached_plan(seqlen, dtype, str(device))


def kf_permute(x: torch.Tensor, factors: tuple[int, ...]) -> torch.Tensor:
    """Natural order (..., n) -> Monarch layout (..., f1, ..., fm), where
    element [k1, ..., km] holds index k1 + f1*k2 + f1*f2*k3 + ..."""
    batch = x.shape[:-1]
    nb = len(batch)
    y = x.reshape(*batch, *factors[::-1])
    perm = tuple(range(nb)) + tuple(nb + len(factors) - 1 - i for i in range(len(factors)))
    return y.permute(perm)


def kf_unpermute(x: torch.Tensor, factors: tuple[int, ...]) -> torch.Tensor:
    """Inverse of kf_permute: Monarch layout (..., f1, ..., fm) -> natural (..., n)."""
    batch = x.shape[: -len(factors)]
    nb = len(batch)
    perm = tuple(range(nb)) + tuple(nb + len(factors) - 1 - i for i in range(len(factors)))
    return x.permute(perm).reshape(*batch, math.prod(factors))
