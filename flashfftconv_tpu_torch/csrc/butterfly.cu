// butterfly: the outer stage of the FFT convolution for N >= 65536, forward
// (real in, complex bands out) and inverse (complex bands in, real out).
//
// Replaces the TPU kernel _butterfly_tiles (flashfftconv_tpu/ops/
// monarch_pallas.py, def at l.2074, pallas_call at l.2232), the outer
// butterfly of the 512K-4M pipeline. Here it is the outer stage of every
// conv and spectrum from N = 65536 up, since no block can hold a whole row.
//
// Function. Forward: reads the real row u (rows, L <= N) at f32 or bf16,
// with the implicit zero pad and the optional pregate (the product rounded
// to u's dtype), packs it as the M = N/2 point complex signal z[n] = x[2n] +
// i x[2n+1], views z as (F, R), takes the F-point DFT down every column,
// multiplies by the outer twiddle exp(-2 pi i k0 r / M) and writes the bands
// (rows, F, R) as complex64, band k0 in row k0. Inverse: multiplies by the
// conjugate twiddle, takes the inverse F-point DFT, scales by 1/F, unpacks
// to real samples, applies the optional postgate and writes [0, L).
//
// Bound on the H100 at B=1, H=256, L=2^20, N=2^21, bf16: each direction
// moves 0.54 GB of reals and 2.1 GB of bands, 0.80 ms at 3.35 TB/s, against
// one 256-point DFT a column in f32 (about 13 GFLOP, 0.2 ms at 67 TFLOP/s):
// bytes.
//
// The parent design (tiles of C columns through shared memory, scalar
// 2-byte loads, runtime factors, the outer twiddle read from an 8 MB table,
// 80 registers) ran 2.28 ms forward and 2.50 inverse on an H100 at that
// shape.
//
// Design (one instance per F = 4 ... 512, dtype and gating; the C entry
// dispatches on F, so the plan's split of F into factors does not enter).
// A block owns a tile of C = P / F consecutive columns of all F rows of one
// (b, h) row (P = 8192 points forward, 256 threads, two blocks an SM; 4096
// inverse, 128 threads, three blocks an SM: the fastest of the tiles timed,
// PERF.md) and walks over tiles (as many blocks as the SMs hold, so that its
// twiddle table is loaded once). Each thread holds 32 points in registers
// in every stage of the F-point DFT; the stages are Cooley-Tukey over lines
// of at most 32 points with every size, stride and register index a
// compile-time constant, the line DFTs on the 32nd roots as literals
// (line_fft_const, long_common.cuh):
//   - the stage that faces the reals (the forward's first, the inverse's
//     last) gives a thread W = 16 bytes / (2 sizeof T) adjacent columns (4
//     at bf16, 2 at f32) of 32 / W rows, so that every load and store of
//     reals moves 16 bytes (8 bf16 or 4 f32 samples; a scalar path only at a
//     ragged end or on a row view off a 16-byte boundary);
//   - the stages that face the bands (the forward's last, the inverse's
//     first) give a thread 32 / f columns strided by C f / 32, so that the
//     lanes of a warp read or write consecutive complex64 values of a band:
//     a warp instruction covers whole 32-byte sectors;
//   - between two stages the tile crosses shared memory once (one store,
//     one barrier, one load); F = 512 at bf16 takes a third stage.
// The twiddles come from a table of M-th roots in shared memory, copied once
// a block from the plan's split_tw: root(e) = exp(-2 pi i e / M) = hi[e >> B]
// lo[e mod 2^B], B = ceil(log2(M) / 2) (1024 + 1024 entries at M = 2^20; lo
// XOR-swizzled, row::swz, so that lanes at a power-of-two stride of
// exponents fall on distinct banks). A line's twiddles w^(base + t step)
// are root(base + 4a step) root(u step), t = 4a + u (line_twiddle: F/4 + 3
// lookups a line): the outer twiddle exp(-2 pi i k0 r / M) of a band point
// with base k_p r and step (F / f) r, no 8 MB table; the twiddle between
// stages exp(-2 pi i t r / S) with step r M / S.
// The zero half: where L <= M the rows n1 >= F/2 are padding, so the
// forward loads none of them and skips the first radix-2 level of its first
// stage (line_fft_half); the inverse computes only the outputs of its last
// stage's lines that land in [0, L) (line_fft_low) and stores those.
// Loads in flight: every thread issues its 8 (bf16) or 16 (f32) 16-byte
// loads of a tile before it uses any (independent register loads; the
// conversion and the pregate product sit between the load and shared
// memory, which cp.async would not spare), 64-128 KB an SM. Rows whose
// length is a whole number of bands (HyenaDNA's) take loads with no bounds
// check. ptxas: no stack frame in any of the 64 instances, at most 128
// registers forward and 168 inverse. Every output has one writer: two calls
// give the same bits.
//
// C entries: ffc_butterfly_fwd(u, gate, out, split_tw, rows, length, outer,
// band, dtype, stream) and ffc_butterfly_inv(z, gate, out, ...): split_tw
// is the plan's exp(-2 pi i m / N), m = 0 .. M; outer = F and band = R
// powers of two with F R = M, 4 <= F <= 512, 128 <= R <= 8192; z on a
// 16-byte boundary.

#include "row_fft.cuh"

namespace ffc {
namespace bfly {

using row::load_vec;
using row::store_vec;
using row::swz;

// Tile points and blocks an SM of each direction, the fastest of the tiles
// timed on an H100 (PERF.md): the forward 8192 points (256 threads, two
// blocks an SM, 128 registers), the inverse 4096 (128 threads, three blocks
// an SM, 168 registers).
template <bool INV>
struct Tile {
  static constexpr int kLogPts = INV ? 12 : 13;
  static constexpr int kPts = 1 << kLogPts;
  static constexpr int kThreads = kPts / 32;  // 32 points a thread
  static constexpr int kMinBlocks = INV ? 3 : 2;
};
// No plan has M below this: every tile fits a row's M points.
constexpr int kMinM = 8192;

// The stages of the F-point DFT for samples of type T, forward or inverse.
template <int LOG_F, typename T, bool INV>
struct Cfg {
  static constexpr int kF = 1 << LOG_F;
  static constexpr int kLogC = Tile<INV>::kLogPts - LOG_F;  // C columns a tile
  static constexpr int kThreads = Tile<INV>::kThreads;
  static constexpr int kC = 1 << kLogC;
  static constexpr int kLogE = sizeof(T) == 4 ? 1 : 2;  // columns of 16 bytes of reals
  static constexpr int kE = 1 << kLogE;
  static constexpr int kRealBits = LOG_F < 5 - kLogE ? LOG_F : 5 - kLogE;
  static constexpr int kRest = LOG_F - kRealBits;
  static constexpr int kBandStages = (kRest + 4) / 5;
  static constexpr int kStages = 1 + kBandStages;
  static constexpr int kLast = kStages - 1;
  __host__ __device__ static constexpr int band_bits(int i) {
    return kRest / kBandStages + (i < kRest % kBandStages ? 1 : 0);
  }
  // The stage that reads or writes the reals: the forward's first, the
  // inverse's last (the only one when F is small).
  __host__ __device__ static constexpr bool real_side(int j) {
    return INV ? j == kLast : j == 0;
  }
  __host__ __device__ static constexpr int bits(int j) {
    return real_side(j) ? kRealBits : band_bits(INV ? j : j - 1);
  }
  __host__ __device__ static constexpr int done(int j) {
    return j == 0 ? 0 : done(j - 1) + bits(j - 1);
  }
  // log2 of stage j's stride in rows, R_j = F / (f_0 ... f_j).
  __host__ __device__ static constexpr int log_stride(int j) { return LOG_F - done(j + 1); }
};

// Stage J's thread geometry: lines of f points, W = 32 / f columns a thread
// (adjacent on the real side, strided by G elsewhere), G column groups.
template <class C, int J>
struct St {
  static constexpr int kBits = C::bits(J);
  static constexpr int kF = 1 << kBits;
  static constexpr int kW = 32 >> kBits;
  static constexpr int kG = C::kC / kW;
  static constexpr int kLogR = C::log_stride(J);
  static constexpr bool kAdj = C::real_side(J);
  static_assert(kG >= 1 && kG * (C::kF / kF) == C::kThreads, "32 points a thread");
  __device__ static int col(int g, int w) { return kAdj ? g * kW + w : g + w * kG; }
};

// The table of M-th roots: lo[swz(i)] = w^i (i < 2^B), hi[j] = w^(j 2^B),
// w = exp(-2 pi i / M), from split_tw (exp(-2 pi i m / N), m = 0 .. M).
struct Roots {
  const float2* lo;  // hi follows it: hi[j] = lo[2^B + j]
  int b;
  __device__ float2 operator()(int e) const {
    return cmul(lo[(1 << b) + (e >> b)], lo[swz(e & ((1 << b) - 1))]);
  }
};

__device__ __forceinline__ Roots load_roots_m(float2* tab, const float2* __restrict__ split_tw,
                                              int log_m) {
  const int b = (log_m + 1) / 2, n_lo = 1 << b, n_hi = 1 << (log_m - b), m = 1 << log_m;
  for (int i = threadIdx.x; i < n_lo + n_hi; i += blockDim.x) {
    const int e = i < n_lo ? i : (i - n_lo) << b;  // w^e = split_tw[2e], or -split_tw[2e - M]
    const float2 w = split_tw[2 * e <= m ? 2 * e : 2 * e - m];
    tab[i < n_lo ? swz(i) : i] = 2 * e <= m ? w : make_float2(-w.x, -w.y);
  }
  return Roots{tab, b};
}

// line_fft_const (long_common.cuh) of F points whose upper half v[F/2 ..]
// is zero: after the bit reversal those sit at the odd slots, so the first
// radix-2 level only copies.
template <int F>
__device__ __forceinline__ void line_fft_half(float2* v) {
  bitrev_swap<F>(v);
#pragma unroll
  for (int i = 0; i < F; i += 2) v[i + 1] = v[i];
  if constexpr (F > 2) line_fft_const<F, 4>(v);
}

template <int F, int LEN>
__device__ __forceinline__ void levels_below(float2* v) {
  if constexpr (LEN < F) {
    fft_level_const<F, LEN>(v);
    levels_below<F, 2 * LEN>(v);
  }
}

template <int F, int J = 0>
__device__ __forceinline__ void low_half_level(float2* v) {
  if constexpr (J < F / 2) {
    const float2 b = mul_root<J * (kMaxFactor / F)>(v[J + F / 2]);
    v[J] = make_float2(v[J].x + b.x, v[J].y + b.y);
    low_half_level<F, J + 1>(v);
  }
}

// line_fft_const with only the outputs v[0 .. F/2) computed.
template <int F>
__device__ __forceinline__ void line_fft_low(float2* v) {
  bitrev_swap<F>(v);
  levels_below<F, 2>(v);
  low_half_level<F>(v);
}

// Frequency (or, inverse, sample row) of the last stage's output t of line
// p: the digits of position p f_L + t, weighted by the earlier factors.
template <class C, int J = 0>
__device__ __forceinline__ int first_of_line(int p) {
  if constexpr (J == C::kLast) {
    return 0;
  } else {
    constexpr int kShift = C::log_stride(J) - C::bits(C::kLast);
    return (((p >> kShift) & ((1 << C::bits(J)) - 1)) << C::done(J)) + first_of_line<C, J + 1>(p);
  }
}

// v[c F + t] *= w^(base + t step) for t < F and each of the W columns c,
// w = exp(-2 pi i / M), mask = M - 1: the root of each group of four,
// w^(base + 4a step), times w^(u step), u < 4 (F/4 + 3 lookups a line, as
// row_fft.cuh's twiddle_line; no more than two roots a product).
template <int F, int W>
__device__ __forceinline__ void line_twiddle(float2* v, const Roots& rt, int base, int step,
                                             int mask) {
  float2 wu[3];
#pragma unroll
  for (int u = 1; u < 4 && u < F; ++u) wu[u - 1] = rt((u * step) & mask);
#pragma unroll
  for (int a = 0; a < F; a += 4) {
    const float2 b = rt((base + a * step) & mask);
#pragma unroll
    for (int u = 0; u < 4 && a + u < F; ++u) {
      const float2 w = u == 0 ? b : cmul(b, wu[u - 1]);
#pragma unroll
      for (int c = 0; c < W; ++c) v[c * F + a + u] = cmul(v[c * F + a + u], w);
    }
  }
}

// v[w f + t] *= exp(-2 pi i t r / S_J), S_J = f_J R_J, for every column w.
template <class C, int J>
__device__ __forceinline__ void stage_twiddle(float2* v, const Roots& rt, int r, int log_m) {
  using S = St<C, J>;
  line_twiddle<S::kF, S::kW>(v, rt, 0, r << (log_m - (S::kBits + S::kLogR)), (1 << log_m) - 1);
}

// Stage J's points of the thread between registers and the tile (row-major,
// C columns): line l = tau / G, p = l / R_J, r = l % R_J, rows
// p S_J + t R_J + r.
template <class C, int J, bool STORE>
__device__ __forceinline__ void tile_io(float2* v, float2* s, int tau) {
  using S = St<C, J>;
  const int g = tau % S::kG, l = tau / S::kG;
  const int r = l & ((1 << S::kLogR) - 1), p = l >> S::kLogR;
  const int base = ((p << (S::kBits + S::kLogR)) + r) << C::kLogC;
#pragma unroll
  for (int t = 0; t < S::kF; ++t) {
    float2* srow = s + base + (t << (S::kLogR + C::kLogC));
    if constexpr (S::kAdj) {
#pragma unroll
      for (int c = 0; c < S::kW; c += 2) {
        float4* a = reinterpret_cast<float4*>(srow + S::col(g, c));
        if constexpr (STORE) {
          *a = make_float4(v[c * S::kF + t].x, v[c * S::kF + t].y, v[(c + 1) * S::kF + t].x,
                           v[(c + 1) * S::kF + t].y);
        } else {
          const float4 x = *a;
          v[c * S::kF + t] = make_float2(x.x, x.y);
          v[(c + 1) * S::kF + t] = make_float2(x.z, x.w);
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < S::kW; ++c) {
        if constexpr (STORE) {
          srow[S::col(g, c)] = v[c * S::kF + t];
        } else {
          v[c * S::kF + t] = srow[S::col(g, c)];
        }
      }
    }
  }
}

// A stage that neither loads nor stores device memory: tile -> registers,
// DFTs, twiddles, registers -> tile.
template <class C, int J = 1>
__device__ __forceinline__ void mid_stages(float2* v, float2* s, const Roots& rt, int log_m) {
  if constexpr (J < C::kLast) {
    using S = St<C, J>;
    __syncthreads();
    const int tau = threadIdx.x;
    tile_io<C, J, false>(v, s, tau);
#pragma unroll
    for (int c = 0; c < S::kW; ++c) line_fft_const<S::kF>(v + c * S::kF);
    stage_twiddle<C, J>(v, rt, (tau / S::kG) & ((1 << S::kLogR) - 1), log_m);
    tile_io<C, J, true>(v, s, tau);
    mid_stages<C, J + 1>(v, s, rt, log_m);
  }
}

// load_vec's 16-byte path alone: samples i .. i + 16/sizeof(T) - 1, all
// below L, on a 16-byte boundary.
template <typename T, bool GATED>
__device__ __forceinline__ void load_whole(float* x, const T* __restrict__ u,
                                           const T* __restrict__ pre, int i) {
  constexpr int kN = 16 / sizeof(T);
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(u + i));
  const T* ua = reinterpret_cast<const T*>(&a);
  if constexpr (GATED) {
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(pre + i));
    const T* pb = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int c = 0; c < kN; ++c) x[c] = to_f(from_f<T>(to_f(ua[c]) * to_f(pb[c])));
  } else {
#pragma unroll
    for (int c = 0; c < kN; ++c) x[c] = to_f(ua[c]);
  }
}

template <typename T>
__device__ __forceinline__ bool aligned_row(const T* a, const T* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

template <int LOG_F, typename T, bool GATED>
__global__ void __launch_bounds__(Tile<false>::kThreads, Tile<false>::kMinBlocks)
    butterfly_fwd_kernel(const T* __restrict__ u, const T* __restrict__ pre,
                         float2* __restrict__ out, const float2* __restrict__ split_tw,
                         int length, int log_band, int tiles) {
  using C = Cfg<LOG_F, T, false>;
  using S0 = St<C, 0>;
  using SL = St<C, C::kLast>;
  extern __shared__ float4 smem_raw[];
  float2* s = reinterpret_cast<float2*>(smem_raw);
  const int log_m = LOG_F + log_band;
  const Roots rt = load_roots_m(s + (C::kC << LOG_F), split_tw, log_m);
  const size_t m = size_t(1) << log_m;
  const int log_tpr = log_band - C::kLogC;  // tiles a row
  const bool half = (long long)length <= (long long)m;
  __syncthreads();
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t row = tile >> log_tpr;
    const int r0 = (tile & ((1 << log_tpr) - 1)) << C::kLogC;
    const T* ur = u + row * length;
    const T* pr = GATED ? pre + row * length : ur;
    const bool aligned = aligned_row(ur, pr);
    const int tau = threadIdx.x;
    float2 v[32];
    // Stage 0: rows n1 = t R_0 + q, columns c0 .. c0 + W, from the reals.
    {
      const int g = tau % S0::kG, q = tau / S0::kG;
      const int c0 = r0 + g * S0::kW;
      // whole rows on 16-byte boundaries: every vector is whole or past L
      const bool whole = aligned && length % (2 << log_band) == 0;
#pragma unroll
      for (int t = 0; t < S0::kF; ++t) {
        const int i = 2 * ((((t << S0::kLogR) + q) << log_band) + c0);
        const bool live = i < length;  // with half, false for every t >= f_0 / 2
#pragma unroll
        for (int e = 0; e < S0::kW; e += C::kE) {
          float x[2 * C::kE];
          if (live && whole) {
            load_whole<T, GATED>(x, ur, pr, i + 2 * e);
          } else if (live) {
            load_vec<T, GATED>(x, ur, pr, i + 2 * e, length, false);
          } else {
#pragma unroll
            for (int a = 0; a < 2 * C::kE; ++a) x[a] = 0.f;
          }
#pragma unroll
          for (int a = 0; a < C::kE; ++a)
            v[(e + a) * S0::kF + t] = make_float2(x[2 * a], x[2 * a + 1]);
        }
      }
      if (half) {
#pragma unroll
        for (int c = 0; c < S0::kW; ++c) line_fft_half<S0::kF>(v + c * S0::kF);
      } else {
#pragma unroll
        for (int c = 0; c < S0::kW; ++c) line_fft_const<S0::kF>(v + c * S0::kF);
      }
      if constexpr (C::kStages == 1) {
        // One stage: band k = t, columns c0 .. c0 + W, with the outer twiddle.
        float2* o = out + row * m + c0;
#pragma unroll
        for (int c = 0; c < S0::kW; ++c)
          line_twiddle<S0::kF, 1>(v + c * S0::kF, rt, 0, c0 + c, int(m) - 1);
#pragma unroll
        for (int t = 0; t < S0::kF; ++t) {
#pragma unroll
          for (int c = 0; c < S0::kW; c += 2) {
            const float2 a = v[c * S0::kF + t], b = v[(c + 1) * S0::kF + t];
            *reinterpret_cast<float4*>(o + ((size_t)t << log_band) + c) =
                make_float4(a.x, a.y, b.x, b.y);
          }
        }
        continue;
      } else {
        stage_twiddle<C, 0>(v, rt, q, log_m);
        tile_io<C, 0, true>(v, s, tau);
      }
    }
    if constexpr (C::kStages > 1) {
      mid_stages<C>(v, s, rt, log_m);
      __syncthreads();
      // The last stage: line p, band k = k_p + (F / f_L) t at column r, with
      // the outer twiddle exp(-2 pi i k r / M).
      const int g = tau % SL::kG, p = tau / SL::kG;
      tile_io<C, C::kLast, false>(v, s, tau);
#pragma unroll
      for (int c = 0; c < SL::kW; ++c) line_fft_const<SL::kF>(v + c * SL::kF);
      const int k0 = first_of_line<C>(p);
#pragma unroll
      for (int c = 0; c < SL::kW; ++c) {
        const int col = r0 + SL::col(g, c);
        line_twiddle<SL::kF, 1>(v + c * SL::kF, rt, k0 * col, col << C::done(C::kLast),
                                int(m) - 1);
      }
      // bands k0, k0 + F / f_L, ...: one running pointer (strided columns)
      static_assert(!SL::kAdj, "the forward's last stage faces the bands");
      float2* o = out + row * m + ((size_t)k0 << log_band) + r0 + g;
      const size_t step = size_t(1) << (C::done(C::kLast) + log_band);
#pragma unroll
      for (int t = 0; t < SL::kF; ++t, o += step) {
#pragma unroll
        for (int c = 0; c < SL::kW; ++c) o[c * SL::kG] = v[c * SL::kF + t];
      }
      __syncthreads();  // the tile is read before the next tile's stage 0 writes it
    }
  }
}

template <int LOG_F, typename T, bool GATED>
__global__ void __launch_bounds__(Tile<true>::kThreads, Tile<true>::kMinBlocks)
    butterfly_inv_kernel(const float2* __restrict__ z, const T* __restrict__ post,
                         T* __restrict__ out, const float2* __restrict__ split_tw, int length,
                         int log_band, int tiles) {
  using C = Cfg<LOG_F, T, true>;
  using S0 = St<C, 0>;
  using SL = St<C, C::kLast>;
  extern __shared__ float4 smem_raw[];
  float2* s = reinterpret_cast<float2*>(smem_raw);
  const int log_m = LOG_F + log_band;
  const Roots rt = load_roots_m(s + (C::kC << LOG_F), split_tw, log_m);
  const size_t m = size_t(1) << log_m;
  const int log_tpr = log_band - C::kLogC;
  const bool half = (long long)length <= (long long)m;
  const float scale = 1.f / (float)C::kF;
  __syncthreads();
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t row = tile >> log_tpr;
    const int r0 = (tile & ((1 << log_tpr) - 1)) << C::kLogC;
    const int tau = threadIdx.x;
    float2 v[32];
    // Stage 0: bands k0 = t R_0 + q, a = conj(z) exp(-2 pi i k0 r / M),
    // whose forward DFT is F times the conjugate of the inverse's.
    {
      const int g = tau % S0::kG, q = tau / S0::kG;
      const float2* zr = z + row * m + r0;
#pragma unroll
      for (int t = 0; t < S0::kF; ++t) {
        const int k0 = (t << S0::kLogR) + q;
        const float2* zb = zr + ((size_t)k0 << log_band);
        if constexpr (S0::kAdj) {
#pragma unroll
          for (int c = 0; c < S0::kW; c += 2) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(zb + S0::col(g, c)));
            v[c * S0::kF + t] = make_float2(a.x, -a.y);
            v[(c + 1) * S0::kF + t] = make_float2(a.z, -a.w);
          }
        } else {
#pragma unroll
          for (int c = 0; c < S0::kW; ++c) {
            const float2 a = __ldg(zb + S0::col(g, c));
            v[c * S0::kF + t] = make_float2(a.x, -a.y);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < S0::kW; ++c) {
        const int col = r0 + S0::col(g, c);
        line_twiddle<S0::kF, 1>(v + c * S0::kF, rt, q * col, col << S0::kLogR, int(m) - 1);
      }
      if constexpr (C::kStages == 1) {
        if (half) {
#pragma unroll
          for (int c = 0; c < S0::kW; ++c) line_fft_low<S0::kF>(v + c * S0::kF);
        } else {
#pragma unroll
          for (int c = 0; c < S0::kW; ++c) line_fft_const<S0::kF>(v + c * S0::kF);
        }
      } else {
#pragma unroll
        for (int c = 0; c < S0::kW; ++c) line_fft_const<S0::kF>(v + c * S0::kF);
        stage_twiddle<C, 0>(v, rt, q, log_m);
        tile_io<C, 0, true>(v, s, tau);
      }
    }
    if constexpr (C::kStages > 1) {
      mid_stages<C>(v, s, rt, log_m);
      __syncthreads();
      tile_io<C, C::kLast, false>(v, s, tau);
      if (half) {
#pragma unroll
        for (int c = 0; c < SL::kW; ++c) line_fft_low<SL::kF>(v + c * SL::kF);
      } else {
#pragma unroll
        for (int c = 0; c < SL::kW; ++c) line_fft_const<SL::kF>(v + c * SL::kF);
      }
    }
    // The real side: rows n1 = n_p + (F / f_L) t, columns c0 .. c0 + W,
    // y = conj(v) / F unpacked to the samples 2 (n1 R + c) and the next.
    {
      const int g = tau % SL::kG, p = tau / SL::kG;
      const int c0 = r0 + g * SL::kW;
      const int n0 = first_of_line<C>(p);
      T* orow = out + row * length;
      const T* prow = GATED ? post + row * length : orow;
      const bool aligned = aligned_row(orow, prow);
#pragma unroll
      for (int t = 0; t < SL::kF; ++t) {
        const int n1 = n0 + (t << C::done(C::kLast));
        const int i = 2 * ((n1 << log_band) + c0);
        if (i >= length || (half && 2 * t >= SL::kF)) continue;
#pragma unroll
        for (int e = 0; e < SL::kW; e += C::kE) {
          float x[2 * C::kE];
#pragma unroll
          for (int a = 0; a < C::kE; ++a) {
            x[2 * a] = v[(e + a) * SL::kF + t].x * scale;
            x[2 * a + 1] = -v[(e + a) * SL::kF + t].y * scale;
          }
          store_vec<T, GATED>(orow, prow, i + 2 * e, length, aligned, x);
        }
      }
    }
    if constexpr (C::kStages > 1) __syncthreads();
  }
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      n = 132;
  }
  return n;
}

// The tile, then the table of M-th roots.
template <bool INV>
size_t smem_bytes(int log_m) {
  const int b = (log_m + 1) / 2;
  return (size_t(Tile<INV>::kPts) + (size_t(1) << b) + (size_t(1) << (log_m - b))) *
         sizeof(float2);
}

// One block per slot the SMs have for the kernel (persistent: a block walks
// over the tiles), at most one a tile.
template <bool INV, class K, class... A>
cudaError_t launch(K kernel, int log_m, int tiles, cudaStream_t stream, A... args) {
  const size_t smem = smem_bytes<INV>(log_m);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Tile<INV>::kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long slots = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  kernel<<<(unsigned)(tiles < slots ? tiles : slots), Tile<INV>::kThreads, smem, stream>>>(
      args..., tiles);
  return cudaGetLastError();
}

template <bool INV, int LOG_F, typename T, bool GATED>
cudaError_t launch_one(const void* x, const void* gate, void* out, const void* split_tw,
                       int length, int log_band, int tiles, cudaStream_t st) {
  const int log_m = LOG_F + log_band;
  if constexpr (INV)
    return launch<true>(butterfly_inv_kernel<LOG_F, T, GATED>, log_m, tiles, st,
                        (const float2*)x, (const T*)gate, (T*)out, (const float2*)split_tw,
                        length, log_band);
  else
    return launch<false>(butterfly_fwd_kernel<LOG_F, T, GATED>, log_m, tiles, st, (const T*)x,
                         (const T*)gate, (float2*)out, (const float2*)split_tw, length,
                         log_band);
}

template <bool INV, int LOG_F>
cudaError_t dispatch(const void* x, const void* gate, void* out, const void* split_tw,
                     int rows, int length, int log_band, int dtype, cudaStream_t st) {
  // tiles of C = pts / F columns, R / C of them a row
  const long long tiles = (long long)rows << (log_band + LOG_F - Tile<INV>::kLogPts);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int n = (int)tiles;
  if (dtype == 0)
    return gate ? launch_one<INV, LOG_F, float, true>(x, gate, out, split_tw, length, log_band,
                                                      n, st)
                : launch_one<INV, LOG_F, float, false>(x, gate, out, split_tw, length,
                                                       log_band, n, st);
  return gate ? launch_one<INV, LOG_F, __nv_bfloat16, true>(x, gate, out, split_tw, length,
                                                            log_band, n, st)
              : launch_one<INV, LOG_F, __nv_bfloat16, false>(x, gate, out, split_tw, length,
                                                             log_band, n, st);
}

template <bool INV>
int entry(const void* x, const void* gate, void* out, const void* split_tw, int rows,
          int length, int outer, int band, int dtype, void* stream) {
  auto pow2 = [](int v) { return v >= 1 && (v & (v - 1)) == 0; };
  if (!pow2(outer) || !pow2(band) || outer < 4 || outer > 512 || band < 128 || band > 8192 ||
      (long long)outer * band > (1LL << 21) || (long long)outer * band < kMinM || rows < 1 ||
      length < 1 || (long long)length > 2LL * outer * band || (dtype != 0 && dtype != 1) ||
      (INV && (reinterpret_cast<uintptr_t>(x) & 15)))
    return (int)cudaErrorInvalidValue;
  const int log_band = ilog2(band);
  cudaStream_t st = (cudaStream_t)stream;
#define FFC_BFLY_CASE(LOG_F) \
  case LOG_F:                \
    return (int)dispatch<INV, LOG_F>(x, gate, out, split_tw, rows, length, log_band, dtype, st);
  switch (ilog2(outer)) {
    FFC_BFLY_CASE(2)
    FFC_BFLY_CASE(3)
    FFC_BFLY_CASE(4)
    FFC_BFLY_CASE(5)
    FFC_BFLY_CASE(6)
    FFC_BFLY_CASE(7)
    FFC_BFLY_CASE(8)
    FFC_BFLY_CASE(9)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFC_BFLY_CASE
}

}  // namespace bfly
}  // namespace ffc

// dtype: 0 = float32, 1 = bfloat16. gate (the pregate) may be null.
// u: (rows, length) reals; out: (rows, outer, band) complex64.
extern "C" int ffc_butterfly_fwd(const void* u, const void* gate, void* out, const void* split_tw,
                                 int rows, int length, int outer, int band, int dtype,
                                 void* stream) {
  return ffc::bfly::entry<false>(u, gate, out, split_tw, rows, length, outer, band, dtype,
                                 stream);
}

// z: (rows, outer, band) complex64 on a 16-byte boundary; out: (rows,
// length) reals; gate (the postgate) may be null.
extern "C" int ffc_butterfly_inv(const void* z, const void* gate, void* out, const void* split_tw,
                                 int rows, int length, int outer, int band, int dtype,
                                 void* stream) {
  return ffc::bfly::entry<true>(z, gate, out, split_tw, rows, length, outer, band, dtype,
                                stream);
}

FFC_EXPORT_ERROR_STRING()
