// The band unit of the long band kernels: long_conv.cu (the forward's band
// conv), long_conv_bwd.cu (the backward's band kernel and long_dk_finish).
//
// Between two butterfly passes a row of the packed M = N/2 point signal lies
// in device memory as F bands of R points (long_common.cuh): band k0 holds,
// after its R-point FFT, the frequencies k = k0 + F j. The split of the real
// FFT pairs k with M - k, which lies in band F - k0 at slot R - 1 - j (band
// 0 pairs with itself at slot (R - j) mod R), so the kernels take the band
// pair {k0, F - k0} of a row together.
//
// A band is a unit: T = R / P threads (P = 32 points a thread from R = 4096,
// 128 threads there) and one row of R complex points in XOR-swizzled shared
// memory (row_fft.cuh). Pair c = 0 .. F/2 - 1 of a row holds the units of
// bands 0 and F/2 (c = 0; each its own partner) or c and F - c (unit_band).
// A unit runs the forward FFT of its band on the in-register row FFT of
// row_fft.cuh (band_conv.cu's complex instance: every index a compile-time
// constant, stage 0 loaded straight from device memory at two complex
// points, 16 bytes, a load; natural order out: band_forward). Then, after a
// barrier, one pass over the frequency pairs: the unit of band k0 takes its
// own slots j < pass_slots(k0, R) and the partner's slot partner_slot(k0, j,
// R), so that every slot of the pair has one reader and one writer in the
// pass. The split twiddle exp(-2 pi i (k0 + F j) / N) is split_tw[k0] of
// the plan (one value a unit) times exp(-2 pi i j / 2R), an entry of the row
// FFT's own root table (the band plan's split_tw, load_band_table): no
// gather. The pass writes the conjugate of what the inverse transform takes,
// and after a second barrier each unit takes the inverse FFT as the forward
// FFT of that conjugate (stage 0 from shared memory) and stores its band
// conjugated and scaled by 1/R, 16 bytes a store (band_inverse_store). A unit
// reads and writes only its own band in device memory, so a kernel may write
// its output over its input.
#pragma once

#include "row_fft.cuh"

namespace ffc {
namespace lband {

using namespace row;

// Band lengths of the instances: R = 2^7 ... 2^13 (plan.MIN_BAND, MAX_BAND).
constexpr int kMinLogBand = 7;
constexpr int kMaxLogBand = 13;

// Two complex points (16 bytes) a load and a store: stage 0's E = 2.
template <int LOG_R>
using CfgB = Cfg<LOG_R, 1>;

// The band of unit `side` (0 or 1) of pair c of a row of `outer` bands.
__host__ __device__ constexpr int unit_band(int c, int side, int outer) {
  return c == 0 ? side * (outer / 2) : (side == 0 ? c : outer - c);
}

// The pair pass of the unit of band k0 takes its slots j < pass_slots.
__host__ __device__ constexpr int pass_slots(int k0, int band) {
  return k0 == 0 ? band / 2 + 1 : band / 2;
}

// The slot of the partner's row that holds frequency M - (k0 + F j).
__host__ __device__ constexpr int partner_slot(int k0, int j, int band) {
  return k0 == 0 ? (band - j) & (band - 1) : band - 1 - j;
}

// The row FFT's root table from the band plan's split_tw, by every thread of
// the block (row::load_table strides by a whole row_fft block).
template <class C>
__device__ __forceinline__ void load_band_table(float2* tab, const float2* __restrict__ band_tw) {
  for (int i = threadIdx.x; i < C::kLo + C::kHi; i += blockDim.x) {
    if (i < C::kLo) {
      tab[i] = band_tw[i];
    } else {
      const int m = (i - C::kLo) << C::kB;
      const float2 w = band_tw[m <= C::kM ? m : m - C::kM];
      tab[i] = m <= C::kM ? w : make_float2(-w.x, -w.y);
    }
  }
}

// The forward R-point FFT of the band at z (device memory) into s, natural
// order; the caller synchronises before it reads s.
template <class C>
__device__ __forceinline__ void band_forward(const float2* __restrict__ z, float2* s,
                                             const float2* tab, int tr) {
  float2 v[C::kP];
#pragma unroll
  for (int j = 0; j < C::kF0; ++j) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(z) + j * C::kT + tr);
    v[j] = make_float2(a.x, a.y);
    v[C::kF0 + j] = make_float2(a.z, a.w);
  }
#pragma unroll
  for (int e = 0; e < C::kE; ++e) first_stage_line<C>(v + e * C::kF0, s, tab, C::kE * tr + e);
  mid_stages<C>(v, s, tab, tr);
  last_stage<C>(v, s, tr);
}

// The forward FFT of the conjugated spectrum in s, in place (stage 0's lines
// those of thread tr ^ 1, so that no slot address lives from it to the
// store), then out[n] = conj(s[n]) / R, 16 bytes a store.
template <class C>
__device__ __forceinline__ void band_inverse_store(float2* s, float2* __restrict__ out,
                                                   const float2* tab, int tr) {
  float2 v[C::kP];
  {
    const int t0 = tr ^ (C::kT > 1 ? 1 : 0);
#pragma unroll
    for (int e = 0; e < C::kE; ++e)
#pragma unroll
      for (int j = 0; j < C::kF0; ++j) v[e * C::kF0 + j] = s[swz(j * C::kR0 + C::kE * t0 + e)];
#pragma unroll
    for (int e = 0; e < C::kE; ++e) first_stage_line<C>(v + e * C::kF0, s, tab, C::kE * t0 + e);
  }
  mid_stages<C>(v, s, tab, tr);
  last_stage<C>(v, s, tr);
  __syncthreads();
  const int t = fresh_tid() % C::kT;
  const float scale = 1.f / (float)C::kM;
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int q = 0; q < C::kP / C::kE; ++q) {
    const int n0 = C::kE * (t + C::kT * q);
    const float2 a = s[swz(n0)], c = s[swz(n0 + 1)];
    o[t + C::kT * q] = make_float4(a.x * scale, -a.y * scale, c.x * scale, -c.y * scale);
  }
}

// A block of long_conv and long_dk_finish: the two units of one band pair
// of R = 2^LOG_R points, block i of a row holding pair c = i (F/2 blocks a
// row). Compiled for as many blocks an SM as leave each thread 128
// registers: two at R = 4096, one at 8192 (where long_conv takes one unit
// for both bands). Two adjacent pairs a block, so that the pairs'
// natural-order reads share their 32-byte sectors, ran slower (PERF.md).
template <int LOG_R>
struct PairBlock {
  using C = CfgB<LOG_R>;
  static constexpr int kThreads = 2 * C::kT;
  static constexpr int kMinBlocks =
      65536 / (kThreads * 128) > 0 ? 65536 / (kThreads * 128) : 1;
  static constexpr size_t kSmem = (size_t(2) * C::kM + C::kLo + C::kHi) * sizeof(float2);
};

// The offset in (rows, F, R) bands of band `side` (0 or 1) of the block's
// pair, for a grid of F/2 blocks a row and rows in the order h B + b.
template <class C>
__device__ __forceinline__ size_t unit_offset(int side, int batch, int channels, int outer) {
  const int half = outer / 2;
  const int bh = blockIdx.x / half;
  const int h = bh / batch, b = bh - h * batch;
  const int k0 = unit_band(blockIdx.x % half, side, outer);
  return (((size_t)b * channels + h) * outer + k0) * (size_t)C::kM;
}

// Checks of the C entries of long_conv and long_dk_finish: powers of two, R
// in the instances' range, N = 2 F R at most 2^22, and a grid within its x
// range at a block a pair.
inline bool bands_ok(long long rows, int outer, int band) {
  auto pow2 = [](int v) { return v >= 1 && (v & (v - 1)) == 0; };
  return rows >= 1 && pow2(outer) && outer >= 2 && pow2(band) &&
         band >= (1 << kMinLogBand) && band <= (1 << kMaxLogBand) &&
         (long long)outer * band <= (1LL << 21) && rows * (outer / 2) <= 0x7fffffffLL;
}

inline bool aligned16(const void* a) { return (reinterpret_cast<uintptr_t>(a) & 15) == 0; }

}  // namespace lband
}  // namespace ffc
