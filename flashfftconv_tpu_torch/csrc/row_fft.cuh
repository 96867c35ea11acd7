// The in-register row FFT of spectrum.cu, monarch_conv.cu,
// monarch_conv_bwd.cu (the backward, which the direct plans' backward runs
// too, and dk_finish) and band_conv.cu (a complex band of M points): an
// M-point complex FFT of a packed real row (z[n] = x[2n] + i x[2n+1], M = N/2) with
// every size, factor, stride and register index a compile-time constant, so
// a thread's points never leave registers.
//
// A row is owned by T = M/P threads, P points each (8 up to M = 256, 16 up to
// 2048, 32 above); up to M = 1024 a block of 128 threads takes 128/T rows.
// The FFT is Cooley-Tukey over stages of at most P points:
//   - stage 0 gives each thread E lines of P/E points at stride E*T (the
//     caller loads them: spectrum.cu, monarch_conv.cu, the backward and
//     band_conv.cu straight from device memory, E points, 16 bytes, a load);
//   - each later stage reads its lines from shared memory, transforms them
//     in registers and writes them back (mid_stages);
//   - the last stage writes its outputs in natural frequency order
//     (last_stage).
// Shared memory is addressed through an XOR swizzle of the low 4 bits of a
// point's index by the next 4 (swz), which keeps the strided stage accesses
// free of bank conflicts without padding.
// Twiddles: line DFTs of 2-32 points (line_fft_const, long_common.cuh) take
// the 32nd roots as compile-time constants (1 and -i cost no multiply);
// the stage twiddles and the split's exp(-2 pi i f / N) are products of two
// entries of a small table of N-th roots (N >> B coarse and 2^B fine,
// B = ceil(log2(N) / 2): 384 entries at N=32768), which each block copies
// once from the plan's exact split_tw into shared memory (load_table). A
// line's twiddles w^k, k < F, are w^(4a) * w^c, c < 4, so a line makes
// F/4 + 3 table lookups.
#pragma once

#include "long_common.cuh"

namespace ffc {
namespace row {

template <int LOG_M, int LOG_E = 1>
struct Cfg {
  static constexpr int kM = 1 << LOG_M;
  static constexpr int kLogN = LOG_M + 1;
  static constexpr int kLogP = LOG_M <= 8 ? 3 : LOG_M <= 11 ? 4 : 5;
  static constexpr int kP = 1 << kLogP;                  // points a thread
  static constexpr int kT = kM / kP;                     // threads a row
  static constexpr int kRows = LOG_M <= 10 ? 128 / kT : 1;
  static constexpr int kThreads = kT * kRows;
  static constexpr int kE = 1 << LOG_E;                  // stage 0's lines a thread
  static constexpr int kF0 = kP / kE;                    // stage 0's points a line
  static constexpr int kR0 = kE * kT;                    // stage 0's stride
  // Stage bits: stage 0 takes P/E points; the rest of log2 M is split into
  // the fewest stages of at most P points, as evenly as possible.
  static constexpr int kBits0 = kLogP - LOG_E;
  static constexpr int kRest = LOG_M - kBits0;
  static constexpr int kLast = (kRest + kLogP - 1) / kLogP;  // index of the last stage
  __host__ __device__ static constexpr int bits(int j) {
    return j == 0 ? kBits0 : kRest / kLast + (j - 1 < kRest % kLast ? 1 : 0);
  }
  __host__ __device__ static constexpr int done(int j) {
    return j == 0 ? 0 : done(j - 1) + bits(j - 1);
  }
  __host__ __device__ static constexpr int log_stride(int j) { return LOG_M - done(j + 1); }
  // Root table: exp(-2 pi i m / N) = hi[m >> kB] * lo[m & (kLo - 1)].
  static constexpr int kB = (kLogN + 1) / 2;
  static constexpr int kLo = 1 << kB;
  static constexpr int kHi = (2 * kM) >> kB;
  static constexpr size_t kSmem = (size_t(kRows) * kM + kLo + kHi) * sizeof(float2);
  static constexpr int kMinBlocks = 65536 / (kThreads * 128);  // <= 128 registers a thread
};

// threadIdx.x, read anew. A kernel whose inverse FFT's index math (line
// bases, swizzled slots, frequencies) repeats the forward's, or whose store
// needs the row's offset that its loads had, recomputes each from a second
// read (which the compiler cannot merge with the first) where it is used,
// instead of keeping it in registers through the FFTs, which took
// monarch_conv's sizes from N = 8192 up past 128 registers.
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// Shared-memory slot of point i of a row.
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 4) & 15); }

template <class C>
__device__ __forceinline__ float2 root(const float2* tab, int m) {
  return cmul(tab[C::kLo + (m >> C::kB)], tab[m & (C::kLo - 1)]);
}

// The block's root table from split_tw (exp(-2 pi i m / N), m = 0 .. M).
template <class C>
__device__ __forceinline__ void load_table(float2* tab, const float2* __restrict__ split_tw) {
  for (int i = threadIdx.x; i < C::kLo + C::kHi; i += C::kThreads) {
    if (i < C::kLo) {
      tab[i] = split_tw[i];
    } else {
      const int m = (i - C::kLo) << C::kB;
      const float2 w = split_tw[m <= C::kM ? m : m - C::kM];
      tab[i] = m <= C::kM ? w : make_float2(-w.x, -w.y);
    }
  }
}

// v[k] *= w^k for k < F, w = exp(-2 pi i m1 / N).
template <class C, int F>
__device__ __forceinline__ void twiddle_line(float2* v, const float2* tab, int m1) {
  const float2 w1 = root<C>(tab, m1);
  v[1] = cmul(v[1], w1);
  if constexpr (F > 2) {
    const float2 w2 = root<C>(tab, 2 * m1), w3 = root<C>(tab, 3 * m1);
    v[2] = cmul(v[2], w2);
    v[3] = cmul(v[3], w3);
#pragma unroll
    for (int a = 4; a < F; a += 4) {
      const float2 b = root<C>(tab, a * m1);
      v[a] = cmul(v[a], b);
      v[a + 1] = cmul(v[a + 1], cmul(b, w1));
      v[a + 2] = cmul(v[a + 2], cmul(b, w2));
      v[a + 3] = cmul(v[a + 3], cmul(b, w3));
    }
  }
}

// Stage 0 of one line r held at v (points z[u * R0 + r], u < F0): DFT, the
// twiddles w^(k r) with w = exp(-2 pi i / M), and the store to its slots.
template <class C>
__device__ __forceinline__ void first_stage_line(float2* v, float2* s, const float2* tab, int r) {
  line_fft_const<C::kF0>(v);
  twiddle_line<C, C::kF0>(v, tab, 2 * r);
#pragma unroll
  for (int u = 0; u < C::kF0; ++u) s[swz(u * C::kR0 + r)] = v[u];
}

// Stage J (0 < J < last) in place: lines l = tr + T*i, points
// (l / R) * F * R + u * R + l % R, u < F; DFT, then w^(k r) with
// w = exp(-2 pi i / (F R)). FRESH: the stores' slots are recomputed from tr
// passed through a warp shuffle, which the compiler cannot fold, instead of
// kept from the loads: in monarch_conv_bwd's kernel the P slot addresses
// held through the DFT spilled (a second %tid.x read, fresh_tid, was
// merged with the first).
template <class C, int J, bool FRESH = false>
__device__ __forceinline__ void mid_stage(float2 (&v)[C::kP], float2* s, const float2* tab,
                                          int tr) {
  constexpr int kF = 1 << C::bits(J), kLogR = C::log_stride(J), kR = 1 << kLogR;
  constexpr int kLines = C::kP / kF;
  const auto line_base = [](int l) {
    return ((l >> kLogR) << (C::bits(J) + kLogR)) + (l & (kR - 1));
  };
  int base[kLines];
#pragma unroll
  for (int i = 0; i < kLines; ++i) {
    base[i] = line_base(tr + C::kT * i);
#pragma unroll
    for (int u = 0; u < kF; ++u) v[i * kF + u] = s[swz(base[i] + u * kR)];
  }
#pragma unroll
  for (int i = 0; i < kLines; ++i) {
    line_fft_const<kF>(v + i * kF);
    const int r = (tr + C::kT * i) & (kR - 1);
    twiddle_line<C, kF>(v + i * kF, tab, r << (C::kLogN - C::bits(J) - kLogR));
    const int b = FRESH ? line_base(__shfl_sync(0xffffffffu, tr, threadIdx.x & 31) + C::kT * i)
                        : base[i];
#pragma unroll
    for (int u = 0; u < kF; ++u) s[swz(b + u * kR)] = v[i * kF + u];
  }
}

// Every stage between the first and the last, each after a barrier.
template <class C, int J = 1, bool FRESH = false>
__device__ __forceinline__ void mid_stages(float2 (&v)[C::kP], float2* s, const float2* tab,
                                           int tr) {
  if constexpr (J < C::kLast) {
    __syncthreads();
    mid_stage<C, J, FRESH>(v, s, tab, tr);
    mid_stages<C, J + 1, FRESH>(v, s, tab, tr);
  }
}

// Frequency of the last stage's output k of line p: the digits k_j of the
// position p * F_last + k, weighted by the product of the earlier factors.
template <class C, int J = 0>
__device__ __forceinline__ int freq_of_line(int p) {
  if constexpr (J == C::kLast) {
    return 0;
  } else {
    constexpr int kShift = C::log_stride(J) - C::bits(C::kLast);
    return (((p >> kShift) & ((1 << C::bits(J)) - 1)) << C::done(J)) + freq_of_line<C, J + 1>(p);
  }
}

// The last stage, after a barrier: contiguous lines p = tr + T*i, their
// outputs to their natural-order slots, so every line is read before any is
// written. The caller synchronises before it reads the result.
template <class C>
__device__ __forceinline__ void last_stage(float2 (&v)[C::kP], float2* s, int tr) {
  constexpr int kF = 1 << C::bits(C::kLast), kLines = C::kP / kF;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kLines; ++i) {
    const int p = tr + C::kT * i;
#pragma unroll
    for (int u = 0; u < kF; ++u) v[i * kF + u] = s[swz(p * kF + u)];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kLines; ++i) {
    const int p = tr + C::kT * i;
    line_fft_const<kF>(v + i * kF);
    const int f0 = freq_of_line<C>(p);
#pragma unroll
    for (int u = 0; u < kF; ++u) s[swz(f0 + (u << C::done(C::kLast)))] = v[i * kF + u];
  }
}

// Rows of (B, H, L) operands at T (monarch_conv.cu, monarch_conv_bwd.cu).

// The row configuration for samples of type T: E = 16 bytes / (2 sizeof T)
// packed points a load.
template <int LOG_M, typename T>
using CfgT = Cfg<LOG_M, sizeof(T) == 4 ? 1 : 2>;

// Samples i .. i + 16/sizeof(T) - 1 of the (gated) input into x: one
// 16-byte load of each operand where the row is aligned and whole there,
// a sample at a time otherwise (load_real, long_common.cuh). The gate's
// product is rounded to T (u * pregate, as the forward convolves it) unless
// ROUND is false (dout * postgate, which the backward keeps in f32).
template <typename T, bool GATED, bool ROUND = true>
__device__ __forceinline__ void load_vec(float* x, const T* __restrict__ u,
                                         const T* __restrict__ pre, int i, int length,
                                         bool aligned) {
  constexpr int kN = 16 / sizeof(T);
  if (aligned && i + kN <= length) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(u + i));
    const T* ua = reinterpret_cast<const T*>(&a);
    if constexpr (GATED) {
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(pre + i));
      const T* pb = reinterpret_cast<const T*>(&b);
#pragma unroll
      for (int c = 0; c < kN; ++c) {
        const float p = to_f(ua[c]) * to_f(pb[c]);
        x[c] = ROUND ? to_f(from_f<T>(p)) : p;
      }
    } else {
#pragma unroll
      for (int c = 0; c < kN; ++c) x[c] = to_f(ua[c]);
    }
  } else if constexpr (ROUND || !GATED) {
#pragma unroll
    for (int c = 0; c < kN; ++c) x[c] = load_real<T, GATED>(u, pre, i + c, length);
  } else {
#pragma unroll
    for (int c = 0; c < kN; ++c) x[c] = i + c < length ? to_f(u[i + c]) * to_f(pre[i + c]) : 0.f;
  }
}

// y (16/sizeof(T) samples, times the postgate) to out[i ..], truncated at L.
template <typename T, bool GATED>
__device__ __forceinline__ void store_vec(T* __restrict__ out, const T* __restrict__ post,
                                          int i, int length, bool aligned, float* y) {
  constexpr int kN = 16 / sizeof(T);
  if (aligned && i + kN <= length) {
    if constexpr (GATED) {
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(post + i));
      const T* pb = reinterpret_cast<const T*>(&b);
#pragma unroll
      for (int c = 0; c < kN; ++c) y[c] *= to_f(pb[c]);
    }
    uint4 r;
    T* rt = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int c = 0; c < kN; ++c) rt[c] = from_f<T>(y[c]);
    *reinterpret_cast<uint4*>(out + i) = r;
  } else {
#pragma unroll
    for (int c = 0; c < kN; ++c) store_real<T, GATED>(out, post, i + c, length, y[c]);
  }
}

// The offset of the row of thread tid in the (B, H, L) operands, and its
// channel h: blocks run channel-major (row = h B + b). False past B * H.
template <class C>
__device__ __forceinline__ bool row_offset(int tid, int batch, int channels, int length,
                                           size_t& off, int& h) {
  const int row = blockIdx.x * C::kRows + tid / C::kT;
  const bool active = row < batch * channels;
  h = active ? row / batch : 0;
  off = ((size_t)(active ? row - h * batch : 0) * channels + h) * length;
  return active;
}

template <typename T>
__device__ __forceinline__ bool aligned16(const T* a, const T* b, const T* c, const T* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) &
          15) == 0;
}

// Blocks an SM the kernel is compiled for: spectrum's, but three at N = 8192.
template <int LOG_M, typename T>
constexpr int min_blocks() {
  return LOG_M == 12 ? 3 : CfgT<LOG_M, T>::kMinBlocks;
}

}  // namespace row
}  // namespace ffc
