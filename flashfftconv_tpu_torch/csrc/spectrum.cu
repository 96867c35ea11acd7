// spectrum: half spectrum of the long-conv kernel taps.
//
// Replaces the TPU kernel _spectrum_tiles (flashfftconv_tpu/ops/
// monarch_pallas.py, def at l.558, pallas_call at l.602), which takes real
// taps (H, N1, N2) to a planar Monarch-layout spectrum of all N frequencies.
// Here: real f32 taps (H, k_len <= N), zero-padded to N inside the kernel,
// to the natural-order half spectrum (H, M+1) of complex f32 (interleaved
// re/im, torch.complex64), M = N/2 -- everything a real conv needs.
//
// Bound on the H100: bytes. The kernel reads the taps once and writes M+1
// complex values a row; the FFT in between (about 5 M log2 M f32 operations
// a row) is far below the f32 rate. At H=768, k_len=8192, N=16384 it reads
// 25 MB and writes 50 MB.
//
// Design. One instantiation per FFT size (spectrum_kernel<LOG_M>; the C
// entry dispatches on N), every size, factor, stride and register index a
// compile-time constant, so a thread's points never leave registers (ptxas
// reports no stack frame and no spills for any instantiation). A row of M
// packed points z[n] = x[2n] + i x[2n+1] is owned by T = M/P threads, P
// points each (8 up to M = 256, 16 up to 2048, 32 above); up to M = 1024 a
// block of 128 threads takes 128/T rows, so every thread owns points at
// small N (M2-BERT's N=256 is 8 rows a block) and the grid has more blocks.
// The M-point FFT is Cooley-Tukey over stages of at most P points:
//   - stage 0 (P/2 points, stride 2T) loads straight from device memory into
//     registers, one 16-byte load of 4 taps (2 packed points) a step where
//     the row start is 16-byte aligned, scalar loads at a ragged end or an
//     unaligned row; a tap past k_len is a zero that is never loaded, so
//     with k_len <= N/2 (Hyena, H3) half of the row costs no traffic;
//   - each later stage reads its lines from shared memory, transforms them
//     in registers and writes them back: one or two shared-memory passes
//     join the register passes (three stages at N=16384, factors 16, 32, 16);
//   - the last stage writes its outputs in natural frequency order, and the
//     split X[f] = A + B (fft_common.cuh split_pair) reads Z[f] and Z[M-f]
//     from there and stores X[f], X[f+1] in order as one 16-byte store.
// Shared memory is addressed through an XOR swizzle of the low 4 bits of a
// point's index by the next 4 (swz), which keeps the strided stage accesses
// free of bank conflicts without padding.
// Twiddles: line DFTs of 2-32 points (line_fft_const, long_common.cuh) take
// the 32nd roots as compile-time constants (1 and -i cost no multiply);
// the stage twiddles and the split's exp(-2 pi i f / N) are products of two
// entries of a small table of N-th roots (N >> B coarse and 2^B fine,
// B = ceil(log2(N) / 2): 384 entries at N=32768), which each block copies
// once from the plan's exact split_tw into shared memory. A line's
// twiddles w^k, k < F, are w^(4a) * w^c, c < 4, so a line makes F/4 + 3
// table lookups.

#include "long_common.cuh"

namespace ffc {
namespace spec {

template <int LOG_M>
struct Cfg {
  static constexpr int kM = 1 << LOG_M;
  static constexpr int kLogN = LOG_M + 1;
  static constexpr int kLogP = LOG_M <= 8 ? 3 : LOG_M <= 11 ? 4 : 5;
  static constexpr int kP = 1 << kLogP;                  // points a thread
  static constexpr int kT = kM / kP;                     // threads a row
  static constexpr int kRows = LOG_M <= 10 ? 128 / kT : 1;
  static constexpr int kThreads = kT * kRows;
  // Stage bits: stage 0 takes P/2 points; the rest of log2 M is split into
  // the fewest stages of at most P points, as evenly as possible.
  static constexpr int kBits0 = kLogP - 1;
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

// Shared-memory slot of point i of a row.
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 4) & 15); }

template <class C>
__device__ __forceinline__ float2 root(const float2* tab, int m) {
  return cmul(tab[C::kLo + (m >> C::kB)], tab[m & (C::kLo - 1)]);
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

// Stage J (0 < J < last) in place: lines l = tr + T*i, points
// (l / R) * F * R + u * R + l % R, u < F; DFT, then w^(k r) with
// w = exp(-2 pi i / (F R)).
template <class C, int J>
__device__ __forceinline__ void mid_stage(float2 (&v)[C::kP], float2* s, const float2* tab,
                                          int tr) {
  constexpr int kF = 1 << C::bits(J), kLogR = C::log_stride(J), kR = 1 << kLogR;
  constexpr int kLines = C::kP / kF;
  int base[kLines];
#pragma unroll
  for (int i = 0; i < kLines; ++i) {
    const int l = tr + C::kT * i;
    base[i] = ((l >> kLogR) << (C::bits(J) + kLogR)) + (l & (kR - 1));
#pragma unroll
    for (int u = 0; u < kF; ++u) v[i * kF + u] = s[swz(base[i] + u * kR)];
  }
#pragma unroll
  for (int i = 0; i < kLines; ++i) {
    line_fft_const<kF>(v + i * kF);
    const int r = (tr + C::kT * i) & (kR - 1);
    twiddle_line<C, kF>(v + i * kF, tab, r << (C::kLogN - C::bits(J) - kLogR));
#pragma unroll
    for (int u = 0; u < kF; ++u) s[swz(base[i] + u * kR)] = v[i * kF + u];
  }
}

template <class C, int J = 1>
__device__ __forceinline__ void mid_stages(float2 (&v)[C::kP], float2* s, const float2* tab,
                                           int tr) {
  if constexpr (J < C::kLast) {
    __syncthreads();
    mid_stage<C, J>(v, s, tab, tr);
    mid_stages<C, J + 1>(v, s, tab, tr);
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

template <int LOG_M>
__global__ void __launch_bounds__(Cfg<LOG_M>::kThreads, Cfg<LOG_M>::kMinBlocks)
    spectrum_kernel(const float* __restrict__ k, float2* __restrict__ out,
                    const float2* __restrict__ split_tw, int channels, int k_len) {
  using C = Cfg<LOG_M>;
  constexpr int kM = C::kM, kT = C::kT, kP = C::kP;
  constexpr int kF0 = kP / 2, kR0 = 2 * kT;
  extern __shared__ float4 smem_raw[];
  float2* smem = reinterpret_cast<float2*>(smem_raw);
  const int tr = threadIdx.x % kT;
  const int row = blockIdx.x * C::kRows + threadIdx.x / kT;
  const bool active = row < channels;
  float2* s = smem + (threadIdx.x / kT) * kM;
  float2* tab = smem + C::kRows * kM;

  // Stage 0's lines r = 2 tr + e, e < 2: v[e * F0 + u] = z[u * R0 + r],
  // the packed points of taps 4 (u T + tr) .. + 3.
  float2 v[kP];
  {
    const float* kr = k + (size_t)(active ? row : 0) * k_len;
    const bool aligned = (reinterpret_cast<uintptr_t>(kr) & 15) == 0;
#pragma unroll
    for (int u = 0; u < kF0; ++u) {
      const int i = 4 * (u * kT + tr);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (active && i < k_len) {
        if (aligned && i + 4 <= k_len) {
          x = __ldg(reinterpret_cast<const float4*>(kr + i));
        } else {
          x.x = kr[i];
          if (i + 1 < k_len) x.y = kr[i + 1];
          if (i + 2 < k_len) x.z = kr[i + 2];
          if (i + 3 < k_len) x.w = kr[i + 3];
        }
      }
      v[u] = make_float2(x.x, x.y);
      v[kF0 + u] = make_float2(x.z, x.w);
    }
  }
  for (int i = threadIdx.x; i < C::kLo + C::kHi; i += C::kThreads) {
    if (i < C::kLo) {
      tab[i] = split_tw[i];
    } else {
      const int m = (i - C::kLo) << C::kB;
      const float2 w = split_tw[m <= kM ? m : m - kM];
      tab[i] = m <= kM ? w : make_float2(-w.x, -w.y);
    }
  }
  __syncthreads();

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = 2 * tr + e;
    line_fft_const<kF0>(v + e * kF0);
    twiddle_line<C, kF0>(v + e * kF0, tab, 2 * r);
#pragma unroll
    for (int u = 0; u < kF0; ++u) s[swz(u * kR0 + r)] = v[e * kF0 + u];
  }

  mid_stages<C>(v, s, tab, tr);

  // Last stage: contiguous lines p = tr + T*i; the outputs go to their
  // natural-order slots, so every line is read before any is written.
  {
    constexpr int kF = 1 << C::bits(C::kLast), kLines = kP / kF;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kLines; ++i) {
      const int p = tr + kT * i;
#pragma unroll
      for (int u = 0; u < kF; ++u) v[i * kF + u] = s[swz(p * kF + u)];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kLines; ++i) {
      const int p = tr + kT * i;
      line_fft_const<kF>(v + i * kF);
      const int f0 = freq_of_line<C>(p);
#pragma unroll
      for (int u = 0; u < kF; ++u) s[swz(f0 + (u << C::done(C::kLast)))] = v[i * kF + u];
    }
  }
  __syncthreads();
  if (!active) return;

  // Split: X[f] from Z[f] and Z[M - f] (Z[M] = Z[0]); pairs X[f], X[f+1]
  // with f + the row's offset even, so each pair is one aligned 16-byte
  // store; the one odd element (X[M] or X[0]) alone.
  float2* o = out + (size_t)row * (kM + 1);
  const int a = (reinterpret_cast<uintptr_t>(o) >> 3) & 1;
#pragma unroll
  for (int i = 0; i < kP / 2; ++i) {
    const int f = a + 2 * (tr + kT * i);
    float2 x[2], unused;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int g = f + c;
      split_pair(s[swz(g & (kM - 1))], s[swz((kM - g) & (kM - 1))], root<C>(tab, g), x[c],
                 unused);
    }
    *reinterpret_cast<float4*>(o + f) = make_float4(x[0].x, x[0].y, x[1].x, x[1].y);
  }
  if (tr == 0) {
    const int g = a ? 0 : kM;
    float2 x, unused;
    split_pair(s[0], s[0], root<C>(tab, g), x, unused);
    o[g] = x;
  }
}

template <int LOG_M>
cudaError_t launch(const float* k, float2* out, const float2* split_tw, int channels, int k_len,
                   cudaStream_t stream) {
  using C = Cfg<LOG_M>;
  if constexpr (C::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spectrum_kernel<LOG_M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (channels + C::kRows - 1) / C::kRows;
  spectrum_kernel<LOG_M><<<blocks, C::kThreads, C::kSmem, stream>>>(k, out, split_tw, channels,
                                                                     k_len);
  return cudaGetLastError();
}

}  // namespace spec
}  // namespace ffc

extern "C" int ffc_spectrum(const void* k, void* out, const void* split_tw, int channels,
                            int k_len, int n, void* stream) {
  if (channels < 1 || k_len < 1 || k_len > n) return (int)cudaErrorInvalidValue;
  const float* kp = (const float*)k;
  float2* op = (float2*)out;
  const float2* tw = (const float2*)split_tw;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 16: return (int)ffc::spec::launch<3>(kp, op, tw, channels, k_len, st);
    case 32: return (int)ffc::spec::launch<4>(kp, op, tw, channels, k_len, st);
    case 64: return (int)ffc::spec::launch<5>(kp, op, tw, channels, k_len, st);
    case 128: return (int)ffc::spec::launch<6>(kp, op, tw, channels, k_len, st);
    case 256: return (int)ffc::spec::launch<7>(kp, op, tw, channels, k_len, st);
    case 512: return (int)ffc::spec::launch<8>(kp, op, tw, channels, k_len, st);
    case 1024: return (int)ffc::spec::launch<9>(kp, op, tw, channels, k_len, st);
    case 2048: return (int)ffc::spec::launch<10>(kp, op, tw, channels, k_len, st);
    case 4096: return (int)ffc::spec::launch<11>(kp, op, tw, channels, k_len, st);
    case 8192: return (int)ffc::spec::launch<12>(kp, op, tw, channels, k_len, st);
    case 16384: return (int)ffc::spec::launch<13>(kp, op, tw, channels, k_len, st);
    case 32768: return (int)ffc::spec::launch<14>(kp, op, tw, channels, k_len, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

FFC_EXPORT_ERROR_STRING()
