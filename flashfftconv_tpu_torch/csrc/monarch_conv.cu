// monarch_conv: fused causal FFT convolution, (B, H, L) in, (B, H, L) out.
//
// Replaces the TPU kernel _conv_fused_io_tiles (flashfftconv_tpu/ops/
// monarch_pallas.py, def at l.340, pallas_call at l.459) and the 2-factor
// branch of _conv_raw that dispatches it: one device-memory round trip that
// reads u (and the optional pregate), zero-pads to N, runs the forward FFT,
// multiplies by the kernel spectrum, runs the inverse FFT, truncates to L,
// applies the optional postgate and writes the output at u's dtype.
//
// Bound on the H100: at B=4, H=768, L=8192, N=16384 (bf16, ungated) the
// kernel must move 50 MB of u, 50 MB of output and 50 MB of f32 spectrum,
// about 45 us at 3.35 TB/s, and do two 8192-point complex FFTs a row in f32
// (about 5 M log2 M operations each, plus the stage and split twiddles):
// about 4.3 GFLOP, about 64 us at 67 TFLOP/s. So the f32 pipes bound it.
//
// Design. Each (b, h) row is packed, its even and odd samples, as one
// M = N/2 point complex signal (the TPU kernel packs two batch rows
// instead; here any B works). One instantiation per FFT size,
// dtype and gating (monarch_conv_kernel<LOG_M, T, GATED>, N = 16 ... 32768;
// the C entry dispatches on N) of the in-register row FFT of row_fft.cuh:
// T = M/P threads a row, P points each, every index a compile-time constant
// (ptxas: no stack frame, no spills), XOR-swizzled shared memory, stage and
// split twiddles from a table of coarse and fine roots. The row's M points
// take 8M bytes of shared memory: 64 KB at N = 16384, 128 KB at 32768.
//   - Forward, stage 0: each thread loads E packed points (16 bytes: 4 f32
//     or 8 bf16 samples, E = 2 or 4) a step straight from device memory, u
//     and the pregate, into E lines of P/E points; scalar loads only at a
//     ragged end or on a row off a 16-byte boundary; samples past L are
//     zeros that are never loaded. The pregate product is rounded to T, as
//     u * pregate is in the JAX package and in the plain version.
//   - The later stages as in spectrum.cu; the last writes Z in natural
//     frequency order.
//   - The pointwise pass, between the last forward stage and the first
//     inverse stage: each thread takes frequency pairs (f, M - f), f = tr +
//     T q, from the natural-order Z in shared memory into registers: split
//     (fft_common.cuh split_pair), the product with the kernel's half
//     spectrum k_f (H, M+1) from spectrum.cu, unsplit, the conjugate, and
//     back to the same two slots. The inverse FFT is the same forward
//     transform of the conjugate, conjugated at the store. (Fusing the pass
//     into the inverse stage 0, whose thread then owns lines r and R0 - r,
//     ran 1-4% faster on an H100 but left 24-128 bytes of stack in six
//     instances at 128 registers; PERF.md.)
//   - The last inverse stage writes natural order; the store reads E points
//     a thread and writes them as one 16-byte store, times the postgate (a
//     16-byte load), scaled by 1/M, truncated at L.
// Registers: P = 32 points a thread take 64 of the 128 that 256 threads (two
// blocks an SM) may have; every instance has 0 bytes of stack. The row's
// offset and the inverse's index math are recomputed from a second read of
// threadIdx.x (fresh_tid) rather than kept through the FFTs, and the inverse
// stage 0 takes its lines in another thread order than the store reads its
// points (thread tr the lines of tr ^ 1), so that no slot address lives from
// one to the other. N = 8192 (128 threads) is compiled for three blocks an
// SM (170 registers) instead of four.
// Blocks run channel-major, so the B rows of one channel run together and
// share its spectrum in L2. Every output has one writer: two calls give the
// same bits.
//
// C entry: ffc_monarch_conv(u, pre, post, k_f, out, split_tw, batch,
// channels, length, n, dtype, stream), n the FFT size; the plan's
// split_tw (exp(-2 pi i m / N), m = 0 .. M) is its only table, the plan's
// factors and stage twiddles do not enter.

#include "row_fft.cuh"

namespace ffc {
namespace mconv {

using namespace row;

// The pointwise pass of one frequency pair, f and M - f, from the forward
// FFT's natural-order output in s: split into X[f], X[M - f], times k_f,
// unsplit, conjugated for the inverse transform, into za (for f) and zb
// (for M - f). f = 0 pairs with Z[M] = Z[0] and k_f[M].
template <class C>
__device__ __forceinline__ void pointwise(float2& za, float2& zb, int f, const float2* s,
                                          const float2* __restrict__ kf, const float2* tab) {
  const float2 ka = __ldg(kf + f), kb = __ldg(kf + C::kM - f);
  const float2 w = root<C>(tab, f);
  float2 xa, xb, ya, yb;
  split_pair(s[swz(f)], s[swz((C::kM - f) & (C::kM - 1))], w, xa, xb);
  unsplit_pair(cmul(xa, ka), cmul(xb, kb), w, ya, yb);
  za = make_float2(ya.x, -ya.y);
  zb = make_float2(yb.x, -yb.y);
}

// A frequency that is its own partner (f = 0 or M/2).
template <class C>
__device__ __forceinline__ void pointwise_self(float2& z, int f, const float2* s,
                                               const float2* __restrict__ kf, const float2* tab) {
  float2 unused;
  pointwise<C>(z, unused, f, s, kf, tab);
}

template <int LOG_M, typename T, bool GATED>
__global__ void __launch_bounds__(CfgT<LOG_M, T>::kThreads, min_blocks<LOG_M, T>())
    monarch_conv_kernel(const T* __restrict__ u, const T* __restrict__ pre,
                        const T* __restrict__ post, const float2* __restrict__ k_f,
                        T* __restrict__ out, const float2* __restrict__ split_tw, int batch,
                        int channels, int length) {
  using C = CfgT<LOG_M, T>;
  constexpr int kM = C::kM, kT = C::kT, kP = C::kP, kE = C::kE, kF0 = C::kF0, kR0 = C::kR0;
  extern __shared__ float4 smem_raw[];
  float2* smem = reinterpret_cast<float2*>(smem_raw);
  int tr = threadIdx.x % kT;
  float2* s = smem + (threadIdx.x / kT) * kM;
  float2* tab = smem + C::kRows * kM;
  size_t off;
  int h;

  // Forward stage 0's lines r = E tr + e, e < E: v[e * F0 + j] = z[j * R0 + r],
  // the packed points of samples 2E (j T + tr) .. + 2E - 1. One alignment
  // flag for every operand: the rows of u, the gates and out share off.
  float2 v[kP];
  {
    const bool active = row_offset<C>(threadIdx.x, batch, channels, length, off, h);
    const bool aligned = GATED ? aligned16(u + off, pre + off, post + off, out + off)
                               : aligned16(u + off, u + off, out + off, out + off);
#pragma unroll
    for (int j = 0; j < kF0; ++j) {
      const int i = 2 * kE * (j * kT + tr);
      float x[2 * kE];
#pragma unroll
      for (int c = 0; c < 2 * kE; ++c) x[c] = 0.f;
      if (active && i < length)
        load_vec<T, GATED>(x, u + off, GATED ? pre + off : nullptr, i, length, aligned);
#pragma unroll
      for (int e = 0; e < kE; ++e) v[e * kF0 + j] = make_float2(x[2 * e], x[2 * e + 1]);
    }
  }
  load_table<C>(tab, split_tw);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kE; ++e) first_stage_line<C>(v + e * kF0, s, tab, kE * tr + e);
  mid_stages<C>(v, s, tab, tr);
  last_stage<C>(v, s, tr);
  __syncthreads();

  // The pointwise pass: pairs (f, M - f), f = tr + T q < M/2, and M/2 alone.
  {
    row_offset<C>(fresh_tid(), batch, channels, length, off, h);
    const float2* kf = k_f + (size_t)h * (kM + 1);
#pragma unroll
    for (int q = 0; q < kP / 2; ++q) {
      const int f = tr + kT * q;
      float2 za, zb;
      pointwise<C>(za, zb, f, s, kf, tab);
      s[swz(f)] = za;
      if (f != 0) s[swz(kM - f)] = zb;
    }
    if (tr == 0) {
      float2 z;
      pointwise_self<C>(z, kM / 2, s, kf, tab);
      s[swz(kM / 2)] = z;
    }
  }
  __syncthreads();
  // The inverse FFT of the conjugate; its stage 0 on the lines of thread
  // tr ^ 1 (see the registers note above).
  tr = fresh_tid() % kT;
  s = smem + (fresh_tid() / kT) * kM;
  {
    const int t0 = tr ^ (kT > 1 ? 1 : 0);
#pragma unroll
    for (int e = 0; e < kE; ++e)
#pragma unroll
      for (int j = 0; j < kF0; ++j) v[e * kF0 + j] = s[swz(j * kR0 + kE * t0 + e)];
#pragma unroll
    for (int e = 0; e < kE; ++e) first_stage_line<C>(v + e * kF0, s, tab, kE * t0 + e);
  }
  mid_stages<C>(v, s, tab, tr);
  last_stage<C>(v, s, tr);
  __syncthreads();
  if (!row_offset<C>(fresh_tid(), batch, channels, length, off, h)) return;
  const bool aligned = GATED ? aligned16(u + off, pre + off, post + off, out + off)
                             : aligned16(u + off, u + off, out + off, out + off);

  // y[2n] + i y[2n+1] = conj(s[n]) / M; E points (16 bytes of T) a store.
  const float scale = 1.f / (float)kM;
#pragma unroll
  for (int q = 0; q < kP / kE; ++q) {
    const int n0 = kE * (tr + kT * q), i = 2 * n0;
    if (i >= length) continue;
    float y[2 * kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const float2 z = s[swz(n0 + e)];
      y[2 * e] = z.x * scale;
      y[2 * e + 1] = -z.y * scale;
    }
    store_vec<T, GATED>(out + off, GATED ? post + off : nullptr, i, length, aligned, y);
  }
}

template <int LOG_M, typename T, bool GATED>
cudaError_t launch_one(const void* u, const void* pre, const void* post, const void* k_f,
                       void* out, const void* split_tw, int batch, int channels, int length,
                       cudaStream_t stream) {
  using C = CfgT<LOG_M, T>;
  auto kernel = monarch_conv_kernel<LOG_M, T, GATED>;
  if constexpr (C::kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (int)(((long long)batch * channels + C::kRows - 1) / C::kRows);
  kernel<<<blocks, C::kThreads, C::kSmem, stream>>>(
      (const T*)u, (const T*)pre, (const T*)post, (const float2*)k_f, (T*)out,
      (const float2*)split_tw, batch, channels, length);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.
template <int LOG_M>
cudaError_t launch(const void* u, const void* pre, const void* post, const void* k_f, void* out,
                   const void* split_tw, int batch, int channels, int length, int dtype,
                   cudaStream_t st) {
  const bool gated = pre != nullptr;
  if (dtype == 0)
    return gated ? launch_one<LOG_M, float, true>(u, pre, post, k_f, out, split_tw, batch,
                                                  channels, length, st)
                 : launch_one<LOG_M, float, false>(u, pre, post, k_f, out, split_tw, batch,
                                                   channels, length, st);
  if (dtype == 1)
    return gated ? launch_one<LOG_M, __nv_bfloat16, true>(u, pre, post, k_f, out, split_tw,
                                                          batch, channels, length, st)
                 : launch_one<LOG_M, __nv_bfloat16, false>(u, pre, post, k_f, out, split_tw,
                                                           batch, channels, length, st);
  return cudaErrorInvalidValue;
}

}  // namespace mconv
}  // namespace ffc

// n: the FFT size (16 ... 32768, a power of two); dtype: 0 = float32,
// 1 = bfloat16. pre and post are both null (ungated) or both set (gated).
extern "C" int ffc_monarch_conv(const void* u, const void* pre, const void* post,
                                const void* k_f, void* out, const void* split_tw, int batch,
                                int channels, int length, int n, int dtype, void* stream) {
  if (batch < 1 || channels < 1 || length < 1 || length > n ||
      (long long)batch * channels > 0x7fffffffLL || (pre == nullptr) != (post == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FFC_MCONV_CASE(LOG_M)                                                                \
  case 2 << LOG_M:                                                                           \
    return (int)ffc::mconv::launch<LOG_M>(u, pre, post, k_f, out, split_tw, batch, channels, \
                                          length, dtype, st);
  switch (n) {
    FFC_MCONV_CASE(3)
    FFC_MCONV_CASE(4)
    FFC_MCONV_CASE(5)
    FFC_MCONV_CASE(6)
    FFC_MCONV_CASE(7)
    FFC_MCONV_CASE(8)
    FFC_MCONV_CASE(9)
    FFC_MCONV_CASE(10)
    FFC_MCONV_CASE(11)
    FFC_MCONV_CASE(12)
    FFC_MCONV_CASE(13)
    FFC_MCONV_CASE(14)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFC_MCONV_CASE
}

FFC_EXPORT_ERROR_STRING()
