// band_conv: the complex band conv of the sequence-parallel FFT conv,
// complex in and complex out.
//
// Replaces the TPU kernel _conv_tiles (flashfftconv_tpu/ops/
// monarch_pallas.py, def at l.1059, pallas_call at l.1135, body _conv_kernel
// at l.172) in its complex contract (u4_im given, complex_out=True), which
// flashfftconv_tpu/parallel/seq_conv.py runs on every device's band
// (l.140-152) and again with conj(k_f) in its backward (l.190-194). Its
// real-I/O contract is the function monarch_conv (monarch_conv.cu) computes.
//
// Function: for complex64 bands b (B, H, N2) and a full complex64 spectrum
// K (H, N2) in natural frequency order,
//   y = ifft_N2(fft_N2(b) * K)        (conj(K) with conj; 1/N2 in the inverse).
// A band of the distributed FFT is a general complex signal and K is not
// Hermitian, so there is no real-FFT split here: the whole N2-point complex
// FFT runs, both ways.
//
// Bound on the H100 at B=4, H=768, N2=16384: it reads 403 MB of bands and
// 101 MB of K and writes 403 MB, 0.27 ms at 3.35 TB/s, against two N2-point
// complex FFTs and the product a row (about 8.6 GFLOP, 0.13 ms at the f32
// 67 TFLOP/s): bytes.
//
// Design on the H100. One instantiation per band length (band_conv_kernel
// <LOG_M>, M = N2 = 16 ... 16384; the C entry dispatches on N2) of the
// in-register row FFT of row_fft.cuh: T = M/P threads a row, P points each,
// every index a compile-time constant, up to M = 1024 several rows a
// 128-thread block, a row's M points in XOR-swizzled shared memory (128 KB
// at 16384, one block an SM).
//   - Stage 0 loads two complex points (16 bytes) a thread a step straight
//     from device memory: a band point is already a complex point, so there
//     is no packing and no split. The later stages and the last one, which
//     writes natural frequency order, are row_fft.cuh's.
//   - The pointwise pass: each thread takes two neighbouring frequencies a
//     step, K's two points with one 16-byte load (coalesced), the product
//     (conj(K) with conj), and writes the conjugate back for the inverse.
//   - The inverse is the forward transform of the conjugate (stage 0's
//     lines from shared memory, on the lines of thread tr ^ 1 as in
//     monarch_conv.cu), conjugated and scaled by 1/N2 at the store, two
//     points (16 bytes) a store.
//   - The root table is the split_tw of the plan of FFT size 2 N2:
//     exp(-2 pi i m / (2 N2)), m = 0 .. N2; its even entries are the band
//     FFT's N2-th roots.
//   - Blocks run channel-major (row h B + b of the block order), so the B
//     rows of one channel run together and K[h] comes from L2 after its first
//     read; the store goes to the natural (B, H, N2) layout.
//   - The row's offset and the inverse's index math come from a second read
//     of threadIdx.x (fresh_tid), not kept through the FFTs, as in
//     monarch_conv.cu (kept, such values spill at P = 32 points a thread).
//     ptxas: no stack frame, no spills.
// Every output has one writer: two calls give the same bits. N2 = 32768
// (256 KB) does not fit one block; the sequence-parallel conv takes bands
// from 32768 up through four real circular convs (parallel/seq_conv.py).

#include "row_fft.cuh"

namespace ffc {
namespace band {

using namespace row;

// Two complex64 points (16 bytes) a load and a store: stage 0's E = 2.
template <int LOG_M>
using CfgB = Cfg<LOG_M, 1>;

template <int LOG_M>
__global__ void __launch_bounds__(CfgB<LOG_M>::kThreads, (min_blocks<LOG_M, float>()))
    band_conv_kernel(const float2* __restrict__ b, const float2* __restrict__ k_f,
                     float2* __restrict__ out, const float2* __restrict__ split_tw, int batch,
                     int channels, int conj) {
  using C = CfgB<LOG_M>;
  constexpr int kM = C::kM, kT = C::kT, kP = C::kP, kE = C::kE, kF0 = C::kF0, kR0 = C::kR0;
  static_assert(kE == 2, "stage 0 takes two complex points a load");
  extern __shared__ float4 smem_raw[];
  float2* smem = reinterpret_cast<float2*>(smem_raw);
  float2* tab = smem + C::kRows * kM;
  int tr = threadIdx.x % kT;
  float2* s = smem + (threadIdx.x / kT) * kM;
  size_t off;
  int h;

  // Forward stage 0's lines r = 2 tr + e: v[e * F0 + j] = b[j * R0 + r].
  float2 v[kP];
  {
    const bool active = row_offset<C>(threadIdx.x, batch, channels, kM, off, h);
#pragma unroll
    for (int j = 0; j < kF0; ++j) {
      const float4 a = active ? __ldg(reinterpret_cast<const float4*>(b + off) + j * kT + tr)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      v[j] = make_float2(a.x, a.y);
      v[kF0 + j] = make_float2(a.z, a.w);
    }
  }
  load_table<C>(tab, split_tw);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kE; ++e) first_stage_line<C>(v + e * kF0, s, tab, kE * tr + e);
  mid_stages<C>(v, s, tab, tr);
  last_stage<C>(v, s, tr);
  __syncthreads();

  // The pointwise pass: frequencies 2 (tr + T q) and the next, times K (or
  // conj K), conjugated for the inverse transform.
  {
    const int tid = fresh_tid();
    tr = tid % kT;
    s = smem + (tid / kT) * kM;
    row_offset<C>(tid, batch, channels, kM, off, h);
    const float4* kh = reinterpret_cast<const float4*>(k_f + (size_t)h * kM);
    const float sign = conj ? -1.f : 1.f;
#pragma unroll 4
    for (int q = 0; q < kP / kE; ++q) {
      const int f = kE * (tr + kT * q);
      const float4 k = __ldg(kh + tr + kT * q);
      const float2 za = cmul(s[swz(f)], make_float2(k.x, sign * k.y));
      const float2 zb = cmul(s[swz(f + 1)], make_float2(k.z, sign * k.w));
      s[swz(f)] = make_float2(za.x, -za.y);
      s[swz(f + 1)] = make_float2(zb.x, -zb.y);
    }
  }
  __syncthreads();

  // The inverse FFT of the conjugate; its stage 0 on the lines of thread
  // tr ^ 1, so that no slot address lives from it to the store.
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

  // y[n] = conj(s[n]) / M, two points (16 bytes) a store.
  const int tid = fresh_tid();
  tr = tid % kT;
  s = smem + (tid / kT) * kM;
  if (!row_offset<C>(tid, batch, channels, kM, off, h)) return;
  const float scale = 1.f / (float)kM;
  float4* o = reinterpret_cast<float4*>(out + off);
#pragma unroll
  for (int q = 0; q < kP / kE; ++q) {
    const int n0 = kE * (tr + kT * q);
    const float2 a = s[swz(n0)], c = s[swz(n0 + 1)];
    o[tr + kT * q] = make_float4(a.x * scale, -a.y * scale, c.x * scale, -c.y * scale);
  }
}

template <int LOG_M>
cudaError_t launch(const void* b, const void* k_f, void* out, const void* split_tw, int batch,
                   int channels, int conj, cudaStream_t stream) {
  using C = CfgB<LOG_M>;
  auto kernel = band_conv_kernel<LOG_M>;
  if constexpr (C::kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (int)(((long long)batch * channels + C::kRows - 1) / C::kRows);
  kernel<<<blocks, C::kThreads, C::kSmem, stream>>>((const float2*)b, (const float2*)k_f,
                                                    (float2*)out, (const float2*)split_tw,
                                                    batch, channels, conj);
  return cudaGetLastError();
}

}  // namespace band
}  // namespace ffc

// b and out: (batch, channels, n2) complex64, distinct buffers on 16-byte
// boundaries; k_f: (channels, n2) complex64 on a 16-byte boundary, row
// b * channels + h taking channel h; split_tw: the split_tw of the plan of
// FFT size 2 n2 (exp(-2 pi i m / (2 n2)), m = 0 .. n2); n2 a power of two
// from 16 to 16384; conj != 0 multiplies by conj(k_f).
extern "C" int ffc_band_conv(const void* b, const void* k_f, void* out, const void* split_tw,
                             int batch, int channels, int n2, int conj, void* stream) {
  if (batch < 1 || channels < 1 || (long long)batch * channels > 0x7fffffffLL ||
      ((reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(k_f) |
        reinterpret_cast<uintptr_t>(out)) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FFC_BAND_CASE(LOG_M) \
  case 1 << LOG_M:           \
    return (int)ffc::band::launch<LOG_M>(b, k_f, out, split_tw, batch, channels, conj, st);
  switch (n2) {
    FFC_BAND_CASE(4)
    FFC_BAND_CASE(5)
    FFC_BAND_CASE(6)
    FFC_BAND_CASE(7)
    FFC_BAND_CASE(8)
    FFC_BAND_CASE(9)
    FFC_BAND_CASE(10)
    FFC_BAND_CASE(11)
    FFC_BAND_CASE(12)
    FFC_BAND_CASE(13)
    FFC_BAND_CASE(14)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFC_BAND_CASE
}

FFC_EXPORT_ERROR_STRING()
