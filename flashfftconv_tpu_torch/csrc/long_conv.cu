// long_conv: the band stage of the FFT convolution for N >= 65536, complex
// in and complex out.
//
// Replaces the TPU kernel _long_tiles (flashfftconv_tpu/ops/
// monarch_pallas.py, def at l.1928, pallas_call at l.2003, body _long_kernel
// at l.1683) in its complex_io contract: the inner transforms, the product
// with the kernel spectrum and the way back, between the two butterfly
// passes (butterfly.cu). The TPU kernel keeps a whole (f0, n1, n2) row, up to
// 2M points, in VMEM; an H100 block has 227 KB, so here a conv of this size
// is the chain butterfly -> long_conv -> inverse butterfly over complex64
// bands in device memory, and the real-I/O contract of _long_tiles is that
// chain (ops/monarch_cuda.long_conv).
//
// Design. The TPU kernel avoids the real-FFT split step by packing two batch
// rows as real and imaginary parts, or by half bands when B is odd. Here the
// row is packed even/odd as everywhere in the port (any B, B = 1 included,
// does no wasted work and k_f stays the natural-order half spectrum), and
// the split's partner M - k of a frequency in band k0 lies in band F - k0.
// The kernel runs on the band unit of long_band.cuh (one instance per band
// R = 128 ... 8192; the C entry dispatches on R): one block a band pair
// {c, F - c} of one (b, h) row, two units of T = R / P threads, one R-point
// row each in XOR-swizzled shared memory (64 KB and 256 threads at
// R = 4096, compiled for two blocks an SM: 128 registers). At R = 8192 one
// unit of 256 threads takes both bands in turn (128 KB, one block an SM, up
// to 255 registers): two units of 256 threads, 128 registers a thread,
// spilled 8 to 120 bytes in every variant tried (PERF.md). Each unit
//   - runs the forward FFT of its band straight from device memory;
//   - after a barrier, for each of its frequency pairs (k, M - k), splits
//     the pair, multiplies X[k] by k_f[k] and X[M - k] by k_f[M - k],
//     unsplits and writes the conjugates back (the split twiddle from the
//     unit's split_tw[k0] and the row FFT's root table);
//   - after a second barrier, runs the inverse FFT and stores its band
//     scaled by 1/R (the inverse butterfly applies 1/F).
// in and out may be the same buffer: a unit reads and writes only its own
// band. Blocks are channel-major (row h B + b), so the B rows of a channel
// read k_f[h] from L2 after the first, and the pairs of a row are
// neighbours in the grid, so the reads of k_f at stride F by neighbouring
// bands share their 32-byte sectors in L2. Every output has one writer: two
// calls give the same bits.
//
// Bound on the H100 at B=1, H=256, N=2^21 (M=2^20): as a function it reads
// 2.1 GB of bands and 2.1 GB of k_f and writes 2.1 GB, 1.9 ms at 3.35 TB/s,
// against 2 R-point FFTs a band in f32 (about 45 GFLOP, 0.7 ms at
// 67 TFLOP/s): bytes.

#include "long_band.cuh"

namespace ffc {
namespace lconv {

using namespace lband;

// Units a block: two, or at R = 8192 one that takes both bands in turn.
template <int LOG_R>
constexpr int kUnits = LOG_R < kMaxLogBand ? 2 : 1;
template <int LOG_R>
constexpr int kConvThreads = kUnits<LOG_R> * CfgB<LOG_R>::kT;
template <int LOG_R>
constexpr int kConvMinBlocks = kUnits<LOG_R> == 2 ? PairBlock<LOG_R>::kMinBlocks : 1;

// The three phases of long_conv_kernel for band `side` (0 or 1) of the
// block's pair, thread tr of its unit.
template <class C>
__device__ __forceinline__ void conv_forward(const float2* z, float2* smem, const float2* tab,
                                             int side, int tr, int batch, int channels,
                                             int outer) {
  band_forward<C>(z + unit_offset<C>(side, batch, channels, outer), smem + side * C::kM, tab, tr);
}

template <class C>
__device__ __forceinline__ void conv_pairs(float2* smem, const float2* tab,
                                           const float2* __restrict__ k_f,
                                           const float2* __restrict__ split_tw, int side, int tr,
                                           int batch, int outer) {
  constexpr int kR = C::kM, kT = C::kT;
  const int c = blockIdx.x % (outer / 2);
  const int h = blockIdx.x / (outer / 2) / batch;
  const int k0 = unit_band(c, side, outer);
  const int m = outer * kR;
  float2* s = smem + side * kR;
  float2* ps = c == 0 ? s : smem + (side ^ 1) * kR;
  const float2* kh = k_f + (size_t)h * (m + 1);
  const float2 w0 = split_tw[k0];
  const int n = pass_slots(k0, kR);
  for (int j = tr; j < n; j += kT) {
    const int k = k0 + outer * j;
    const bool first = k0 == 0 && j == 0;
    const float2 w = cmul(w0, root<C>(tab, j));
    float2* pk = s + swz(j);
    float2* pm = ps + swz(partner_slot(k0, j, kR));
    float2 xk, xm, zk, zm;
    split_pair(*pk, *pm, w, xk, xm);
    unsplit_pair(cmul(xk, __ldg(kh + k)), cmul(xm, __ldg(kh + m - k)), w, zk, zm);
    *pk = make_float2(zk.x, -zk.y);
    if (!first) *pm = make_float2(zm.x, -zm.y);
  }
}

template <class C>
__device__ __forceinline__ void conv_inverse(float2* out, float2* smem, const float2* tab,
                                             int side, int tr, int batch, int channels,
                                             int outer) {
  band_inverse_store<C>(smem + side * C::kM,
                        out + unit_offset<C>(side, batch, channels, outer), tab, tr);
}

template <int LOG_R>
__global__ void __launch_bounds__(kConvThreads<LOG_R>, kConvMinBlocks<LOG_R>)
    long_conv_kernel(const float2* z, float2* out, const float2* __restrict__ k_f,
                     const float2* __restrict__ split_tw, const float2* __restrict__ band_tw,
                     int batch, int channels, int outer) {
  using C = CfgB<LOG_R>;
  constexpr int kT = C::kT;
  extern __shared__ float4 smem_raw[];
  float2* smem = reinterpret_cast<float2*>(smem_raw);
  float2* tab = smem + 2 * C::kM;
  load_band_table<C>(tab, band_tw);
  __syncthreads();
  // A unit's side and thread come from a fresh read of threadIdx.x in each
  // phase, not kept through the FFTs (row_fft.cuh's fresh_tid).
  if constexpr (kUnits<LOG_R> == 2) {
    conv_forward<C>(z, smem, tab, threadIdx.x / kT, threadIdx.x % kT, batch, channels, outer);
    __syncthreads();
    const int tid = fresh_tid();
    conv_pairs<C>(smem, tab, k_f, split_tw, tid / kT, tid % kT, batch, outer);
    __syncthreads();
    const int t2 = fresh_tid();
    conv_inverse<C>(out, smem, tab, t2 / kT, t2 % kT, batch, channels, outer);
  } else {
#pragma unroll 1
    for (int side = 0; side < 2; ++side)
      conv_forward<C>(z, smem, tab, side, threadIdx.x, batch, channels, outer);
    __syncthreads();
#pragma unroll 1
    for (int side = 0; side < 2; ++side)
      conv_pairs<C>(smem, tab, k_f, split_tw, side, fresh_tid(), batch, outer);
    __syncthreads();
#pragma unroll 1
    for (int side = 0; side < 2; ++side)
      conv_inverse<C>(out, smem, tab, side, fresh_tid(), batch, channels, outer);
  }
}

template <int LOG_R>
cudaError_t launch(const void* z, void* out, const void* k_f, const void* split_tw,
                   const void* band_tw, int batch, int channels, int outer,
                   cudaStream_t stream) {
  using PB = PairBlock<LOG_R>;
  auto kernel = long_conv_kernel<LOG_R>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PB::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((long long)batch * channels * (outer / 2)), kConvThreads<LOG_R>, PB::kSmem,
           stream>>>((const float2*)z, (float2*)out, (const float2*)k_f, (const float2*)split_tw,
                     (const float2*)band_tw, batch, channels, outer);
  return cudaGetLastError();
}

}  // namespace lconv
}  // namespace ffc

// z and out: (batch, channels, outer, band) complex64 on 16-byte boundaries,
// possibly the same buffer; k_f: (channels, outer * band + 1) complex64.
// split_tw is the plan's (exp(-2 pi i m / N), m = 0 .. M), band_tw the band
// plan's (exp(-2 pi i j / 2R), j = 0 .. R).
extern "C" int ffc_long_conv(const void* z, void* out, const void* k_f, const void* split_tw,
                             const void* band_tw, int batch, int channels, int outer, int band,
                             void* stream) {
  if (batch < 1 || channels < 1 ||
      !ffc::lband::bands_ok((long long)batch * channels, outer, band) ||
      !ffc::lband::aligned16(z) || !ffc::lband::aligned16(out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FFC_CONV_CASE(LOG_R)                                                                   \
  case 1 << LOG_R:                                                                             \
    return (int)ffc::lconv::launch<LOG_R>(z, out, k_f, split_tw, band_tw, batch, channels,     \
                                          outer, st);
  switch (band) {
    FFC_CONV_CASE(7)
    FFC_CONV_CASE(8)
    FFC_CONV_CASE(9)
    FFC_CONV_CASE(10)
    FFC_CONV_CASE(11)
    FFC_CONV_CASE(12)
    FFC_CONV_CASE(13)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFC_CONV_CASE
}

FFC_EXPORT_ERROR_STRING()
