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
// the split's partner M - k of a frequency in band k0 lies in band F - k0
// (long_common.cuh): one block owns the band pair {kp, F - kp} of one (b, h)
// row in two shared-memory rows (2 x 33 KB at R = 4096; compiled for two
// blocks an SM, 128 registers).
// It loads both bands, runs their R-point FFTs stage by stage, splits each
// frequency pair, multiplies by k_f, unsplits, runs the inverse FFTs and
// writes both bands back scaled by 1/R (the inverse butterfly applies 1/F).
// in and out may be the same buffer: a block reads and writes only its own
// bands. Blocks of one row are neighbours in the grid, so the strided reads
// of k_f (stride F) by neighbouring bands share their sectors in L2.
//
// Bound on the H100 at B=1, H=256, N=2^21 (M=2^20): as a function it reads
// 2.1 GB of bands and 2.1 GB of k_f and writes 2.1 GB, 1.9 ms at 3.35 TB/s,
// against 2 R-point FFTs a band in f32 (about 45 GFLOP, 0.7 ms at
// 67 TFLOP/s): bytes. Measured there: 1.9 ms for the loads and stores alone,
// about 4 ms more for the frequency-pair pass (its loads of k_f and the
// split twiddle are F points apart, one 32-byte sector a value).

#include "long_common.cuh"

namespace ffc {

__global__ void __launch_bounds__(kThreads, kBandMinBlocks)
    long_conv_kernel(const float2* z, float2* out, const float2* __restrict__ k_f,
                     const float2* __restrict__ tw, const float2* __restrict__ split_tw,
                     const float2* __restrict__ roots_g, int batch, int channels, int outer,
                     Plan p) {
  extern __shared__ float2 s[];
  __shared__ float2 roots[kMaxFactor];
  const int band = p.m;
  const int m = outer * band;
  const int pairs = outer / 2 + 1;
  const int kp = blockIdx.x % pairs;
  const int bh = blockIdx.x / pairs;
  const int h = bh / batch;
  const int b = bh - h * batch;
  const size_t row = ((size_t)b * channels + h) * (size_t)m;
  const bool two = kp != 0 && 2 * kp != outer;
  float2* sa = s;
  float2* sb = s + band_slots(band);
  k_f += (size_t)h * (m + 1);
  load_roots(roots, roots_g);
  load_band(sa, z + row + (size_t)kp * band, band);
  if (two) load_band(sb, z + row + (size_t)(outer - kp) * band, band);
  __syncthreads();
  band_fft<false>(sa, sb, two, p, tw, roots);

  for_each_pair(kp, outer, sa, sb, p, [&](int k, float2* pk, float2* pm, bool first) {
    const float2 w = __ldg(split_tw + k);
    float2 xk, xm, zk, zm;
    split_pair(*pk, *pm, w, xk, xm);
    unsplit_pair(cmul(xk, __ldg(k_f + k)), cmul(xm, __ldg(k_f + m - k)), w, zk, zm);
    *pk = zk;
    if (!first) *pm = zm;
  });
  __syncthreads();
  band_fft<true>(sa, sb, two, p, tw, roots);

  const float scale = 1.f / (float)band;
  float2* oa = out + row + (size_t)kp * band;
  float2* ob = out + row + (size_t)(outer - kp) * band;
  for (int n = threadIdx.x; n < band; n += blockDim.x) {
    const float2 a = sa[slot(n)];
    oa[n] = make_float2(a.x * scale, a.y * scale);
    if (two) {
      const float2 c = sb[slot(n)];
      ob[n] = make_float2(c.x * scale, c.y * scale);
    }
  }
}

}  // namespace ffc

// z and out: (batch, channels, outer, band) complex64, possibly the same
// buffer; k_f: (channels, outer * band + 1) complex64. The factors are the
// band's.
extern "C" int ffc_long_conv(const void* z, void* out, const void* k_f, const void* tw,
                             const void* split_tw, const void* roots, int batch, int channels,
                             int outer, int n_stages, int f0, int f1, int f2, int f3,
                             void* stream) {
  const int factors[4] = {f0, f1, f2, f3};
  ffc::Plan p;
  if (!ffc::make_plan(n_stages, factors, &p) || p.m > ffc::kMaxBand || batch < 1 ||
      channels < 1 || outer < 2 || (outer & (outer - 1)) ||
      (long long)outer * p.m > (1LL << 21) ||
      (long long)batch * channels * (outer / 2 + 1) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ffc::band_pair_smem_bytes(p.m);
  cudaError_t err = cudaFuncSetAttribute(ffc::long_conv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((long long)batch * channels * (outer / 2 + 1));
  ffc::long_conv_kernel<<<blocks, ffc::kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)z, (float2*)out, (const float2*)k_f, (const float2*)tw,
      (const float2*)split_tw, (const float2*)roots, batch, channels, outer, p);
  return (int)cudaGetLastError();
}

FFC_EXPORT_ERROR_STRING()
