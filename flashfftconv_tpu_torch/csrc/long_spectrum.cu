// long_spectrum: half spectrum of the long-conv kernel taps for N >= 65536.
//
// Replaces the TPU kernel _fwd_dft_tiles (flashfftconv_tpu/ops/
// monarch_pallas.py, def at l.616, pallas_call at l.720), the fused 3-stage
// forward Monarch DFT that _forward_long_dft and _kernel_spectrum reach for
// k at these sizes, which returns a planar spectrum in Monarch layout (all N
// frequencies, or half bands). Here the result is the natural-order half
// spectrum (H, M+1) of complex f32, the format spectrum.cu gives up to
// N = 32768, so k_f means one thing at every size.
//
// Design. The first stage is the forward butterfly (butterfly.cu) on the
// real f32 taps, zero-padded in the kernel, which leaves F bands of R points
// a channel in device memory. This kernel is the rest: one block owns the
// band pair {kp, F - kp} of one channel (long_common.cuh), runs the R-point
// FFTs of both in shared memory, splits each frequency pair (k, M - k) into
// the half spectrum of the real taps and stores X[k] and X[M - k]. The
// stores of one block are F points apart; blocks of neighbouring bands run
// together and fill each other's sectors in L2.
//
// Bound on the H100 at H=256, k_len=2^20, N=2^21: as a function it reads
// 1.07 GB of taps and writes 2.1 GB of spectrum, 0.96 ms at 3.35 TB/s,
// against one M-point FFT a channel in f32 (about 28 GFLOP, 0.4 ms): bytes.
// The bands between the two kernels (2.1 GB written and read) are this
// design's own traffic.

#include "long_common.cuh"

namespace ffc {

__global__ void __launch_bounds__(kThreads, kBandMinBlocks)
    long_spectrum_kernel(const float2* __restrict__ z, float2* __restrict__ out,
                         const float2* __restrict__ tw, const float2* __restrict__ split_tw,
                         const float2* __restrict__ roots_g, int outer, Plan p) {
  extern __shared__ float2 s[];
  __shared__ float2 roots[kMaxFactor];
  const int band = p.m;
  const int m = outer * band;
  const int pairs = outer / 2 + 1;
  const int kp = blockIdx.x % pairs;
  const size_t h = blockIdx.x / pairs;
  const bool two = kp != 0 && 2 * kp != outer;
  float2* sa = s;
  float2* sb = s + band_slots(band);
  z += h * (size_t)m;
  out += h * (size_t)(m + 1);
  load_roots(roots, roots_g);
  load_band(sa, z + (size_t)kp * band, band);
  if (two) load_band(sb, z + (size_t)(outer - kp) * band, band);
  __syncthreads();
  band_fft<false>(sa, sb, two, p, tw, roots);
  for_each_pair(kp, outer, sa, sb, p, [&](int k, float2* pk, float2* pm, bool) {
    float2 xk, xm;
    split_pair(*pk, *pm, __ldg(split_tw + k), xk, xm);
    out[k] = xk;
    out[m - k] = xm;
  });
}

}  // namespace ffc

// z: (channels, outer, band) complex64 from the forward butterfly; out:
// (channels, outer * band + 1) complex64. The factors are the band's.
extern "C" int ffc_long_spectrum(const void* z, void* out, const void* tw, const void* split_tw,
                                 const void* roots, int channels, int outer, int n_stages,
                                 int f0, int f1, int f2, int f3, void* stream) {
  const int factors[4] = {f0, f1, f2, f3};
  ffc::Plan p;
  if (!ffc::make_plan(n_stages, factors, &p) || p.m > ffc::kMaxBand || channels < 1 ||
      outer < 2 || (outer & (outer - 1)) || (long long)outer * p.m > (1LL << 21) ||
      (long long)channels * (outer / 2 + 1) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ffc::band_pair_smem_bytes(p.m);
  cudaError_t err = cudaFuncSetAttribute(ffc::long_spectrum_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((long long)channels * (outer / 2 + 1));
  ffc::long_spectrum_kernel<<<blocks, ffc::kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)z, (float2*)out, (const float2*)tw, (const float2*)split_tw,
      (const float2*)roots, outer, p);
  return (int)cudaGetLastError();
}

FFC_EXPORT_ERROR_STRING()
