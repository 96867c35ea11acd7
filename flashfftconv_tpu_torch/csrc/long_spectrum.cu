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
// a channel in device memory. This source is the rest, in two kernels:
//   1. band_split_kernel: one block owns the band pair {kp, F - kp} of one
//      channel (long_common.cuh), runs the R-point FFTs of both in shared
//      memory and splits each frequency pair (k, M - k) into the half
//      spectrum of the real taps. Band k0 holds the frequencies k0 + F j,
//      and its partner F - k0 the frequencies M - k0 - F j, so the block
//      stores X[kp + F j] at [kp][j] and X[M - kp - F j] at [F - kp][R-1-j]
//      of the same bands it read, in place (X[M], band 0's partner of j = 0,
//      goes straight to the output). The split twiddle exp(-2 pi i k / N)
//      is exp(-2 pi i kp / N) exp(-2 pi i j / 2R): split_tw[kp] of the plan
//      times split_tw[j] of the band's plan, read along j. Neighbouring
//      threads take neighbouring j: every load and store is a run of
//      consecutive values (descending for the partner band).
//   2. bands_to_natural_kernel: out[k0 + F k1] = z[k0][k1], a transpose of
//      each channel's (F, R) bands through (32, 32) tiles in shared memory:
//      reads of 32 consecutive values of a band, stores of min(F, 32)
//      consecutive frequencies (8 at F = 8, 16 at F = 16).
// The first version stored X[k] and X[M - k] straight from the band pair,
// F points apart, one 32-byte sector an 8-byte value: that pass took longer
// than the FFT. Storing the C bands of a thread block cluster in runs of C
// (C = 8, the pairs read through distributed shared memory) took longer than
// this transpose: the cluster pass waited on remote reads from 8 blocks at
// once. The transpose moves the bands once more (2.1 GB read and written at
// the shape below), all of it in long runs.
// Every output has one writer (X[M/2], band 0's j = R/2, is stored twice by
// one thread), so two calls give the same bits. The kernel overwrites its
// input bands.
//
// Bound on the H100 at H=256, k_len=2^20, N=2^21: as a function it reads
// 1.07 GB of taps and writes 2.1 GB of spectrum, 0.96 ms at 3.35 TB/s,
// against one M-point FFT a channel in f32 (about 28 GFLOP, 0.4 ms): bytes.
// The bands between the butterfly and the first kernel (2.1 GB written and
// read) and the transpose's (2.1 GB read and written) are this design's own
// traffic.

#include "long_common.cuh"

namespace ffc {

__global__ void __launch_bounds__(kThreads, kBandMinBlocks)
    band_split_kernel(float2* __restrict__ z, float2* __restrict__ out,
                      const float2* __restrict__ tw, const float2* __restrict__ split_tw,
                      const float2* __restrict__ band_tw, const float2* __restrict__ roots_g,
                      int outer, Plan p) {
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
  float2* za = z + (size_t)kp * band;
  float2* zm = z + (size_t)(kp == 0 ? 0 : outer - kp) * band;
  load_roots(roots, roots_g);
  load_band(sa, za, band);
  if (two) load_band(sb, zm, band);
  __syncthreads();
  band_fft<false>(sa, sb, two, p, tw, roots);
  const float2 w0 = split_tw[kp];
  for_each_pair(kp, outer, sa, sb, p, [&](int k, float2* pk, float2* pm, bool first) {
    const int j = (k - kp) / outer;
    float2 xk, xm;
    split_pair(*pk, *pm, cmul(w0, __ldg(band_tw + j)), xk, xm);
    za[j] = xk;
    if (first)
      out[h * (size_t)(m + 1) + m] = xm;
    else
      zm[kp == 0 ? band - j : band - 1 - j] = xm;
  });
}

constexpr int kTile = 32;

__global__ void __launch_bounds__(kThreads)
    bands_to_natural_kernel(const float2* __restrict__ z, float2* __restrict__ out, int outer,
                            int band) {
  __shared__ float2 tile[kTile][kTile + 1];
  const int tiles_j = band / kTile, tiles_k = (outer + kTile - 1) / kTile;
  const int tj = blockIdx.x % tiles_j, tk = blockIdx.x / tiles_j % tiles_k;
  const size_t h = blockIdx.x / tiles_j / tiles_k;
  const size_t m = (size_t)outer * band;
  z += h * m;
  out += h * (m + 1);
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  for (int i = ty; i < kTile; i += kThreads / kTile) {
    const int k0 = tk * kTile + i;
    if (k0 < outer) tile[i][tx] = z[(size_t)k0 * band + tj * kTile + tx];
  }
  __syncthreads();
  for (int i = ty; i < kTile; i += kThreads / kTile) {
    const int k0 = tk * kTile + tx;
    if (k0 < outer) out[k0 + (size_t)outer * (tj * kTile + i)] = tile[tx][i];
  }
}

}  // namespace ffc

// z: (channels, outer, band) complex64 from the forward butterfly,
// overwritten; out: (channels, outer * band + 1) complex64. The factors are
// the band's; band_tw is the band plan's split_tw (band + 1 entries).
extern "C" int ffc_long_spectrum(void* z, void* out, const void* tw, const void* split_tw,
                                 const void* band_tw, const void* roots, int channels, int outer,
                                 int n_stages, int f0, int f1, int f2, int f3, void* stream) {
  const int factors[4] = {f0, f1, f2, f3};
  ffc::Plan p;
  if (!ffc::make_plan(n_stages, factors, &p) || p.m > ffc::kMaxBand || p.m < ffc::kTile ||
      channels < 1 || outer < 2 || (outer & (outer - 1)) ||
      (long long)outer * p.m > (1LL << 21) ||
      (long long)channels * (outer / 2 + 1) > 0x7fffffffLL ||
      (long long)channels * (p.m / ffc::kTile) * ((outer + ffc::kTile - 1) / ffc::kTile) >
          0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ffc::band_pair_smem_bytes(p.m);
  cudaError_t err = cudaFuncSetAttribute(ffc::band_split_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  ffc::band_split_kernel<<<(unsigned)((long long)channels * (outer / 2 + 1)), ffc::kThreads, smem,
                           st>>>((float2*)z, (float2*)out, (const float2*)tw,
                                 (const float2*)split_tw, (const float2*)band_tw,
                                 (const float2*)roots, outer, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      (long long)channels * (p.m / ffc::kTile) * ((outer + ffc::kTile - 1) / ffc::kTile);
  ffc::bands_to_natural_kernel<<<(unsigned)tiles, ffc::kThreads, 0, st>>>(
      (const float2*)z, (float2*)out, outer, p.m);
  return (int)cudaGetLastError();
}

FFC_EXPORT_ERROR_STRING()
