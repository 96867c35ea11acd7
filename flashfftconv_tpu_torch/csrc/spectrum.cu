// spectrum: half spectrum of the long-conv kernel taps.
//
// Replaces the TPU kernel _spectrum_tiles (flashfftconv_tpu/ops/
// monarch_pallas.py, def at l.558, pallas_call at l.602), which takes real
// taps (H, N1, N2) to a planar Monarch-layout spectrum of all N frequencies.
// Here: real f32 taps (H, k_len <= N), zero-padded to N inside the kernel,
// to the natural-order half spectrum (H, M+1) of complex f32 (interleaved
// re/im, torch.complex64), M = N/2 -- everything a real conv needs.
//
// Bound on the H100: bytes. One block per channel reads its taps once and
// writes M+1 complex values once; the FFT in between stays in shared memory
// (fft_common.cuh), at about 5 M log2 M f32 operations a row, far below the
// f32 rate. At H=768, k_len=8192, N=16384 the kernel reads 25 MB and writes
// 50 MB.

#include "fft_common.cuh"

namespace ffc {

__global__ void __launch_bounds__(kThreads)
    spectrum_kernel(const float* __restrict__ k, float2* __restrict__ out,
                    const float2* __restrict__ tw, const float2* __restrict__ split_tw,
                    const float2* __restrict__ roots_g, int k_len, Plan p) {
  extern __shared__ float2 s[];
  __shared__ float2 roots[kMaxFactor];
  const int m = p.m;
  k += (size_t)blockIdx.x * k_len;
  out += (size_t)blockIdx.x * (m + 1);
  load_roots(roots, roots_g);
  for (int n = threadIdx.x; n < m; n += blockDim.x) {
    const int i = 2 * n;
    s[slot(n)] = make_float2(i < k_len ? k[i] : 0.f, i + 1 < k_len ? k[i + 1] : 0.f);
  }
  __syncthreads();
  forward_fft(s, p, tw, roots);
  for (int f = threadIdx.x; f <= m / 2; f += blockDim.x) {
    float2 xk, xm;
    split_pair(s[freq_slot(f, p)], s[freq_slot((m - f) & (m - 1), p)], __ldg(split_tw + f), xk,
               xm);
    out[f] = xk;
    out[m - f] = xm;
  }
}

}  // namespace ffc

extern "C" int ffc_spectrum(const void* k, void* out, const void* tw, const void* split_tw,
                            const void* roots, int channels, int k_len, int n_stages, int f0,
                            int f1, int f2, int f3, void* stream) {
  const int factors[4] = {f0, f1, f2, f3};
  ffc::Plan p;
  if (!ffc::make_plan(n_stages, factors, &p) || channels < 1 || k_len < 1 || k_len > 2 * p.m)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ffc::smem_bytes(p.m);
  cudaError_t err = cudaFuncSetAttribute(
      ffc::spectrum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffc::spectrum_kernel<<<channels, ffc::kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)k, (float2*)out, (const float2*)tw, (const float2*)split_tw,
      (const float2*)roots, k_len, p);
  return (int)cudaGetLastError();
}

FFC_EXPORT_ERROR_STRING()
