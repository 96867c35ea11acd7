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
// Function: for complex64 bands b (rows, N2), row r of channel r % H, and a
// full complex64 spectrum K (H, N2) in natural frequency order,
//   y = ifft_N2(fft_N2(b) * K)        (conj(K) with conj; 1/N2 in the inverse).
// A band of the distributed FFT is a general complex signal and K is not
// Hermitian, so there is no real-FFT split here: the whole N2-point complex
// FFT runs, both ways.
//
// Design. One block owns one (b, h) row: N2 complex points in shared memory
// (8 N2 bytes and one pad float2 every 32 points, 132 KB at N2 = 16384, so
// one block an SM). The forward Monarch stages (factors <= 32 of the plan of
// FFT size 2 N2) run as line_fft (long_common.cuh), whose line stays in
// registers; 512 threads keep every line of a 32-point stage in flight at
// N2 = 16384. After the forward stages frequency k sits at freq_slot(k): a
// pass multiplies it by K[k], read coalesced; the inverse stages bring the row
// back to natural order and it goes out scaled by 1/N2. Blocks share
// nothing: no atomics, the same bits from run to run. N2 = 32768 (264 KB)
// does not fit one block; the sequence-parallel conv takes bands from 32768
// up through four real circular convs (parallel/seq_conv.py).
//
// Bound on the H100 at B=4, H=768, N2=16384: it reads 403 MB of bands and
// 101 MB of K and writes 403 MB, 0.27 ms at 3.35 TB/s, against two N2-point
// complex FFTs and the product a row (about 8.6 GFLOP, 0.13 ms at the f32
// 67 TFLOP/s): bytes.

#include "long_common.cuh"

namespace ffc {

constexpr int kBandConvThreads = 512;
// Longest row: one padded row of float2 must fit one block's shared memory.
constexpr int kBandConvMax = 16384;

__global__ void __launch_bounds__(kBandConvThreads, 1)
    band_conv_kernel(const float2* __restrict__ b, const float2* __restrict__ k_f,
                     float2* __restrict__ out, const float2* __restrict__ tw,
                     const float2* __restrict__ roots_g, int channels, int conj, Plan p) {
  extern __shared__ float2 s[];
  __shared__ float2 roots[kMaxFactor];
  const int n2 = p.m;
  const size_t row = (size_t)blockIdx.x * n2;
  const float2* kh = k_f + (size_t)(blockIdx.x % channels) * n2;
  load_roots(roots, roots_g);
  load_band(s, b + row, n2);
  __syncthreads();
  band_fft<false>(s, nullptr, false, p, tw, roots);

  for (int k = threadIdx.x; k < n2; k += blockDim.x) {
    float2 w = __ldg(kh + k);
    if (conj) w.y = -w.y;
    float2* sk = s + freq_slot(k, p);
    *sk = cmul(*sk, w);
  }
  __syncthreads();
  band_fft<true>(s, nullptr, false, p, tw, roots);

  const float scale = 1.f / (float)n2;
  float2* o = out + row;
  for (int n = threadIdx.x; n < n2; n += blockDim.x) {
    const float2 a = s[slot(n)];
    o[n] = make_float2(a.x * scale, a.y * scale);
  }
}

}  // namespace ffc

// b and out: (rows, n2) complex64, distinct buffers; k_f: (channels, n2)
// complex64, row r taking channel r % channels; tw and roots: the tables of
// the plan of FFT size 2 n2, whose factors are given; conj != 0 multiplies
// by conj(k_f).
extern "C" int ffc_band_conv(const void* b, const void* k_f, void* out, const void* tw,
                             const void* roots, int rows, int channels, int conj, int n_stages,
                             int f0, int f1, int f2, int f3, void* stream) {
  const int factors[4] = {f0, f1, f2, f3};
  ffc::Plan p;
  if (!ffc::make_plan(n_stages, factors, &p) || p.m < 16 || p.m > ffc::kBandConvMax ||
      rows < 1 || channels < 1 || rows % channels)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ffc::smem_bytes(p.m);
  cudaError_t err = cudaFuncSetAttribute(ffc::band_conv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffc::band_conv_kernel<<<(unsigned)rows, ffc::kBandConvThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)b, (const float2*)k_f, (float2*)out, (const float2*)tw,
      (const float2*)roots, channels, conj, p);
  return (int)cudaGetLastError();
}

FFC_EXPORT_ERROR_STRING()
