// monarch_conv: fused causal FFT convolution, (B, H, L) in, (B, H, L) out.
//
// Replaces the TPU kernel _conv_fused_io_tiles (flashfftconv_tpu/ops/
// monarch_pallas.py, def at l.340, pallas_call at l.459) and the 2-factor
// branch of _conv_raw that dispatches it: one device-memory round trip that
// reads u (and the optional pregate), zero-pads to N, runs the forward FFT,
// multiplies by the kernel spectrum, runs the inverse FFT, truncates to L,
// applies the optional postgate and writes the output at u's dtype.
//
// Design on the H100. The TPU kernel packs two batch rows as one complex
// signal and keeps a full N-point complex tile (128 KB in f32 at N = 16384)
// in VMEM. Here one block owns one (b, h) row and packs its even and odd
// samples as one M = N/2 point complex signal instead (fft_conv's real input
// is exploited once, any B works and no partner row is needed), so a row is
// 8M bytes of shared memory: 64 KB at N = 16384, three blocks an SM, and
// 128 KB at N = 32768, which still fits the 227 KB a block may have. The
// kernel spectrum comes in as the f32 half spectrum (H, M+1) from
// spectrum.cu. Blocks are ordered channel-major so the B rows of one channel
// run together and share its spectrum in L2. Any B, H and L <= N are taken:
// the load masks the ragged end and the store truncates.
//
// Bound on the H100: at B=4, H=768, L=8192, N=16384 (bf16, ungated) the
// kernel must move 50 MB of u, 50 MB of output and 50 MB of f32 spectrum,
// about 45 us at 3.35 TB/s, and do two 8192-point complex FFTs a row in f32
// FMA (radix-2 lines, about 5 M log2 M operations each, plus the stage and
// split twiddles): about 4.3 GFLOP, about 64 us at 67 TFLOP/s. So the f32
// pipes bound it; tensor-core DFTs (mma.sync / wgmma on bf16 operands) are
// the later step that moves that bound.

#include "fft_common.cuh"

namespace ffc {

// x[i] of the (gated) input, 0 past the end. The pregate product is rounded
// to T, as u * pregate is in the JAX package and in the plain version.
template <typename T, bool GATED>
__device__ __forceinline__ float load_in(const T* __restrict__ u, const T* __restrict__ pre,
                                         int i, int length) {
  if (i >= length) return 0.f;
  if (GATED) return to_f(from_f<T>(to_f(u[i]) * to_f(pre[i])));
  return to_f(u[i]);
}

template <typename T, bool GATED>
__device__ __forceinline__ void store_out(T* __restrict__ out, const T* __restrict__ post, int i,
                                          int length, float y) {
  if (i >= length) return;
  if (GATED) y *= to_f(post[i]);
  out[i] = from_f<T>(y);
}

template <typename T, bool GATED>
__global__ void __launch_bounds__(kThreads)
    monarch_conv_kernel(const T* __restrict__ u, const T* __restrict__ pre,
                        const T* __restrict__ post, const float2* __restrict__ k_f,
                        T* __restrict__ out, const float2* __restrict__ tw,
                        const float2* __restrict__ split_tw, const float2* __restrict__ roots_g,
                        int batch, int channels, int length, Plan p) {
  extern __shared__ float2 s[];
  __shared__ float2 roots[kMaxFactor];
  const int m = p.m;
  const int h = blockIdx.x / batch;
  const int b = blockIdx.x - h * batch;
  const size_t row = ((size_t)b * channels + h) * length;
  u += row;
  out += row;
  if (GATED) {
    pre += row;
    post += row;
  }
  k_f += (size_t)h * (m + 1);
  load_roots(roots, roots_g);
  for (int n = threadIdx.x; n < m; n += blockDim.x) {
    s[slot(n)] = make_float2(load_in<T, GATED>(u, pre, 2 * n, length),
                             load_in<T, GATED>(u, pre, 2 * n + 1, length));
  }
  __syncthreads();
  forward_fft(s, p, tw, roots);

  // Pointwise in frequency: split the pair (k, M-k) into the half spectrum
  // of the real row, multiply by the kernel's, and pack it back.
  for (int f = threadIdx.x; f <= m / 2; f += blockDim.x) {
    const int sk = freq_slot(f, p);
    const int sm = freq_slot((m - f) & (m - 1), p);
    const float2 w = __ldg(split_tw + f);
    float2 xk, xm, zk, zm;
    split_pair(s[sk], s[sm], w, xk, xm);
    unsplit_pair(cmul(xk, __ldg(k_f + f)), cmul(xm, __ldg(k_f + m - f)), w, zk, zm);
    s[sk] = zk;
    if (f != 0) s[sm] = zm;
  }
  __syncthreads();
  inverse_fft(s, p, tw, roots);

  const float scale = 1.f / (float)m;
  for (int n = threadIdx.x; n < m; n += blockDim.x) {
    const float2 z = s[slot(n)];
    store_out<T, GATED>(out, post, 2 * n, length, z.x * scale);
    store_out<T, GATED>(out, post, 2 * n + 1, length, z.y * scale);
  }
}

template <typename T, bool GATED>
cudaError_t launch(const void* u, const void* pre, const void* post, const void* k_f, void* out,
                   const void* tw, const void* split_tw, const void* roots, int batch,
                   int channels, int length, const Plan& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.m);
  auto kernel = monarch_conv_kernel<T, GATED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(batch * channels), kThreads, smem, stream>>>(
      (const T*)u, (const T*)pre, (const T*)post, (const float2*)k_f, (T*)out,
      (const float2*)tw, (const float2*)split_tw, (const float2*)roots, batch, channels, length,
      p);
  return cudaGetLastError();
}

}  // namespace ffc

// dtype: 0 = float32, 1 = bfloat16. pre and post are both null (ungated) or
// both set (gated).
extern "C" int ffc_monarch_conv(const void* u, const void* pre, const void* post,
                                const void* k_f, void* out, const void* tw, const void* split_tw,
                                const void* roots, int batch, int channels, int length,
                                int n_stages, int f0, int f1, int f2, int f3, int dtype,
                                void* stream) {
  const int factors[4] = {f0, f1, f2, f3};
  ffc::Plan p;
  if (!ffc::make_plan(n_stages, factors, &p) || batch < 1 || channels < 1 || length < 1 ||
      length > 2 * p.m || (long long)batch * channels > 0x7fffffffLL ||
      (pre == nullptr) != (post == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool gated = pre != nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 0) {
    err = gated ? ffc::launch<float, true>(u, pre, post, k_f, out, tw, split_tw, roots, batch,
                                           channels, length, p, st)
                : ffc::launch<float, false>(u, pre, post, k_f, out, tw, split_tw, roots, batch,
                                            channels, length, p, st);
  } else if (dtype == 1) {
    err = gated ? ffc::launch<__nv_bfloat16, true>(u, pre, post, k_f, out, tw, split_tw, roots,
                                                   batch, channels, length, p, st)
                : ffc::launch<__nv_bfloat16, false>(u, pre, post, k_f, out, tw, split_tw, roots,
                                                    batch, channels, length, p, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

FFC_EXPORT_ERROR_STRING()
