// monarch_conv_bwd: backward of the fused causal FFT convolution, and
// dk_finish, which turns its per-row dk spectra into dk.
//
// monarch_conv_bwd replaces the TPU kernel _bwd_fused_io_tiles
// (flashfftconv_tpu/ops/monarch_pallas.py, def at l.1281, pallas_call at
// l.1432): for every (b, h) row, with g = dout * post and ug = u * pre,
//   du_inner = irfft(G conj(K))[:L]    -> du = du_inner * pre, dpre = du_inner * u
//   y_inner  = irfft(U K)[:L] (gated)  -> dpost = y_inner * dout
//   P[b, h]  = G conj(U)               (the row's share of dk's spectrum)
// dk_finish is the card's counterpart of _finish_dk (l.2953, an XLA Monarch
// IDFT in the JAX package): dk[h] = irfft(sum_b P[b, h])[:k_len], in f32.
//
// Design on the H100. The TPU kernel holds U and G together in VMEM and
// accumulates dk_f over its sequential batch grid axis. Here one block owns
// one (b, h) row with the forward's single M-point buffer (8M bytes of
// shared memory: 64 KB at N = 16384, 128 KB at N = 32768; U and G together
// would need 256 KB at N = 32768, more than a block may have). G's half
// spectrum goes to the row's slot of the partials array in device memory
// between the two forward FFTs:
//   1. load g, FFT, split; write G to P[b, h]; multiply by conj(K), unsplit,
//      inverse FFT, store du (and dpre) masked to L;
//   2. load ug, FFT, split; overwrite P[b, h] with G conj(U) (each thread
//      reads back the entries it wrote itself); when gated multiply by K,
//      unsplit, inverse FFT and store dpost.
// Blocks run in no order, so dk_f is not summed across blocks: no float
// atomics. dk_finish reads the B partials of its channel in a fixed order,
// so dk is deterministic, then unsplits and runs one inverse FFT.
//
// ug is rounded to T as in the forward (monarch_conv.cu load_in), so U is
// the spectrum of the very input the forward convolved; g stays f32, as in
// the JAX gated kernel.
//
// Bound on the H100: at B=4, H=768, L=8192, N=16384 (bf16, ungated) the
// kernel reads 50 MB each of u and dout and 50 MB of f32 spectrum, writes
// 50 MB of du and 201 MB of f32 partials (about 120 us at 3.35 TB/s), and
// does three 8192-point complex FFTs a row in f32 (about 6.4 GFLOP, about
// 96 us at 67 TFLOP/s): bytes bound it, by a little, because of the
// partials. dk_finish reads the 201 MB once and writes 25 MB of dk.

#include "fft_common.cuh"

namespace ffc {

template <typename T>
__device__ __forceinline__ float load_ug(const T* __restrict__ u, const T* __restrict__ pre,
                                         int i, int length) {
  if (i >= length) return 0.f;
  if (pre != nullptr) return to_f(from_f<T>(to_f(u[i]) * to_f(pre[i])));
  return to_f(u[i]);
}

template <typename T>
__device__ __forceinline__ float load_g(const T* __restrict__ dout, const T* __restrict__ post,
                                        int i, int length) {
  if (i >= length) return 0.f;
  const float d = to_f(dout[i]);
  return post != nullptr ? d * to_f(post[i]) : d;
}

template <typename T, bool GATED>
__global__ void __launch_bounds__(kThreads)
    monarch_conv_bwd_kernel(const T* __restrict__ u, const T* __restrict__ pre,
                            const T* __restrict__ post, const T* __restrict__ dout,
                            const float2* __restrict__ k_f, T* __restrict__ du,
                            T* __restrict__ dpre, T* __restrict__ dpost,
                            float2* __restrict__ partials, const float2* __restrict__ tw,
                            const float2* __restrict__ split_tw,
                            const float2* __restrict__ roots_g, int batch, int channels,
                            int length, Plan p) {
  extern __shared__ float2 s[];
  __shared__ float2 roots[kMaxFactor];
  const int m = p.m;
  const int h = blockIdx.x / batch;
  const int b = blockIdx.x - h * batch;
  const size_t row = ((size_t)b * channels + h) * length;
  u += row;
  dout += row;
  du += row;
  if (GATED) {
    pre += row;
    post += row;
    dpre += row;
    dpost += row;
  }
  k_f += (size_t)h * (m + 1);
  float2* part = partials + ((size_t)b * channels + h) * (m + 1);
  load_roots(roots, roots_g);
  const float scale = 1.f / (float)m;

  // 1. G = rfft(g); du_inner = irfft(G conj K).
  for (int n = threadIdx.x; n < m; n += blockDim.x) {
    s[slot(n)] = make_float2(load_g<T>(dout, GATED ? post : nullptr, 2 * n, length),
                             load_g<T>(dout, GATED ? post : nullptr, 2 * n + 1, length));
  }
  __syncthreads();
  forward_fft(s, p, tw, roots);
  for (int f = threadIdx.x; f <= m / 2; f += blockDim.x) {
    const int sk = freq_slot(f, p);
    const int sm = freq_slot((m - f) & (m - 1), p);
    const float2 w = __ldg(split_tw + f);
    float2 gk, gm, zk, zm;
    split_pair(s[sk], s[sm], w, gk, gm);
    part[f] = gk;
    part[m - f] = gm;
    unsplit_pair(cmul_conj(gk, __ldg(k_f + f)), cmul_conj(gm, __ldg(k_f + m - f)), w, zk, zm);
    s[sk] = zk;
    if (f != 0) s[sm] = zm;
  }
  __syncthreads();
  inverse_fft(s, p, tw, roots);
  for (int n = threadIdx.x; n < m; n += blockDim.x) {
    const float2 z = s[slot(n)];
    const float v[2] = {z.x * scale, z.y * scale};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = 2 * n + q;
      if (i >= length) continue;
      if (GATED) {
        du[i] = from_f<T>(v[q] * to_f(pre[i]));
        dpre[i] = from_f<T>(v[q] * to_f(u[i]));
      } else {
        du[i] = from_f<T>(v[q]);
      }
    }
  }
  __syncthreads();

  // 2. U = rfft(ug); P = G conj U; y_inner = irfft(U K) when gated.
  for (int n = threadIdx.x; n < m; n += blockDim.x) {
    s[slot(n)] = make_float2(load_ug<T>(u, GATED ? pre : nullptr, 2 * n, length),
                             load_ug<T>(u, GATED ? pre : nullptr, 2 * n + 1, length));
  }
  __syncthreads();
  forward_fft(s, p, tw, roots);
  for (int f = threadIdx.x; f <= m / 2; f += blockDim.x) {
    const int sk = freq_slot(f, p);
    const int sm = freq_slot((m - f) & (m - 1), p);
    const float2 w = __ldg(split_tw + f);
    float2 uk, um;
    split_pair(s[sk], s[sm], w, uk, um);
    // f = M/2 is its own partner (uk == um there): update it once.
    part[f] = cmul_conj(part[f], uk);
    if (2 * f != m) part[m - f] = cmul_conj(part[m - f], um);
    if (GATED) {
      float2 zk, zm;
      unsplit_pair(cmul(uk, __ldg(k_f + f)), cmul(um, __ldg(k_f + m - f)), w, zk, zm);
      s[sk] = zk;
      if (f != 0) s[sm] = zm;
    }
  }
  if (!GATED) return;
  __syncthreads();
  inverse_fft(s, p, tw, roots);
  for (int n = threadIdx.x; n < m; n += blockDim.x) {
    const float2 z = s[slot(n)];
    const int i = 2 * n;
    if (i < length) dpost[i] = from_f<T>(z.x * scale * to_f(dout[i]));
    if (i + 1 < length) dpost[i + 1] = from_f<T>(z.y * scale * to_f(dout[i + 1]));
  }
}

// One block per channel: dk[h, :k_len] = irfft(sum_b P[b, h])[:k_len].
__global__ void __launch_bounds__(kThreads)
    dk_finish_kernel(const float2* __restrict__ partials, float* __restrict__ dk,
                     const float2* __restrict__ tw, const float2* __restrict__ split_tw,
                     const float2* __restrict__ roots_g, int batch, int channels, int k_len,
                     Plan p) {
  extern __shared__ float2 s[];
  __shared__ float2 roots[kMaxFactor];
  const int m = p.m;
  const int h = blockIdx.x;
  const size_t row_stride = (size_t)channels * (m + 1);
  const float2* part = partials + (size_t)h * (m + 1);
  dk += (size_t)h * k_len;
  load_roots(roots, roots_g);
  for (int f = threadIdx.x; f <= m / 2; f += blockDim.x) {
    float2 yk = make_float2(0.f, 0.f), ym = make_float2(0.f, 0.f);
    for (int b = 0; b < batch; ++b) {
      const float2 a = part[b * row_stride + f];
      const float2 c = part[b * row_stride + m - f];
      yk = make_float2(yk.x + a.x, yk.y + a.y);
      ym = make_float2(ym.x + c.x, ym.y + c.y);
    }
    float2 zk, zm;
    unsplit_pair(yk, ym, __ldg(split_tw + f), zk, zm);
    s[freq_slot(f, p)] = zk;
    if (f != 0) s[freq_slot(m - f, p)] = zm;
  }
  __syncthreads();
  inverse_fft(s, p, tw, roots);
  const float scale = 1.f / (float)m;
  for (int n = threadIdx.x; n < m; n += blockDim.x) {
    const float2 z = s[slot(n)];
    if (2 * n < k_len) dk[2 * n] = z.x * scale;
    if (2 * n + 1 < k_len) dk[2 * n + 1] = z.y * scale;
  }
}

template <typename T, bool GATED>
cudaError_t launch_bwd(const void* u, const void* pre, const void* post, const void* dout,
                       const void* k_f, void* du, void* dpre, void* dpost, void* partials,
                       const void* tw, const void* split_tw, const void* roots, int batch,
                       int channels, int length, const Plan& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.m);
  auto kernel = monarch_conv_bwd_kernel<T, GATED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(batch * channels), kThreads, smem, stream>>>(
      (const T*)u, (const T*)pre, (const T*)post, (const T*)dout, (const float2*)k_f, (T*)du,
      (T*)dpre, (T*)dpost, (float2*)partials, (const float2*)tw, (const float2*)split_tw,
      (const float2*)roots, batch, channels, length, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_any(bool gated, const void* u, const void* pre, const void* post,
                           const void* dout, const void* k_f, void* du, void* dpre, void* dpost,
                           void* partials, const void* tw, const void* split_tw,
                           const void* roots, int batch, int channels, int length,
                           const Plan& p, cudaStream_t st) {
  return gated ? launch_bwd<T, true>(u, pre, post, dout, k_f, du, dpre, dpost, partials, tw,
                                     split_tw, roots, batch, channels, length, p, st)
               : launch_bwd<T, false>(u, pre, post, dout, k_f, du, dpre, dpost, partials, tw,
                                      split_tw, roots, batch, channels, length, p, st);
}

}  // namespace ffc

// dtype: 0 = float32, 1 = bfloat16. pre, post, dpre and dpost are all null
// (ungated) or all set (gated). partials is (batch, channels, M+1) float2.
extern "C" int ffc_monarch_conv_bwd(const void* u, const void* pre, const void* post,
                                    const void* dout, const void* k_f, void* du, void* dpre,
                                    void* dpost, void* partials, const void* tw,
                                    const void* split_tw, const void* roots, int batch,
                                    int channels, int length, int n_stages, int f0, int f1,
                                    int f2, int f3, int dtype, void* stream) {
  const int factors[4] = {f0, f1, f2, f3};
  ffc::Plan p;
  const bool gated = pre != nullptr;
  if (!ffc::make_plan(n_stages, factors, &p) || batch < 1 || channels < 1 || length < 1 ||
      length > 2 * p.m || (long long)batch * channels > 0x7fffffffLL ||
      gated != (post != nullptr) || gated != (dpre != nullptr) || gated != (dpost != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)ffc::launch_bwd_any<float>(gated, u, pre, post, dout, k_f, du, dpre, dpost,
                                           partials, tw, split_tw, roots, batch, channels,
                                           length, p, st);
  if (dtype == 1)
    return (int)ffc::launch_bwd_any<__nv_bfloat16>(gated, u, pre, post, dout, k_f, du, dpre,
                                                   dpost, partials, tw, split_tw, roots, batch,
                                                   channels, length, p, st);
  return (int)cudaErrorInvalidValue;
}

// partials (batch, channels, M+1) float2 -> dk (channels, k_len) float.
extern "C" int ffc_dk_finish(const void* partials, void* dk, const void* tw, const void* split_tw,
                             const void* roots, int batch, int channels, int k_len,
                             int n_stages, int f0, int f1, int f2, int f3, void* stream) {
  const int factors[4] = {f0, f1, f2, f3};
  ffc::Plan p;
  if (!ffc::make_plan(n_stages, factors, &p) || batch < 1 || channels < 1 || k_len < 1 ||
      k_len > 2 * p.m)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ffc::smem_bytes(p.m);
  cudaError_t err = cudaFuncSetAttribute(
      ffc::dk_finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffc::dk_finish_kernel<<<channels, ffc::kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)partials, (float*)dk, (const float2*)tw, (const float2*)split_tw,
      (const float2*)roots, batch, channels, k_len, p);
  return (int)cudaGetLastError();
}

FFC_EXPORT_ERROR_STRING()
