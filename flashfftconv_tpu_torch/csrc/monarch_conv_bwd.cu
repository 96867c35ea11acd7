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
// dk_finish on the H100: one instantiation per FFT size (dk_finish_kernel
// <LOG_M>, N = 16 ... 32768; the C entry keeps its plan arguments and
// dispatches on N = 2 M) of spectrum.cu's and monarch_conv.cu's in-register
// row FFT (row_fft.cuh): T = M/P threads a channel, P points each, every
// index a compile-time constant (no stack frame), up to M = 1024 several
// channels a 128-thread block.
//   - The pointwise pass: each thread takes frequency pairs (f, M - f),
//     f = tr + T q, reads the B partials of both in b order (coalesced:
//     neighbouring threads read neighbouring frequencies; b the outer loop,
//     so that the loads of all a thread's pairs fly at once), sums them,
//     unsplits (split_tw from the block's root table), and writes the
//     conjugate to the row's two swizzled slots; f = M/2 alone.
//   - The inverse FFT is the forward transform of the conjugate (stage 0's
//     lines from shared memory), conjugated at the store.
//   - The store: E = 2 points (4 samples of f32, 16 bytes) a store where
//     the channel's row of dk is aligned and whole there, scaled by 1/M,
//     truncated at k_len.
// Bound on the H100 at B=4, H=768, N=16384: the function reads one (H, M+1)
// spectrum (50 MB) and writes dk (25 MB), 0.0225 ms at 3.35 TB/s; reading
// the B partials instead (201 MB) is this design's own traffic, 0.045 ms
// more, which only a monarch_conv_bwd that sums over B itself removes.
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
#include "row_fft.cuh"

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

namespace dkf {

using namespace row;

// f32 dk: E = 2 packed points (4 samples, 16 bytes) a store.
template <int LOG_M>
using CfgF = Cfg<LOG_M, 1>;

// dk[h, :k_len] = irfft(sum_b P[b, h])[:k_len] for the channels h of this
// block.
template <int LOG_M>
__global__ void __launch_bounds__(CfgF<LOG_M>::kThreads, CfgF<LOG_M>::kMinBlocks)
    dk_finish_kernel(const float2* __restrict__ partials, float* __restrict__ dk,
                     const float2* __restrict__ split_tw, int batch, int channels, int k_len) {
  using C = CfgF<LOG_M>;
  constexpr int kM = C::kM, kT = C::kT, kP = C::kP, kE = C::kE, kF0 = C::kF0, kR0 = C::kR0;
  extern __shared__ float4 smem_raw[];
  float2* smem = reinterpret_cast<float2*>(smem_raw);
  float2* tab = smem + C::kRows * kM;
  load_table<C>(tab, split_tw);
  __syncthreads();

  // The pointwise pass: pairs (f, M - f), f = tr + T q < M/2, and M/2 alone:
  // Y = sum_b P[b, h], in b order, unsplit and conjugated for the inverse.
  // The batch loop is the outer one, so that a thread has the P loads of all
  // its frequencies of one b in flight at once, and is unrolled to about 32
  // loads in flight where P is smaller (the sums keep their b order).
  {
    constexpr int kBatchUnroll = kP >= 32 ? 1 : 32 / kP;
    const int tr = threadIdx.x % kT, h = blockIdx.x * C::kRows + threadIdx.x / kT;
    float2* s = smem + (threadIdx.x / kT) * kM;
    const float2* part = partials + (size_t)(h < channels ? h : 0) * (kM + 1);
    const size_t stride = (size_t)channels * (kM + 1);
    float2 ya[kP / 2], yb[kP / 2], ym = make_float2(0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kP / 2; ++q) ya[q] = yb[q] = make_float2(0.f, 0.f);
#pragma unroll kBatchUnroll
    for (int b = 0; b < batch; ++b, part += stride) {
#pragma unroll
      for (int q = 0; q < kP / 2; ++q) {
        const int f = tr + kT * q;
        const float2 a = __ldg(part + f), c = __ldg(part + kM - f);
        ya[q] = make_float2(ya[q].x + a.x, ya[q].y + a.y);
        yb[q] = make_float2(yb[q].x + c.x, yb[q].y + c.y);
      }
      if (tr == 0) {
        const float2 a = __ldg(part + kM / 2);
        ym = make_float2(ym.x + a.x, ym.y + a.y);
      }
    }
#pragma unroll
    for (int q = 0; q < kP / 2; ++q) {
      const int f = tr + kT * q;
      float2 za, zb;
      unsplit_pair(ya[q], yb[q], root<C>(tab, f), za, zb);
      s[swz(f)] = make_float2(za.x, -za.y);
      if (f != 0) s[swz(kM - f)] = make_float2(zb.x, -zb.y);
    }
    if (tr == 0) {
      float2 z, unused;
      unsplit_pair(ym, ym, root<C>(tab, kM / 2), z, unused);
      s[swz(kM / 2)] = make_float2(z.x, -z.y);
    }
  }
  __syncthreads();

  // The inverse FFT of the conjugate, stage 0's lines from shared memory.
  const int tr = fresh_tid() % kT;
  float2* s = smem + (fresh_tid() / kT) * kM;
  float2 v[kP];
#pragma unroll
  for (int e = 0; e < kE; ++e)
#pragma unroll
    for (int j = 0; j < kF0; ++j) v[e * kF0 + j] = s[swz(j * kR0 + kE * tr + e)];
#pragma unroll
  for (int e = 0; e < kE; ++e) first_stage_line<C>(v + e * kF0, s, tab, kE * tr + e);
  mid_stages<C>(v, s, tab, tr);
  last_stage<C>(v, s, tr);
  __syncthreads();

  // dk[2n] + i dk[2n+1] = conj(s[n]) / M; E points (16 bytes) a store.
  const int h = blockIdx.x * C::kRows + fresh_tid() / kT;
  if (h >= channels) return;
  float* out = dk + (size_t)h * k_len;
  const bool aligned = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const float scale = 1.f / (float)kM;
#pragma unroll
  for (int q = 0; q < kP / kE; ++q) {
    const int n0 = kE * (tr + kT * q), i = 2 * n0;
    if (i >= k_len) continue;
    float y[2 * kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const float2 z = s[swz(n0 + e)];
      y[2 * e] = z.x * scale;
      y[2 * e + 1] = -z.y * scale;
    }
    if (aligned && i + 2 * kE <= k_len) {
      *reinterpret_cast<float4*>(out + i) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 2 * kE; ++c)
        if (i + c < k_len) out[i + c] = y[c];
    }
  }
}

template <int LOG_M>
cudaError_t launch(const void* partials, void* dk, const void* split_tw, int batch,
                   int channels, int k_len, cudaStream_t stream) {
  using C = CfgF<LOG_M>;
  if constexpr (C::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dk_finish_kernel<LOG_M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (channels + C::kRows - 1) / C::kRows;
  dk_finish_kernel<LOG_M><<<blocks, C::kThreads, C::kSmem, stream>>>(
      (const float2*)partials, (float*)dk, (const float2*)split_tw, batch, channels, k_len);
  return cudaGetLastError();
}

}  // namespace dkf
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

// partials (batch, channels, M+1) float2 -> dk (channels, k_len) float. The
// plan's factors give M; of its tables only split_tw (exp(-2 pi i m / N),
// m = 0 .. M) is read.
extern "C" int ffc_dk_finish(const void* partials, void* dk, const void* tw, const void* split_tw,
                             const void* roots, int batch, int channels, int k_len,
                             int n_stages, int f0, int f1, int f2, int f3, void* stream) {
  const int factors[4] = {f0, f1, f2, f3};
  ffc::Plan p;
  if (!ffc::make_plan(n_stages, factors, &p) || batch < 1 || channels < 1 || k_len < 1 ||
      k_len > 2 * p.m)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FFC_DKF_CASE(LOG_M)                                                                \
  case 2 << LOG_M:                                                                         \
    return (int)ffc::dkf::launch<LOG_M>(partials, dk, split_tw, batch, channels, k_len, st);
  switch (2 * p.m) {
    FFC_DKF_CASE(3)
    FFC_DKF_CASE(4)
    FFC_DKF_CASE(5)
    FFC_DKF_CASE(6)
    FFC_DKF_CASE(7)
    FFC_DKF_CASE(8)
    FFC_DKF_CASE(9)
    FFC_DKF_CASE(10)
    FFC_DKF_CASE(11)
    FFC_DKF_CASE(12)
    FFC_DKF_CASE(13)
    FFC_DKF_CASE(14)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFC_DKF_CASE
}

FFC_EXPORT_ERROR_STRING()
