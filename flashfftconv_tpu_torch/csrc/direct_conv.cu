// direct_conv and direct_conv_bwd: the FFT conv of small N as one dense DFT
// a row.
//
// direct_conv replaces the TPU kernel _direct_fused_io_tiles
// (flashfftconv_tpu/ops/monarch_pallas.py, def at l.477, pallas_call at
// l.540) and direct_conv_bwd replaces _direct_bwd_fused_io_tiles (def at
// l.1460, pallas_call at l.1572). For FFT sizes N <= 512 (M = N/2) they
// compute, for every (b, h) row of L <= N samples,
//   forward:  x = u * pre (rounded to T), U[f] = sum_{t<L} x[t] w^(f t),
//             y[t] = irfft(U K)[t] * post, t < L;
//   backward: g = dout * post (f32), G, and when gated U; du_inner from
//             G conj(K), y_inner from U K; du = du_inner * pre,
//             dpre = du_inner * u, dpost = y_inner * dout (ungated:
//             du = du_inner); and dk's spectrum sum_b G conj(U), (1, H, M+1),
//             which dk_finish (monarch_conv_bwd.cu) turns into dk.
// w = exp(-2 pi i / N); every entry w^j comes from the plan's N-point table
// at the exact integer index j = (f t) & (N - 1).
//
// The TPU kernels multiply (16, N) row tiles by (N, N) DFT matrices on the
// MXU and compute all N frequencies. Here the input is real, so only the
// half spectrum f = 0..M is formed, and both transforms fold by symmetry:
//   * forward: one thread owns frequency f < M/2 and four rows; it sums
//     x[t] w^(f t) into four accumulators by t mod 4 (S0..S3), which give
//     U[f] = S0 + S1 + S2 + S3 and U[f + M/2] = S0 - i S1 - S2 + i S3
//     (w^(M/2) = -i), and at f = 0 also U[M] = S0 - S1 + S2 - S3;
//   * inverse: y[t] = (Y[0] + (-1)^t Y[M] + 2 sum_{f=1}^{M-1} Re(Y[f] w^-(f t)))/N,
//     and since w^-((M-f) t) = (-1)^t conj(w^-(f t)), the terms f and M - f
//     share one table entry: Y is folded in place into E[f] (even t) and
//     O[f] = slot M - f (odd t), f = 1..M/2, and one thread owns a sample t
//     and four rows, with two FMAs a frequency and a row.
// That is L M FMAs a row for each transform (2 L M for the forward conv):
// about 3.2 G FMA at B=128, H=768, L=128, N=256.
//
// Design on the H100. One block owns one channel h and a run of R = 2048/M
// batch rows (16 at N = 256, 8 at N = 512), so that the forward's M/2
// frequencies times R/4 row groups are its 256 threads; k_f[h] is loaded
// once into shared memory, and the rows are staged there as f32 after the
// pregate, transposed to [t][r] so that a thread reads its four rows with
// one 16-byte load, which all threads of a warp share. The table is padded
// by one entry every 16 (slot j + j/16) so that the stride-t and stride-f
// index patterns of a warp spread over the banks. The spectra stay in shared
// memory ((M+1) R complex values). The backward's block walks the whole
// batch in chunks of R rows, in order, and adds each chunk's G conj(U) into
// one (M+1) spectrum in shared memory: dk's sum over the batch is done in a
// fixed order inside the block, with no float atomics, so two backwards give
// the same bits. Nothing runs on the tensor cores: every product is f32.
//
// Bound on the H100: operations. At the M2-BERT shape (B=128, H=768, L=128,
// N=256, bf16) the forward reads 25 MB and writes 25 MB (15 us at
// 3.35 TB/s); the dense DFT here does 6.4 GFLOP of f32 FMAs (96 us at
// 67 TFLOP/s), fed from shared memory (an FFT-based conv would need about
// 1.3 GFLOP).

#include "fft_common.cuh"

namespace ffc {
namespace direct {

constexpr int kThreads = 256;
constexpr int kGroup = 4;  // rows a thread owns

// Padded slot of table entry j: one spare entry every 16.
__device__ __forceinline__ int rslot(int j) { return j + (j >> 4); }

struct Dims {
  int batch, channels, length;
  int n, m;   // N and M = N / 2
  int rows;   // R, batch rows a block holds at a time (a multiple of 4)
  int lp;     // L rounded up to a multiple of 4
};

inline int rows_per_block(int m) { return 2048 / m; }

// Shared memory of a block: the spectra, the staged rows, the padded table,
// k_f and (backward) dk's spectrum.
inline size_t smem_bytes(const Dims& d, int spectra, int signals) {
  return (size_t)spectra * (d.m + 1) * d.rows * sizeof(float2) +
         (size_t)signals * d.lp * d.rows * sizeof(float) +
         (size_t)(d.n + d.n / 16) * sizeof(float2) + (size_t)2 * (d.m + 1) * sizeof(float2);
}

__device__ __forceinline__ void cfma(float2& acc, float x, float2 w) {
  acc.x = fmaf(x, w.x, acc.x);
  acc.y = fmaf(x, w.y, acc.y);
}

__device__ void load_tables(float2* roots, float2* kf, const float2* __restrict__ roots_g,
                            const float2* __restrict__ kf_g, const Dims& d) {
  for (int j = threadIdx.x; j < d.n; j += blockDim.x) roots[rslot(j)] = roots_g[j];
  for (int f = threadIdx.x; f <= d.m; f += blockDim.x) kf[f] = kf_g[f];
}

// xs[t * R + r] = a * gate (or a) of row b0 + r, sample t; zero past L and
// past the batch. With ROUND the product rounds to T (the forward's input).
// A thread reads sample t of four rows (a warp reads each row's consecutive
// samples) and stores them with one 16-byte store.
template <typename T, bool ROUND>
__device__ void stage(float* xs, const T* __restrict__ a, const T* __restrict__ gate, int b0,
                      int h, const Dims& d) {
  for (int i = threadIdx.x; i < d.rows / kGroup * d.lp; i += blockDim.x) {
    const int r0 = i / d.lp * kGroup, t = i % d.lp;
    float v[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int b = b0 + r0 + g;
      v[g] = 0.f;
      if (t < d.length && b < d.batch) {
        const size_t at = ((size_t)b * d.channels + h) * d.length + t;
        v[g] = to_f(a[at]);
        if (gate != nullptr) {
          v[g] *= to_f(gate[at]);
          if (ROUND) v[g] = to_f(from_f<T>(v[g]));
        }
      }
    }
    *reinterpret_cast<float4*>(xs + t * d.rows + r0) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// spec[s][f * R + r] = sum_t xs[s][t * R + r] w^(f t) for f = 0..M, for NS
// signals that share the table entries. Thread item: (row group, f < M/2).
template <int NS>
__device__ void dft_half(const float* const (&xs)[NS], float2* const (&spec)[NS],
                         const float2* roots, const Dims& d) {
  const int half = d.m / 2, mask = d.n - 1;
  const int items = half * (d.rows / kGroup);
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int f = item % half, r0 = (item / half) * kGroup;
    float2 s[NS][4][kGroup];
#pragma unroll
    for (int q = 0; q < NS; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int g = 0; g < kGroup; ++g) s[q][c][g] = make_float2(0.f, 0.f);
    int j = 0;  // (f * t) & mask
    for (int t = 0; t < d.lp; t += 4) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float2 w = roots[rslot(j)];
        j = (j + f) & mask;
#pragma unroll
        for (int q = 0; q < NS; ++q) {
          const float4 x = *reinterpret_cast<const float4*>(xs[q] + (t + c) * d.rows + r0);
          cfma(s[q][c][0], x.x, w);
          cfma(s[q][c][1], x.y, w);
          cfma(s[q][c][2], x.z, w);
          cfma(s[q][c][3], x.w, w);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NS; ++q) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const float2 s0 = s[q][0][g], s1 = s[q][1][g], s2 = s[q][2][g], s3 = s[q][3][g];
        const float2 a = make_float2(s0.x + s2.x, s0.y + s2.y);
        const float2 c = make_float2(s1.x + s3.x, s1.y + s3.y);
        const float2 e = make_float2(s0.x - s2.x, s0.y - s2.y);
        const float2 o = make_float2(s1.x - s3.x, s1.y - s3.y);
        float2* out = spec[q] + r0 + g;
        out[f * d.rows] = make_float2(a.x + c.x, a.y + c.y);
        out[(f + half) * d.rows] = make_float2(e.x + o.y, e.y - o.x);
        if (f == 0) out[d.m * d.rows] = make_float2(a.x - c.x, a.y - c.y);
      }
    }
  }
}

// Fold Y in place for the inverse: for f = 1..M/2, slot f <- E[f] and slot
// M - f <- O[f], where the sample t's sum takes E (t even) or O (t odd):
//   E = (Y.x + Y'.x, Y'.y - Y.y), O = (Y.x - Y'.x, -Y.y - Y'.y), Y' = Y[M-f];
// at f = M/2 (its own partner) E = O = (Y.x, -Y.y). Slots 0 and M keep Y[0]
// and Y[M].
__device__ void fold(float2* spec, const Dims& d) {
  const int half = d.m / 2;
  for (int i = threadIdx.x; i < half * d.rows; i += blockDim.x) {
    const int f = 1 + i / d.rows, r = i - (f - 1) * d.rows;
    float2* a = spec + f * d.rows + r;
    float2* b = spec + (d.m - f) * d.rows + r;
    const float2 y = *a, yr = *b;
    if (f == half) {
      *a = make_float2(y.x, -y.y);
    } else {
      *a = make_float2(y.x + yr.x, yr.y - y.y);
      *b = make_float2(y.x - yr.x, -y.y - yr.y);
    }
  }
}

// For every sample t < L and row r of the block, the NS inverse transforms
// of the folded spectra (with 1/N), handed to epi(t, r, v[NS]).
template <int NS, typename Epi>
__device__ void idft(float2* const (&spec)[NS], const float2* roots, const Dims& d, Epi epi) {
  const int half = d.m / 2, mask = d.n - 1;
  const int items = d.length * (d.rows / kGroup);
  const float inv_n = 1.f / (float)d.n;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int t = item % d.length, r0 = (item / d.length) * kGroup;
    const int odd = t & 1;
    float acc[NS][kGroup];
#pragma unroll
    for (int q = 0; q < NS; ++q)
#pragma unroll
      for (int g = 0; g < kGroup; ++g) acc[q][g] = 0.f;
    int j = t & mask;  // (f * t) & mask at f = 1
    for (int f = 1; f <= half; ++f) {
      const float2 w = roots[rslot(j)];
      j = (j + t) & mask;
      const int sl = (odd ? d.m - f : f) * d.rows + r0;
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        const float4 c01 = *reinterpret_cast<const float4*>(spec[q] + sl);
        const float4 c23 = *reinterpret_cast<const float4*>(spec[q] + sl + 2);
        acc[q][0] = fmaf(w.x, c01.x, fmaf(-w.y, c01.y, acc[q][0]));
        acc[q][1] = fmaf(w.x, c01.z, fmaf(-w.y, c01.w, acc[q][1]));
        acc[q][2] = fmaf(w.x, c23.x, fmaf(-w.y, c23.y, acc[q][2]));
        acc[q][3] = fmaf(w.x, c23.z, fmaf(-w.y, c23.w, acc[q][3]));
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      float v[NS];
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        const float y0 = spec[q][r0 + g].x, ym = spec[q][d.m * d.rows + r0 + g].x;
        v[q] = (y0 + (odd ? -ym : ym) + 2.f * acc[q][g]) * inv_n;
      }
      epi(t, r0 + g, v);
    }
  }
}

template <typename T, bool GATED>
__global__ void __launch_bounds__(kThreads)
    direct_conv_kernel(const T* __restrict__ u, const T* __restrict__ pre,
                       const T* __restrict__ post, const float2* __restrict__ k_f,
                       T* __restrict__ out, const float2* __restrict__ roots_g, Dims d) {
  extern __shared__ float4 smem4[];
  float2* spec = reinterpret_cast<float2*>(smem4);
  float* xs = reinterpret_cast<float*>(spec + (size_t)(d.m + 1) * d.rows);
  float2* roots = reinterpret_cast<float2*>(xs + (size_t)d.lp * d.rows);
  float2* kf = roots + d.n + d.n / 16;
  const int h = blockIdx.x, b0 = blockIdx.y * d.rows;
  load_tables(roots, kf, roots_g, k_f + (size_t)h * (d.m + 1), d);
  stage<T, true>(xs, u, GATED ? pre : nullptr, b0, h, d);
  __syncthreads();
  {
    const float* in[1] = {xs};
    float2* sp[1] = {spec};
    dft_half<1>(in, sp, roots, d);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (d.m + 1) * d.rows; i += blockDim.x)
    spec[i] = cmul(spec[i], kf[i / d.rows]);
  __syncthreads();
  fold(spec, d);
  __syncthreads();
  float2* sp[1] = {spec};
  idft<1>(sp, roots, d, [&](int t, int r, const float (&v)[1]) {
    const int b = b0 + r;
    if (b >= d.batch) return;
    const size_t at = ((size_t)b * d.channels + h) * d.length + t;
    out[at] = from_f<T>(GATED ? v[0] * to_f(post[at]) : v[0]);
  });
}

template <typename T, bool GATED>
__global__ void __launch_bounds__(kThreads)
    direct_conv_bwd_kernel(const T* __restrict__ u, const T* __restrict__ pre,
                           const T* __restrict__ post, const T* __restrict__ dout,
                           const float2* __restrict__ k_f, T* __restrict__ du,
                           T* __restrict__ dpre, T* __restrict__ dpost,
                           float2* __restrict__ dk_f, const float2* __restrict__ roots_g,
                           Dims d) {
  extern __shared__ float4 smem4[];
  float2* gsp = reinterpret_cast<float2*>(smem4);
  float2* usp = gsp + (size_t)(d.m + 1) * d.rows;
  float* xs = reinterpret_cast<float*>(usp + (size_t)(d.m + 1) * d.rows);
  float* gs = xs + (size_t)d.lp * d.rows;
  float2* roots = reinterpret_cast<float2*>(gs + (size_t)d.lp * d.rows);
  float2* kf = roots + d.n + d.n / 16;
  float2* dk = kf + d.m + 1;
  const int h = blockIdx.x;
  load_tables(roots, kf, roots_g, k_f + (size_t)h * (d.m + 1), d);
  for (int f = threadIdx.x; f <= d.m; f += blockDim.x) dk[f] = make_float2(0.f, 0.f);
  for (int b0 = 0; b0 < d.batch; b0 += d.rows) {
    stage<T, true>(xs, u, GATED ? pre : nullptr, b0, h, d);
    stage<T, false>(gs, dout, GATED ? post : nullptr, b0, h, d);
    __syncthreads();
    {
      const float* in[2] = {gs, xs};
      float2* sp[2] = {gsp, usp};
      dft_half<2>(in, sp, roots, d);
    }
    __syncthreads();
    // dk's spectrum: this chunk's rows added to the earlier chunks' sum in a
    // fixed order, rotated by f so that a warp's reads fall on distinct banks.
    for (int f = threadIdx.x; f <= d.m; f += blockDim.x) {
      float2 acc = dk[f];
      for (int i = 0; i < d.rows; ++i) {
        const int r = (i + f) & (d.rows - 1);
        const float2 p = cmul_conj(gsp[f * d.rows + r], usp[f * d.rows + r]);
        acc = make_float2(acc.x + p.x, acc.y + p.y);
      }
      dk[f] = acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < (d.m + 1) * d.rows; i += blockDim.x) {
      const float2 k = kf[i / d.rows];
      gsp[i] = cmul_conj(gsp[i], k);
      if (GATED) usp[i] = cmul(usp[i], k);
    }
    __syncthreads();
    fold(gsp, d);
    if (GATED) fold(usp, d);
    __syncthreads();
    if (GATED) {
      float2* sp[2] = {gsp, usp};
      idft<2>(sp, roots, d, [&](int t, int r, const float (&v)[2]) {
        const int b = b0 + r;
        if (b >= d.batch) return;
        const size_t at = ((size_t)b * d.channels + h) * d.length + t;
        du[at] = from_f<T>(v[0] * to_f(pre[at]));
        dpre[at] = from_f<T>(v[0] * to_f(u[at]));
        dpost[at] = from_f<T>(v[1] * to_f(dout[at]));
      });
    } else {
      float2* sp[1] = {gsp};
      idft<1>(sp, roots, d, [&](int t, int r, const float (&v)[1]) {
        const int b = b0 + r;
        if (b >= d.batch) return;
        du[((size_t)b * d.channels + h) * d.length + t] = from_f<T>(v[0]);
      });
    }
    __syncthreads();
  }
  for (int f = threadIdx.x; f <= d.m; f += blockDim.x) dk_f[(size_t)h * (d.m + 1) + f] = dk[f];
}

inline bool make_dims(int batch, int channels, int length, int n, Dims* d) {
  if (n < 16 || n > 512 || (n & (n - 1)) || batch < 1 || channels < 1 || length < 1 ||
      length > n)
    return false;
  d->batch = batch;
  d->channels = channels;
  d->length = length;
  d->n = n;
  d->m = n / 2;
  d->rows = rows_per_block(d->m);
  d->lp = (length + 3) & ~3;
  return true;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
cudaError_t run_fwd(const void* u, const void* pre, const void* post, const void* k_f, void* out,
                    const void* roots, const Dims& d, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, 1, 1);
  const dim3 grid(d.channels, (d.batch + d.rows - 1) / d.rows);
  auto kernel = pre != nullptr ? direct_conv_kernel<T, true> : direct_conv_kernel<T, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>((const T*)u, (const T*)pre, (const T*)post,
                                           (const float2*)k_f, (T*)out, (const float2*)roots, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_bwd(const void* u, const void* pre, const void* post, const void* dout,
                    const void* k_f, void* du, void* dpre, void* dpost, void* dk_f,
                    const void* roots, const Dims& d, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, 2, 2);
  const dim3 grid(d.channels);
  auto kernel = pre != nullptr ? direct_conv_bwd_kernel<T, true> : direct_conv_bwd_kernel<T, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>((const T*)u, (const T*)pre, (const T*)post,
                                           (const T*)dout, (const float2*)k_f, (T*)du, (T*)dpre,
                                           (T*)dpost, (float2*)dk_f, (const float2*)roots, d);
  return cudaGetLastError();
}

}  // namespace direct
}  // namespace ffc

// dtype: 0 = float32, 1 = bfloat16. pre and post are both null or both set.
extern "C" int ffc_direct_conv(const void* u, const void* pre, const void* post, const void* k_f,
                               void* out, const void* roots, int batch, int channels, int length,
                               int n, int dtype, void* stream) {
  ffc::direct::Dims d;
  if (!ffc::direct::make_dims(batch, channels, length, n, &d) ||
      (pre == nullptr) != (post == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)ffc::direct::run_fwd<float>(u, pre, post, k_f, out, roots, d, s);
  if (dtype == 1)
    return (int)ffc::direct::run_fwd<__nv_bfloat16>(u, pre, post, k_f, out, roots, d, s);
  return (int)cudaErrorInvalidValue;
}

// dk_f: (channels, M+1) complex f32, dk's spectrum summed over the batch.
// dpre and dpost are set exactly when pre and post are.
extern "C" int ffc_direct_conv_bwd(const void* u, const void* pre, const void* post,
                                   const void* dout, const void* k_f, void* du, void* dpre,
                                   void* dpost, void* dk_f, const void* roots, int batch,
                                   int channels, int length, int n, int dtype, void* stream) {
  ffc::direct::Dims d;
  const bool gated = pre != nullptr;
  if (!ffc::direct::make_dims(batch, channels, length, n, &d) || gated != (post != nullptr) ||
      gated != (dpre != nullptr) || gated != (dpost != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)ffc::direct::run_bwd<float>(u, pre, post, dout, k_f, du, dpre, dpost, dk_f, roots,
                                            d, s);
  if (dtype == 1)
    return (int)ffc::direct::run_bwd<__nv_bfloat16>(u, pre, post, dout, k_f, du, dpre, dpost,
                                                    dk_f, roots, d, s);
  return (int)cudaErrorInvalidValue;
}

FFC_EXPORT_ERROR_STRING()
