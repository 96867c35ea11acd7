// Device code shared by the FFT kernels (the long kernels; spectrum.cu,
// monarch_conv.cu, monarch_conv_bwd.cu and band_conv.cu take their row FFT
// from row_fft.cuh and the pair splits and type conversions from here).
//
// One thread block owns one real row of length N = 2M. The row is packed as
// an M-point complex signal z[n] = x[2n] + i x[2n+1] and held in shared
// memory as float2 (8 bytes a point; slot() adds one float2 of padding every
// 32 points so that the last stage's contiguous lines do not all fall on one
// bank). The M-point FFT is Monarch-decomposed into the plan's factors
// (each <= 32): a stage gives every thread whole lines of f points, which it
// loads into registers, transforms with a radix-2 FFT built from the 32nd
// roots of unity, twiddles, and stores back in place. After the forward
// stages the point of frequency k1 + f1*k2 + ... sits at row-major position
// (k1, k2, ...): freq_slot() finds it. The split step turns the packed
// spectrum into the half spectrum X[0..M] of the real row and back.
//
// The plan's tables (ops/plan.py) come from exact integer-mod phases: the
// stage twiddles (f_j, R_j) concatenated, the split twiddles exp(-2 pi i k/N)
// for k = 0..M, and the 32 roots exp(-2 pi i k/32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Every library of the port exports ffc_error_string(code) so that its
// Python wrapper can name a failed launch. Each .so is loaded on its own
// (RTLD_LOCAL), so the shared name does not clash.
#define FFC_EXPORT_ERROR_STRING()                                  \
  extern "C" const char* ffc_error_string(int code) {             \
    return cudaGetErrorString((cudaError_t)code);                  \
  }

namespace ffc {

constexpr int kMaxFactor = 32;
constexpr int kMaxStages = 4;
constexpr int kThreads = 256;

struct Plan {
  int m;                   // inner complex length M = N / 2
  int n_stages;
  int f[kMaxStages];       // factors of M, powers of two in [2, 32]
  int log2f[kMaxStages];
  int stride[kMaxStages];  // R_j = prod(f[j+1:]), the stride of axis j
  int tw_off[kMaxStages];  // offset of stage j's (f_j, R_j) twiddles
};

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x >> 1); }

__host__ __device__ constexpr int bit_reverse(int x, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r = (r << 1) | ((x >> i) & 1);
  return r;
}

// Fills *p from the factors; false if they are not a valid plan.
inline bool make_plan(int n_stages, const int* factors, Plan* p) {
  if (n_stages < 1 || n_stages > kMaxStages) return false;
  int m = 1;
  for (int j = 0; j < kMaxStages; ++j) {
    const int f = j < n_stages ? factors[j] : 1;
    if (j < n_stages && (f < 2 || f > kMaxFactor || (f & (f - 1)))) return false;
    p->f[j] = f;
    p->log2f[j] = ilog2(f);
    m *= f;
  }
  p->m = m;
  p->n_stages = n_stages;
  int r = m, off = 0;
  for (int j = 0; j < kMaxStages; ++j) {
    r /= p->f[j];
    p->stride[j] = r;
    p->tw_off[j] = off;
    if (j < n_stages - 1) off += p->f[j] * r;
  }
  return true;
}

inline size_t smem_bytes(int m) { return (size_t)(m + (m >> 5)) * sizeof(float2); }

__device__ __forceinline__ int slot(int i) { return i + (i >> 5); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

// In-register F-point DFT, v[k] <- sum_t v[t] w^(k t), w = exp(-+2 pi i / F):
// iterative radix-2, bit-reversed input, natural-order output. Every index
// is a compile-time constant once unrolled, so v stays in registers.
template <int F, bool INV>
__device__ __forceinline__ void line_dft(float2 (&v)[F], const float2* roots) {
  constexpr int kBits = ilog2(F);
#pragma unroll
  for (int i = 0; i < F; ++i) {
    const int j = bit_reverse(i, kBits);
    if (j > i) {
      const float2 t = v[i];
      v[i] = v[j];
      v[j] = t;
    }
  }
#pragma unroll
  for (int s = 1; s <= kBits; ++s) {
    const int len = 1 << s;
    const int half = len >> 1;
#pragma unroll
    for (int i = 0; i < F; i += len) {
#pragma unroll
      for (int j = 0; j < half; ++j) {
        float2 w = roots[j * (kMaxFactor / len)];
        if (INV) w.y = -w.y;
        const float2 a = v[i + j];
        const float2 b = cmul(v[i + j + half], w);
        v[i + j] = make_float2(a.x + b.x, a.y + b.y);
        v[i + j + half] = make_float2(a.x - b.x, a.y - b.y);
      }
    }
  }
}

// One Monarch stage over the row in shared memory. Line (p, r) holds the
// points p*F*R + t*R + r, t < F. Forward: DFT along t, then multiply by
// tw[t*R + r]. Inverse: multiply by conj(tw[t*R + r]), then inverse DFT.
// tw is null on the last stage. Lines are disjoint, so no barrier inside.
template <int F, bool INV>
__device__ void stage_lines(float2* s, int m, int stride, const float2* __restrict__ tw,
                            const float2* roots) {
  const int lines = m / F;
  for (int line = threadIdx.x; line < lines; line += blockDim.x) {
    const int r = line & (stride - 1);
    const int base = (line - r) * F + r;
    float2 v[F];
#pragma unroll
    for (int t = 0; t < F; ++t) v[t] = s[slot(base + t * stride)];
    if (INV && tw != nullptr) {
#pragma unroll
      for (int t = 0; t < F; ++t) v[t] = cmul_conj(v[t], __ldg(tw + t * stride + r));
    }
    line_dft<F, INV>(v, roots);
    if (!INV && tw != nullptr) {
#pragma unroll
      for (int t = 0; t < F; ++t) v[t] = cmul(v[t], __ldg(tw + t * stride + r));
    }
#pragma unroll
    for (int t = 0; t < F; ++t) s[slot(base + t * stride)] = v[t];
  }
}

template <bool INV>
__device__ __noinline__ void stage(float2* s, int m, int f, int stride,
                                   const float2* __restrict__ tw, const float2* roots) {
  switch (f) {
    case 2: stage_lines<2, INV>(s, m, stride, tw, roots); break;
    case 4: stage_lines<4, INV>(s, m, stride, tw, roots); break;
    case 8: stage_lines<8, INV>(s, m, stride, tw, roots); break;
    case 16: stage_lines<16, INV>(s, m, stride, tw, roots); break;
    default: stage_lines<32, INV>(s, m, stride, tw, roots); break;
  }
}

// Forward M-point DFT in place (natural order in, Monarch order out).
// The caller synchronises before; this synchronises after every stage.
__device__ __forceinline__ void forward_fft(float2* s, const Plan& p,
                                            const float2* __restrict__ tw,
                                            const float2* roots) {
  for (int j = 0; j < p.n_stages; ++j) {
    const float2* twj = j < p.n_stages - 1 ? tw + p.tw_off[j] : nullptr;
    stage<false>(s, p.m, p.f[j], p.stride[j], twj, roots);
    __syncthreads();
  }
}

// Inverse M-point DFT in place (Monarch order in, natural order out), without
// the 1/M: the caller scales at the store.
__device__ __forceinline__ void inverse_fft(float2* s, const Plan& p,
                                            const float2* __restrict__ tw,
                                            const float2* roots) {
  for (int j = p.n_stages - 1; j >= 0; --j) {
    const float2* twj = j < p.n_stages - 1 ? tw + p.tw_off[j] : nullptr;
    stage<true>(s, p.m, p.f[j], p.stride[j], twj, roots);
    __syncthreads();
  }
}

// Shared-memory slot of frequency k (0 <= k < M) after forward_fft.
__device__ __forceinline__ int freq_slot(int k, const Plan& p) {
  int pos = 0;
#pragma unroll
  for (int j = 0; j < kMaxStages; ++j) {
    pos += (k & (p.f[j] - 1)) * p.stride[j];
    k >>= p.log2f[j];
  }
  return slot(pos);
}

// Packed spectrum pair (Z[k], Z[M-k]) -> half spectrum pair (X[k], X[M-k])
// of the real row, w = exp(-2 pi i k / N):
//   A = (Z[k] + conj Z[M-k]) / 2, B = w (Z[k] - conj Z[M-k]) / 2i,
//   X[k] = A + B, X[M-k] = conj(A - B).
// k = 0 takes Z[M] = Z[0] and gives X[0] and X[M].
__device__ __forceinline__ void split_pair(float2 zk, float2 zm, float2 w, float2& xk,
                                           float2& xm) {
  const float2 a = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
  const float2 d = make_float2(0.5f * (zk.x - zm.x), 0.5f * (zk.y + zm.y));
  const float2 b = cmul(w, make_float2(d.y, -d.x));
  xk = make_float2(a.x + b.x, a.y + b.y);
  xm = make_float2(a.x - b.x, b.y - a.y);
}

// Inverse of split_pair for a product spectrum: (Y[k], Y[M-k]) -> packed
// (Zc[k], Zc[M-k]) whose inverse M-point DFT (times 1/M) is y[2n] + i y[2n+1]:
//   Ye = (Y[k] + conj Y[M-k]) / 2, Yo = conj(w) (Y[k] - conj Y[M-k]) / 2,
//   Zc[k] = Ye + i Yo, Zc[M-k] = conj(Ye) + i conj(Yo).
__device__ __forceinline__ void unsplit_pair(float2 yk, float2 ym, float2 w, float2& zk,
                                             float2& zm) {
  const float2 e = make_float2(0.5f * (yk.x + ym.x), 0.5f * (yk.y - ym.y));
  const float2 d = make_float2(0.5f * (yk.x - ym.x), 0.5f * (yk.y + ym.y));
  const float2 o = cmul_conj(d, w);
  zk = make_float2(e.x - o.y, e.y + o.x);
  zm = make_float2(e.x + o.y, o.x - e.y);
}

__device__ __forceinline__ void load_roots(float2* roots, const float2* __restrict__ g) {
  if (threadIdx.x < kMaxFactor) roots[threadIdx.x] = g[threadIdx.x];
}

}  // namespace ffc
