// butterfly: the outer stage of the FFT convolution for N >= 65536, forward
// (real in, complex bands out) and inverse (complex bands in, real out).
//
// Replaces the TPU kernel _butterfly_tiles (flashfftconv_tpu/ops/
// monarch_pallas.py, def at l.2074, pallas_call at l.2232), the outer
// butterfly of the 512K-4M pipeline. Here it is the outer stage of every
// conv and spectrum from N = 65536 up, since no block can hold a whole row.
//
// Forward: reads the real row u (rows, L <= N) at f32 or bf16, with the
// implicit zero pad and the optional pregate (the product rounded to u's
// dtype), packs it as the M = N/2 point complex signal z[n] = x[2n] +
// i x[2n+1], views z as (F, R), takes the F-point DFT down every column,
// multiplies by the outer twiddle exp(-2 pi i k0 r / M) and writes the
// bands (rows, F, R) as complex64, band k0 in row k0. Inverse: multiplies by
// the conjugate twiddle, takes the inverse F-point DFT, scales by 1/F,
// unpacks to real samples, applies the optional postgate and writes [0, L).
//
// Design. A block owns a tile of C consecutive columns of all F rows of one
// (b, h) row, so every access to device memory is a contiguous segment (2C
// reals or C complex values a row; C = max(32, 8192 / F), 64 KB of shared
// memory, 128 KB at F = 512). F <= 32 is one in-register line DFT a column.
// A larger F = fa * fb (up to 32 * 16) runs as two stages through shared
// memory: the fa-point DFTs at stride fb, the twiddle exp(-2 pi i ka nb / F)
// from the plan's table of F-th roots, then the fb-point DFTs, which leaves
// band k0 = ka + fa * kb at tile row ka * fb + kb. Rows of zero padding are
// never read. Compiled for three blocks an SM (80 registers): the kernel
// waits on device memory, and more blocks in flight hide that.
//
// Bound on the H100 at B=1, H=256, L=2^20, N=2^21, bf16: as a function each
// direction moves 0.54 GB of reals and 2.1 GB of bands, 0.8 ms at 3.35 TB/s,
// against one 256-point DFT a column in f32 (about 13 GFLOP, 0.2 ms at
// 67 TFLOP/s): bytes. The 8 MB twiddle table is read once a row from L2.

#include "long_common.cuh"

namespace ffc {

struct Outer {
  int f;         // F = fa * fb
  int fa, fb;    // fb == 1: one stage
  int band;      // R
  int cols;      // C, columns of a block's tile
  int log2cols;
  int log2fa;
};

inline bool make_outer(int fa, int fb, int band, Outer* o) {
  auto pow2 = [](int x) { return x >= 1 && (x & (x - 1)) == 0; };
  if (!pow2(fa) || !pow2(fb) || !pow2(band) || fa < 2 || fa > kMaxFactor || fb > kMaxFactor ||
      fa * fb > 512 || band < 32 || (long long)fa * fb * band > (1LL << 21))
    return false;
  o->f = fa * fb;
  o->fa = fa;
  o->fb = fb;
  o->band = band;
  int cols = 8192 / o->f;
  if (cols < 32) cols = 32;
  if (cols > band) cols = band;
  o->cols = cols;
  o->log2cols = ilog2(cols);
  o->log2fa = ilog2(fa);
  return true;
}

inline size_t outer_smem_bytes(const Outer& o) { return (size_t)o.f * o.cols * sizeof(float2); }

// One stage over the (F, C) tile in shared memory: line q holds the points
// base + t * stride, t < FX, base = (q - q % stride) * FX + q % stride.
// With tw (the F-th roots), the first of two stages: point t of the line at
// column group nb = (q % stride) / C is multiplied by exp(-+2 pi i t nb / F),
// after the forward DFT or before the inverse one.
template <int FX, bool INV>
__device__ void outer_lines(float2* s, int points, int stride, int log2cols, int fmask,
                            const float2* __restrict__ tw, const float2* roots) {
  const int lines = points / FX;
  for (int line = threadIdx.x; line < lines; line += blockDim.x) {
    const int r = line & (stride - 1);
    const int base = (line - r) * FX + r;
    const int nb = r >> log2cols;
    float2 v[FX];
#pragma unroll
    for (int t = 0; t < FX; ++t) v[t] = s[base + t * stride];
    if (INV && tw != nullptr) {
#pragma unroll
      for (int t = 0; t < FX; ++t) v[t] = cmul_conj(v[t], __ldg(tw + ((t * nb) & fmask)));
    }
    line_fft<FX, INV>(v, roots);
    if (!INV && tw != nullptr) {
#pragma unroll
      for (int t = 0; t < FX; ++t) v[t] = cmul(v[t], __ldg(tw + ((t * nb) & fmask)));
    }
#pragma unroll
    for (int t = 0; t < FX; ++t) s[base + t * stride] = v[t];
  }
}

template <bool INV>
__device__ __noinline__ void outer_stage(float2* s, int fx, int points, int stride, int log2cols,
                                         int fmask, const float2* __restrict__ tw,
                                         const float2* roots) {
  switch (fx) {
    case 2: outer_lines<2, INV>(s, points, stride, log2cols, fmask, tw, roots); break;
    case 4: outer_lines<4, INV>(s, points, stride, log2cols, fmask, tw, roots); break;
    case 8: outer_lines<8, INV>(s, points, stride, log2cols, fmask, tw, roots); break;
    case 16: outer_lines<16, INV>(s, points, stride, log2cols, fmask, tw, roots); break;
    default: outer_lines<32, INV>(s, points, stride, log2cols, fmask, tw, roots); break;
  }
}

// Tile row that holds band k0 after the forward stages.
__device__ __forceinline__ int band_row(int k0, const Outer& o) {
  return (k0 & (o.fa - 1)) * o.fb + (k0 >> o.log2fa);
}

template <typename T, bool GATED>
__global__ void __launch_bounds__(kThreads, kButterflyMinBlocks)
    butterfly_fwd_kernel(const T* __restrict__ u, const T* __restrict__ pre,
                         float2* __restrict__ out, const float2* __restrict__ outer_tw,
                         const float2* __restrict__ outer_roots,
                         const float2* __restrict__ roots_g, int length, Outer o) {
  extern __shared__ float2 s[];
  __shared__ float2 roots[kMaxFactor];
  const int tiles = o.band >> o.log2cols;
  const int tile = blockIdx.x % tiles;
  const size_t row = blockIdx.x / tiles;
  const int r0 = tile << o.log2cols;
  const int points = o.f << o.log2cols;
  u += row * length;
  if (GATED) pre += row * length;
  out += row * (size_t)o.f * o.band;
  load_roots(roots, roots_g);
  for (int i = threadIdx.x; i < points; i += blockDim.x) {
    const int n1 = i >> o.log2cols;
    const int n = n1 * o.band + r0 + (i & (o.cols - 1));
    s[i] = make_float2(load_real<T, GATED>(u, pre, 2 * n, length),
                       load_real<T, GATED>(u, pre, 2 * n + 1, length));
  }
  __syncthreads();
  const bool two = o.fb > 1;
  outer_stage<false>(s, o.fa, points, o.fb << o.log2cols, o.log2cols, o.f - 1,
                     two ? outer_roots : nullptr, roots);
  __syncthreads();
  if (two) {
    outer_stage<false>(s, o.fb, points, o.cols, o.log2cols, o.f - 1, nullptr, roots);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < points; i += blockDim.x) {
    const int k0 = i >> o.log2cols;
    const int c = i & (o.cols - 1);
    const size_t at = (size_t)k0 * o.band + r0 + c;
    out[at] = cmul(s[(band_row(k0, o) << o.log2cols) + c], __ldg(outer_tw + at));
  }
}

template <typename T, bool GATED>
__global__ void __launch_bounds__(kThreads, kButterflyMinBlocks)
    butterfly_inv_kernel(const float2* __restrict__ z, const T* __restrict__ post,
                         T* __restrict__ out, const float2* __restrict__ outer_tw,
                         const float2* __restrict__ outer_roots,
                         const float2* __restrict__ roots_g, int length, Outer o) {
  extern __shared__ float2 s[];
  __shared__ float2 roots[kMaxFactor];
  const int tiles = o.band >> o.log2cols;
  const int tile = blockIdx.x % tiles;
  const size_t row = blockIdx.x / tiles;
  const int r0 = tile << o.log2cols;
  const int points = o.f << o.log2cols;
  z += row * (size_t)o.f * o.band;
  out += row * length;
  if (GATED) post += row * length;
  load_roots(roots, roots_g);
  for (int i = threadIdx.x; i < points; i += blockDim.x) {
    const int k0 = i >> o.log2cols;
    const int c = i & (o.cols - 1);
    const size_t at = (size_t)k0 * o.band + r0 + c;
    s[(band_row(k0, o) << o.log2cols) + c] = cmul_conj(z[at], __ldg(outer_tw + at));
  }
  __syncthreads();
  const bool two = o.fb > 1;
  if (two) {
    outer_stage<true>(s, o.fb, points, o.cols, o.log2cols, o.f - 1, nullptr, roots);
    __syncthreads();
  }
  outer_stage<true>(s, o.fa, points, o.fb << o.log2cols, o.log2cols, o.f - 1,
                    two ? outer_roots : nullptr, roots);
  __syncthreads();
  const float scale = 1.f / (float)o.f;
  for (int i = threadIdx.x; i < points; i += blockDim.x) {
    const int n1 = i >> o.log2cols;
    const int n = n1 * o.band + r0 + (i & (o.cols - 1));
    if (2 * n >= length) continue;
    const float2 v = s[i];
    store_real<T, GATED>(out, post, 2 * n, length, v.x * scale);
    store_real<T, GATED>(out, post, 2 * n + 1, length, v.y * scale);
  }
}

template <typename T, bool GATED>
cudaError_t launch_fwd(const void* u, const void* pre, void* out, const void* outer_tw,
                       const void* outer_roots, const void* roots, long long rows, int length,
                       const Outer& o, cudaStream_t stream) {
  const size_t smem = outer_smem_bytes(o);
  auto kernel = butterfly_fwd_kernel<T, GATED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(rows * (o.band / o.cols)), kThreads, smem, stream>>>(
      (const T*)u, (const T*)pre, (float2*)out, (const float2*)outer_tw,
      (const float2*)outer_roots, (const float2*)roots, length, o);
  return cudaGetLastError();
}

template <typename T, bool GATED>
cudaError_t launch_inv(const void* z, const void* post, void* out, const void* outer_tw,
                       const void* outer_roots, const void* roots, long long rows, int length,
                       const Outer& o, cudaStream_t stream) {
  const size_t smem = outer_smem_bytes(o);
  auto kernel = butterfly_inv_kernel<T, GATED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(rows * (o.band / o.cols)), kThreads, smem, stream>>>(
      (const float2*)z, (const T*)post, (T*)out, (const float2*)outer_tw,
      (const float2*)outer_roots, (const float2*)roots, length, o);
  return cudaGetLastError();
}

inline bool check_rows(const Outer& o, int rows, int length) {
  return rows >= 1 && length >= 1 && (long long)length <= 2LL * o.f * o.band &&
         (long long)rows * (o.band / o.cols) <= 0x7fffffffLL;
}

}  // namespace ffc

// dtype: 0 = float32, 1 = bfloat16. gate (the pregate) may be null.
// u: (rows, length) reals; out: (rows, fa * fb, band) complex64.
extern "C" int ffc_butterfly_fwd(const void* u, const void* gate, void* out,
                                 const void* outer_tw, const void* outer_roots,
                                 const void* roots, int rows, int length, int fa, int fb,
                                 int band, int dtype, void* stream) {
  ffc::Outer o;
  if (!ffc::make_outer(fa, fb, band, &o) || !ffc::check_rows(o, rows, length))
    return (int)cudaErrorInvalidValue;
  const bool gated = gate != nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 0) {
    err = gated ? ffc::launch_fwd<float, true>(u, gate, out, outer_tw, outer_roots, roots, rows,
                                               length, o, st)
                : ffc::launch_fwd<float, false>(u, gate, out, outer_tw, outer_roots, roots, rows,
                                                length, o, st);
  } else if (dtype == 1) {
    err = gated ? ffc::launch_fwd<__nv_bfloat16, true>(u, gate, out, outer_tw, outer_roots,
                                                       roots, rows, length, o, st)
                : ffc::launch_fwd<__nv_bfloat16, false>(u, gate, out, outer_tw, outer_roots,
                                                        roots, rows, length, o, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// z: (rows, fa * fb, band) complex64; out: (rows, length) reals; gate (the
// postgate) may be null.
extern "C" int ffc_butterfly_inv(const void* z, const void* gate, void* out,
                                 const void* outer_tw, const void* outer_roots,
                                 const void* roots, int rows, int length, int fa, int fb,
                                 int band, int dtype, void* stream) {
  ffc::Outer o;
  if (!ffc::make_outer(fa, fb, band, &o) || !ffc::check_rows(o, rows, length))
    return (int)cudaErrorInvalidValue;
  const bool gated = gate != nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 0) {
    err = gated ? ffc::launch_inv<float, true>(z, gate, out, outer_tw, outer_roots, roots, rows,
                                               length, o, st)
                : ffc::launch_inv<float, false>(z, gate, out, outer_tw, outer_roots, roots, rows,
                                                length, o, st);
  } else if (dtype == 1) {
    err = gated ? ffc::launch_inv<__nv_bfloat16, true>(z, gate, out, outer_tw, outer_roots,
                                                       roots, rows, length, o, st)
                : ffc::launch_inv<__nv_bfloat16, false>(z, gate, out, outer_tw, outer_roots,
                                                        roots, rows, length, o, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

FFC_EXPORT_ERROR_STRING()
