// direct_conv: the forward FFT conv of small N as one dense DFT a row.
//
// direct_conv replaces the TPU kernel _direct_fused_io_tiles
// (flashfftconv_tpu/ops/monarch_pallas.py, def at l.477, pallas_call at
// l.540). For FFT sizes N <= 512 (M = N/2) it computes, for every (b, h)
// row of L <= N samples,
//   x = u * pre (rounded to T), U[f] = sum_{t<L} x[t] w^(f t),
//   y[t] = irfft(U K)[t] * post, t < L,     w = exp(-2 pi i / N).
// The TPU kernels multiply (16, N) row tiles by (N, N) DFT matrices on the
// MXU; on the H100 this forward does the same on the tensor cores. The
// backward of the same TPU pair, _direct_bwd_fused_io_tiles (def at
// l.1460, pallas_call at l.1572), runs on the row FFT instead: the wrapper
// direct_conv_bwd (ops/monarch_cuda.py) launches monarch_conv_bwd.cu's
// instances for N <= 512.
//
// direct_conv on the H100: two matrix products a row against DFT tables
// that every channel shares, on mma.sync.m16n8k8 in TF32 (tf32_mma.cuh).
// The input is real, so the half spectrum has N real unknowns: Re U[0],
// Re U[M] and Re, Im U[f] for f = 1 .. M-1. Spectrum column 0 is Re U[0],
// column 1 Re U[M], columns 2f and 2f+1 are Re and Im U[f]:
//   U = X C,  C[t][c] = cos(2 pi f t / N) (c = 2f, and c = 0, 1 with f = 0,
//             M), -sin(2 pi f t / N) (c = 2f + 1), X the (rows, L) input;
//   Y = U K per frequency (columns 0 and 1: the real parts alone, as irfft
//             reads them);
//   y = Y I,  I[c][t] = s_c C[t][c], s_c = 1/N for c = 0, 1, else 2/N.
// Every table entry comes from the exact integer index (f t) mod N and is
// split on the host into TF32 hi and lo (plan.direct_tf32, ops/plan.py),
// laid out fragment by fragment so that a lane reads its {hi b0, hi b1,
// lo b0, lo b1} as one 16-byte word. A bf16 input is exact in TF32, so the
// first product takes two passes (x Chi + x Clo); an f32 input, and Y
// always, three (lo hi + hi lo + hi hi). The tensor cores truncate as they
// accumulate, so each group of 4 k-steps of the first product and each
// 16-column slice of the second is summed apart and added in f32; inside a
// group the hi hi terms and the lo terms go to two accumulators, two
// shorter chains of dependent mma.
//
// A block owns one channel h and RB = 16 W rows of the batch (W warps of 16
// rows, RB = min(128, the rows whose X fits 64 KB, B rounded up to 16)). X
// (the pregated rows, rounded to T, zero past L and past B) is staged once
// in shared memory as T in the A fragments' order. The spectrum is taken 16
// columns (8 frequencies) at a time: U's 16 columns in registers (two C
// fragments), times k_f[h] (in shared memory), split, passed from the C to
// the A fragment by a permutation of the k index (column 2t of a k-step in
// slot t, 2t + 1 in slot t + 4, which the host's I table mirrors), and
// multiplied into y's columns: OT C fragments a warp (OT n-tiles of 8
// samples; OT = 16 up to L = 128, 64 registers, two blocks an SM; OT = 32
// above, 128 registers, one block an SM). L above 8 OT runs in chunks of
// 8 OT output columns, each taking the first product again. The tables
// stream through a three-slot ring of OT KB in shared memory by cp.async
// (the slice of C for OT k-steps, or of I for OT output n-tiles, a slot),
// shared by the block's warps; they are the same for every block and stay
// in L2 (1 MB at N = 256). Ragged B and L read zeros from X and from the
// tables' rows and columns past L, and are never stored.
//
// Bound on the H100, for the function (the same conv by FFTs): operations.
// At the M2-BERT shape (B=128, H=768, L=128, N=256, bf16) it reads 25 MB
// and writes 25 MB (15 us at 3.35 TB/s) and needs about 1.3 GFLOP of f32
// FFT operations (20 us at 67 TFLOP/s). This design's dense products are
// 2 rows L N multiply-adds (12.9 GFLOP), 39 GFLOP in three split passes:
// 78 us at 494.7 TFLOP/s (tc_bound in chip_smoke.py).

#include <algorithm>

#include "fft_common.cuh"
#include "tf32_mma.cuh"

namespace ffc {
namespace direct {

struct Dims {
  int batch, channels, length;
  int n, m;  // N and M = N / 2
};

// ---- direct_conv on the tensor cores ---------------------------------------

constexpr int kTcMaxRows = 128;       // rows of a block (8 warps of 16)
constexpr int kTcXBytes = 64 * 1024;  // X's share of shared memory
constexpr int kTcSlots = 3;           // ring slots of `tiles` KB
constexpr int kTcCols = 16;           // spectrum columns a step (8 frequencies)
constexpr int kTcGroup = 4;           // k-steps summed apart in the first product

struct TcDims {
  int batch, channels, length, n, m;
  int rows;       // RB
  int ksteps;     // ceil(L / 8): k-steps of the first product, n-tiles of y
  int tiles;      // OT: y's n-tiles a chunk; k-steps or n-tiles (1 KB each) a slot
  int fwd_tiles;  // ring slots of C a spectrum step: ceil(ksteps / tiles)
};

inline size_t tc_smem_bytes(const TcDims& d, size_t elem) {
  return (size_t)d.rows * d.ksteps * 8 * elem + (size_t)kTcSlots * d.tiles * 1024 +
         (size_t)(d.m + 1) * sizeof(float2);
}

// The A fragment of k-step kk of the warp's rows from X (fragment order).
template <typename T>
__device__ __forceinline__ void x_frag(uint32_t (&hi)[4], uint32_t (&lo)[4], const T* xs,
                                       int kk, int lane);
template <>
__device__ __forceinline__ void x_frag<float>(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                              const float* xs, int kk, int lane) {
  const float4 v = reinterpret_cast<const float4*>(xs)[kk * 32 + lane];
  split_tf32<true>(v.x, hi[0], lo[0]);
  split_tf32<true>(v.y, hi[1], lo[1]);
  split_tf32<true>(v.z, hi[2], lo[2]);
  split_tf32<true>(v.w, hi[3], lo[3]);
}
template <>
__device__ __forceinline__ void x_frag<__nv_bfloat16>(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                                      const __nv_bfloat16* xs, int kk,
                                                      int lane) {
  const uint2 v = reinterpret_cast<const uint2*>(xs)[kk * 32 + lane];
  hi[0] = v.x << 16;
  hi[1] = v.x & 0xffff0000u;
  hi[2] = v.y << 16;
  hi[3] = v.y & 0xffff0000u;
  lo[0] = lo[1] = lo[2] = lo[3] = 0u;
}

// big += a_hi b_hi and small += the lo terms (a_lo b_hi when a is split,
// a_hi b_lo): two shorter chains of dependent mma than mma_split's one.
template <bool kSplitA>
__device__ __forceinline__ void mma_split_apart(float (&big)[4], float (&small)[4],
                                                const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                                const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  if (kSplitA) mma_tf32(small, al, bh);
  mma_tf32(small, ah, bl);
  mma_tf32(big, ah, bh);
}

// The ring's tile i: which slice of which table, and how many KB.
struct TcTile {
  const float* src;
  int kb;
};

__device__ __forceinline__ TcTile tc_tile(int i, const float* fwd, const float* inv,
                                          const TcDims& d) {
  const int per = d.fwd_tiles + 1, chunks = d.n / kTcCols, tiles_n = d.n / 8;
  const int tc = i / (chunks * per), rem = i - tc * chunks * per;
  const int fc = rem / per, q = rem - fc * per;
  if (q < d.fwd_tiles)
    return {fwd + ((size_t)fc * tiles_n + q * d.tiles) * 256,
            min(d.tiles, d.ksteps - q * d.tiles)};
  return {inv + ((size_t)fc * tiles_n + tc * d.tiles) * 256,
          min(d.tiles, d.ksteps - tc * d.tiles)};
}

__device__ __forceinline__ void tc_fetch(float* ring, int i, int total, const float* fwd,
                                         const float* inv, const TcDims& d) {
  if (i < total) {
    const TcTile tl = tc_tile(i, fwd, inv, d);
    float* dst = ring + (i % kTcSlots) * d.tiles * 256;
    for (int c = threadIdx.x; c < tl.kb * 64; c += blockDim.x)
      cp_async16(dst + c * 4, tl.src + c * 4);
  }
  cp_async_commit();
}

// Wait for tile i, then start tile i + kTcSlots - 1 into the slot that
// tile i - 1 used (every warp is past it after the barrier).
__device__ __forceinline__ const float4* tc_next(float* ring, int i, int total, const float* fwd,
                                                 const float* inv, const TcDims& d) {
  cp_async_wait<kTcSlots - 2>();
  __syncthreads();
  tc_fetch(ring, i + kTcSlots - 1, total, fwd, inv, d);
  return reinterpret_cast<const float4*>(ring + (i % kTcSlots) * d.tiles * 256);
}

template <typename T, bool GATED, int OT>
__global__ void __launch_bounds__(kTcMaxRows * 2, OT == 16 ? 2 : 1)
    direct_conv_tc_kernel(const T* __restrict__ u, const T* __restrict__ pre,
                          const T* __restrict__ post, const float2* __restrict__ k_f,
                          T* __restrict__ out, const float* __restrict__ tables, TcDims d) {
  constexpr bool kSplitX = sizeof(T) == 4;
  extern __shared__ float4 smem4[];
  T* xs = reinterpret_cast<T*>(smem4);
  float* ring = reinterpret_cast<float*>(xs + (size_t)d.rows * d.ksteps * 8);
  float2* kf = reinterpret_cast<float2*>(ring + kTcSlots * OT * 256);
  const float* fwd = tables;
  const float* inv = tables + (size_t)2 * d.n * d.n;
  const int h = blockIdx.x, b0 = blockIdx.y * d.rows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = d.n / kTcCols;
  const int tchunks = (d.ksteps + OT - 1) / OT;
  const int total = tchunks * chunks * (d.fwd_tiles + 1);
  for (int i = 0; i < kTcSlots - 1; ++i) tc_fetch(ring, i, total, fwd, inv, d);

  // X in the A fragments' order: element (r, t) of m-tile r / 16 at
  // [(m-tile, k-step t / 8), lane, e] with lane = 4 (r % 8) + t % 4 and
  // e = (r % 16) / 8 + 2 ((t % 8) / 4).
  for (int f = threadIdx.x; f <= d.m; f += blockDim.x) kf[f] = k_f[(size_t)h * (d.m + 1) + f];
  const int lp = d.ksteps * 8;
  for (int i = threadIdx.x; i < d.rows * lp; i += blockDim.x) {
    const int r = i / lp, t = i - r * lp, b = b0 + r;
    float v = 0.f;
    if (t < d.length && b < d.batch) {
      const size_t at = ((size_t)b * d.channels + h) * d.length + t;
      v = to_f(u[at]);
      if (GATED) v = to_f(from_f<T>(v * to_f(pre[at])));
    }
    const int rr = r & 15, tt = t & 7;
    const int slot = (((r >> 4) * d.ksteps + (t >> 3)) * 32 + (rr & 7) * 4 + (tt & 3)) * 4 +
                     (rr >> 3) + 2 * (tt >> 2);
    xs[slot] = from_f<T>(v);
  }
  const T* xw = xs + (size_t)warp * d.ksteps * 32 * 4;
  const int g = lane >> 2, tq = lane & 3;

  int tile = 0;
  for (int tc = 0; tc < tchunks; ++tc) {
    const int ntiles = min(OT, d.ksteps - tc * OT);
    float y[OT][4];
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[j][e] = 0.f;
#pragma unroll 1
    for (int fc = 0; fc < chunks; ++fc) {
      // U's 16 columns: the first product over the k-steps, OT a slot.
      float uc[2][4] = {};
#pragma unroll 1
      for (int q = 0; q < d.fwd_tiles; ++q, ++tile) {
        const float4* cs = tc_next(ring, tile, total, fwd, inv, d);
        const int nk = min(OT, d.ksteps - q * OT);
#pragma unroll 1
        for (int k0 = 0; k0 < nk; k0 += kTcGroup) {
          float big[2][4] = {}, small[2][4] = {};
#pragma unroll
          for (int c = 0; c < kTcGroup; ++c) {
            if (k0 + c < nk) {
              uint32_t ah[4], al[4];
              x_frag<T>(ah, al, xw, q * OT + k0 + c, lane);
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                const float4 bv = cs[((k0 + c) * 2 + nt) * 32 + lane];
                const uint32_t bh[2] = {__float_as_uint(bv.x), __float_as_uint(bv.y)};
                const uint32_t bl[2] = {__float_as_uint(bv.z), __float_as_uint(bv.w)};
                mma_split_apart<kSplitX>(big[nt], small[nt], ah, al, bh, bl);
              }
            }
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) uc[nt][e] += big[nt][e] + small[nt][e];
        }
      }
      // Y = U K, columns (2f, 2f+1) of a C fragment: (Re, Im) of frequency
      // f = 8 fc + 4 nt + tq (f = 0: Re U[0] and Re U[M]); then the A
      // fragments of Y, column 2 tq in slot tq, 2 tq + 1 in slot tq + 4.
      uint32_t yh[2][4], yl[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int f = fc * 8 + nt * 4 + tq;
        float c[4];
        if (f == 0) {
          const float k0r = kf[0].x, kmr = kf[d.m].x;
          c[0] = uc[nt][0] * k0r;
          c[1] = uc[nt][1] * kmr;
          c[2] = uc[nt][2] * k0r;
          c[3] = uc[nt][3] * kmr;
        } else {
          const float2 k = kf[f];
          c[0] = uc[nt][0] * k.x - uc[nt][1] * k.y;
          c[1] = uc[nt][0] * k.y + uc[nt][1] * k.x;
          c[2] = uc[nt][2] * k.x - uc[nt][3] * k.y;
          c[3] = uc[nt][2] * k.y + uc[nt][3] * k.x;
        }
        split_tf32<true>(c[0], yh[nt][0], yl[nt][0]);
        split_tf32<true>(c[2], yh[nt][1], yl[nt][1]);
        split_tf32<true>(c[1], yh[nt][2], yl[nt][2]);
        split_tf32<true>(c[3], yh[nt][3], yl[nt][3]);
      }
      // y += Y I over this step's 16 columns, each output n-tile apart.
      const float4* is = tc_next(ring, tile++, total, fwd, inv, d);
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        if (j < ntiles) {
          float big[4] = {}, small[4] = {};
#pragma unroll
          for (int st = 0; st < 2; ++st) {
            const float4 bv = is[(j * 2 + st) * 32 + lane];
            const uint32_t bh[2] = {__float_as_uint(bv.x), __float_as_uint(bv.y)};
            const uint32_t bl[2] = {__float_as_uint(bv.z), __float_as_uint(bv.w)};
            mma_split_apart<true>(big, small, yh[st], yl[st], bh, bl);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) y[j][e] += big[e] + small[e];
        }
      }
    }
    // y's C fragments: rows g and g + 8 of the warp, samples 2 tq and 2 tq + 1.
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      if (j < ntiles) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = b0 + warp * 16 + g + 8 * (e >> 1);
          const int t = (tc * OT + j) * 8 + 2 * tq + (e & 1);
          if (b < d.batch && t < d.length) {
            const size_t at = ((size_t)b * d.channels + h) * d.length + t;
            out[at] = from_f<T>(GATED ? y[j][e] * to_f(post[at]) : y[j][e]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
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
  return true;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// RB: 128 rows, fewer where X would pass kTcXBytes, or where the batch is
// smaller (rounded up to a warp's 16).
inline bool make_tc_dims(const Dims& d, size_t elem, TcDims* t) {
  t->batch = d.batch;
  t->channels = d.channels;
  t->length = d.length;
  t->n = d.n;
  t->m = d.m;
  t->ksteps = (d.length + 7) / 8;
  t->tiles = t->ksteps > 16 ? 32 : 16;
  t->fwd_tiles = (t->ksteps + t->tiles - 1) / t->tiles;
  const int fit = (int)(kTcXBytes / ((size_t)t->ksteps * 8 * elem)) / 16 * 16;
  t->rows = std::min(std::min(kTcMaxRows, fit), (d.batch + 15) / 16 * 16);
  return t->rows >= 16 && (d.batch + t->rows - 1) / t->rows <= 65535;
}

template <typename T>
cudaError_t run_fwd(const void* u, const void* pre, const void* post, const void* k_f, void* out,
                    const void* tables, const Dims& dims, cudaStream_t stream) {
  TcDims d;
  if (!make_tc_dims(dims, sizeof(T), &d)) return cudaErrorInvalidValue;
  const size_t smem = tc_smem_bytes(d, sizeof(T));
  const dim3 grid(d.channels, (d.batch + d.rows - 1) / d.rows);
  auto kernel = pre != nullptr ? (d.tiles == 16 ? direct_conv_tc_kernel<T, true, 16>
                                                : direct_conv_tc_kernel<T, true, 32>)
                                : (d.tiles == 16 ? direct_conv_tc_kernel<T, false, 16>
                                                 : direct_conv_tc_kernel<T, false, 32>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, d.rows * 2, smem, stream>>>((const T*)u, (const T*)pre, (const T*)post,
                                             (const float2*)k_f, (T*)out, (const float*)tables, d);
  return cudaGetLastError();
}

}  // namespace direct
}  // namespace ffc

// dtype: 0 = float32, 1 = bfloat16. pre and post are both null or both set.
// tables: the plan's direct_tf32, the C and I tables in TF32 hi and lo.
extern "C" int ffc_direct_conv(const void* u, const void* pre, const void* post, const void* k_f,
                               void* out, const void* tables, int batch, int channels, int length,
                               int n, int dtype, void* stream) {
  ffc::direct::Dims d;
  if (!ffc::direct::make_dims(batch, channels, length, n, &d) ||
      (pre == nullptr) != (post == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)ffc::direct::run_fwd<float>(u, pre, post, k_f, out, tables, d, s);
  if (dtype == 1)
    return (int)ffc::direct::run_fwd<__nv_bfloat16>(u, pre, post, k_f, out, tables, d, s);
  return (int)cudaErrorInvalidValue;
}

FFC_EXPORT_ERROR_STRING()
