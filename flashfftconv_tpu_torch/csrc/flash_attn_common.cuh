// Device code shared by the flash-attention kernels (flash_attn.cu,
// flash_attn_bwd.cu).
//
// Layout is the JAX package's: q, k, v, o (B, H, L, D) contiguous, the row
// logsumexp (B, H, L) f32, an optional additive f32 bias indexed
// [b * sb + h * sh + i * sq + j] (sb or sh 0 when the bias broadcasts over
// B or H) and optional int32 segment ids (B, L). Scores are
//   s_ij = (q_i . k_j) * scale + bias_ij,
// masked to -inf where j >= L, where causal and j > i, and where the
// segment ids of i and j differ.
//
// Every kernel works on 64 x 64 tiles of the score matrix with 256 threads:
// thread (ty, tx) = (tid / 16, tid % 16) owns rows 4 ty .. 4 ty + 3 and
// columns tx, tx + 16, tx + 32, tx + 48 of a tile, and the same rows and the
// columns tx + 16 j of a (64, D) accumulator. The 16 threads of one ty sit in
// one half-warp, so a row's max and sum are four shuffles. An operand read
// along the rows is kept row-major in shared memory ((64, D), read as float4
// over D, the same address across a half-warp); one read along the columns
// is kept transposed ((D, 65), one pad float a row, so that 16 neighbouring
// columns and 32 neighbouring rows each fall on distinct banks). Shared
// memory holds f32 whatever the operands' dtype; every product and sum is an
// f32 FMA (no tensor cores in this version).
#pragma once

#include "fft_common.cuh"

#include <math.h>
#include <string.h>

namespace ffc {
namespace attn {

constexpr int kTile = 64;       // queries and keys a tile
constexpr int kThreads = 256;   // 16 x 16 threads, a 4 x 4 block of the tile each
constexpr int kTS = kTile + 1;  // row stride of a transposed (D, 64) tile

struct Args {
  int batch, heads, len;
  float scale;
  int causal;
  const float* bias;
  long long bias_sb, bias_sh, bias_sq;
  const int* seg;
};

inline Args make_args(int batch, int heads, int len, int causal, const void* bias, int sb,
                      int sh, int sq, const void* seg, int scale_bits) {
  Args a;
  a.batch = batch;
  a.heads = heads;
  a.len = len;
  // sm_scale arrives as the bits of an f32 (the ctypes interface passes ints)
  memcpy(&a.scale, &scale_bits, sizeof(float));
  a.causal = causal;
  a.bias = (const float*)bias;
  a.bias_sb = sb;
  a.bias_sh = sh;
  a.bias_sq = sq;
  a.seg = (const int*)seg;
  return a;
}

// Rows row0 .. row0 + 63 of a (L, D) slab into a row-major (64, D) f32 tile,
// zeros past L. Neighbouring threads read neighbouring elements.
template <int D, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int row0,
                                          int len) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[e] = row0 + r < len ? to_f(src[(size_t)(row0 + r) * D + d]) : 0.f;
  }
}

// The same rows into a transposed (D, kTS) tile: dst[d * kTS + r].
template <int D, typename T>
__device__ __forceinline__ void load_rows_t(float* dst, const T* __restrict__ src, int row0,
                                            int len) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[d * kTS + r] = row0 + r < len ? to_f(src[(size_t)(row0 + r) * D + d]) : 0.f;
  }
}

// Segment ids of rows row0 .. row0 + 63 (0 for all when there are none;
// `pad` past L, which matches no real id of the other side).
__device__ __forceinline__ void load_seg(int* dst, const Args& a, int b, int row0, int pad) {
  if (threadIdx.x < kTile) {
    const int r = row0 + threadIdx.x;
    dst[threadIdx.x] = a.seg == nullptr ? 0 : (r < a.len ? a.seg[(size_t)b * a.len + r] : pad);
  }
}

// acc[i][j] += sum_d A[4 ty + i][d] * Bt[d][tx + 16 j], A row-major (64, D),
// Bt transposed (D, kTS): the (4, 4) block of a tile A B^T.
template <int D>
__device__ __forceinline__ void tile_abt(float (&acc)[4][4], const float* A, const float* Bt,
                                         int tx, int ty) {
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(A + (4 * ty + i) * D + d);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      float bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bt[(d + dd) * kTS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = dd == 0 ? av[i].x : dd == 1 ? av[i].y : dd == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
      }
    }
  }
}

// acc[i][j] += sum_c P[4 ty + i][c] * Bt[tx + 16 j][c] over the 64 columns of
// a row-major (64, 64) tile P, Bt a transposed (D, kTS) tile: the rows'
// block of P B with B (64, D).
template <int D>
__device__ __forceinline__ void tile_pb_t(float (&acc)[4][D / 16], const float* P,
                                          const float* Bt, int tx, int ty) {
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(P + (4 * ty + i) * kTile + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float bv[D / 16];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) bv[j] = Bt[(tx + 16 * j) * kTS + c + cc];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
        for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(p, bv[j], acc[i][j]);
      }
    }
  }
}

// The same product with B row-major (64, D): bv[j] = B[c][tx + 16 j].
template <int D>
__device__ __forceinline__ void tile_pb(float (&acc)[4][D / 16], const float* P, const float* B,
                                        int tx, int ty) {
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(P + (4 * ty + i) * kTile + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float bv[D / 16];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) bv[j] = B[(c + cc) * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
        for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(p, bv[j], acc[i][j]);
      }
    }
  }
}

// The score of query row r and key column c from its dot product x (already
// summed over D), or -inf where the mask hides it. seg_r and seg_c are the
// pair's segment ids.
__device__ __forceinline__ float score(const Args& a, int b, int h, int r, int c, float x,
                                       int seg_r, int seg_c) {
  if (r >= a.len || c >= a.len || (a.causal && c > r) || seg_r != seg_c) return -INFINITY;
  x *= a.scale;
  if (a.bias != nullptr)
    x += a.bias[b * a.bias_sb + h * a.bias_sh + (long long)r * a.bias_sq + c];
  return x;
}

// Max and sum over the 16 threads of a half-warp (one row of a tile).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace attn
}  // namespace ffc
