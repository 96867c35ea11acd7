// Device code shared by the attention kernels: the flash-attention kernels
// (flash_attn.cu, flash_attn_bwd.cu) and the splash-attention kernels
// (splash_attn.cu, splash_attn_bwd.cu).
//
// Layout is the JAX package's: q, k, v, o (B, H, L, D) contiguous and the
// row logsumexp (B, H, L) f32. Scores are s_ij = (q_i . k_j) * scale, plus a
// bias where the mask has one, and -inf where the mask hides (i, j).
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
//
// The three kernel bodies (attn_fwd, attn_bwd_dkv, attn_bwd_dq, below) are
// written once over a mask policy, the kernel's parameter, which says which
// tiles a block visits and which scores of a visited tile it keeps:
//   load_seg(dst, b, row0, pad)   a tile's segment ids into shared memory
//   n_kv(qt), kv_tile(qt, n, full)  the key tiles query tile qt visits, in
//                                 order, each flagged full (no element masked)
//   n_q(kt), q_tile(kt, n, full)  the query tiles key tile kt visits
//   score(b, h, r, c, x, full, seg_r, seg_c)  the score of row r, column c
//                                 from the dot product x (seg_r, seg_c their
//                                 segment ids)
// A tile that no list names is never loaded or computed. FlashMask is
// flash_mha's mask (every tile, or the causal half; segment ids; a bias).
// SplashMask is the splash kernels' (a sliding window, or a table of the
// tiles a block mask keeps, built by ops/splash_mask.py).
//
// Rows that see no key keep m = -inf and l = 0: their output is 0 and their
// logsumexp +inf, so the backward's p = exp(s - lse) is 0 and they add 0 to
// every grad.
#pragma once

#include "fft_common.cuh"

#include <math.h>
#include <string.h>

namespace ffc {
namespace attn {

constexpr int kTile = 64;       // queries and keys a tile
constexpr int kThreads = 256;   // 16 x 16 threads, a 4 x 4 block of the tile each
constexpr int kTS = kTile + 1;  // row stride of a transposed (D, 64) tile

// sm_scale arrives as the bits of an f32 (the ctypes interface passes ints)
inline float scale_from_bits(int bits) {
  float s;
  memcpy(&s, &bits, sizeof(float));
  return s;
}

// flash_mha's mask: every key tile, or under causal those up to the
// diagonal; an optional additive f32 bias indexed
// [b * bias_sb + h * bias_sh + i * bias_sq + j] (sb or sh 0 when the bias
// broadcasts over B or H); optional int32 segment ids (B, L): a pair with
// other ids is masked.
struct FlashMask {
  int batch, heads, len, n_tiles;
  float scale;
  int causal;
  const float* bias;
  long long bias_sb, bias_sh, bias_sq;
  const int* seg;

  // Segment ids of rows row0 .. row0 + 63 (0 for all when there are none;
  // `pad` past L, which matches no real id of the other side).
  __device__ __forceinline__ void load_seg(int* dst, int b, int row0, int pad) const {
    if (threadIdx.x < kTile) {
      const int r = row0 + threadIdx.x;
      dst[threadIdx.x] = seg == nullptr ? 0 : (r < len ? seg[(size_t)b * len + r] : pad);
    }
  }
  __device__ __forceinline__ int n_kv(int qt) const { return causal ? qt + 1 : n_tiles; }
  __device__ __forceinline__ int kv_tile(int, int n, bool& full) const {
    full = false;
    return n;
  }
  __device__ __forceinline__ int n_q(int kt) const { return causal ? n_tiles - kt : n_tiles; }
  __device__ __forceinline__ int q_tile(int kt, int n, bool& full) const {
    full = false;
    return causal ? kt + n : n;
  }
  __device__ __forceinline__ float score(int b, int h, int r, int c, float x, bool, int seg_r,
                                         int seg_c) const {
    if (r >= len || c >= len || (causal && c > r) || seg_r != seg_c) return -INFINITY;
    x *= scale;
    if (bias != nullptr) x += bias[b * bias_sb + h * bias_sh + (long long)r * bias_sq + c];
    return x;
  }
};

inline FlashMask make_flash_mask(int batch, int heads, int len, int causal, const void* bias,
                                 int sb, int sh, int sq, const void* seg, int scale_bits) {
  FlashMask m = {};
  m.batch = batch;
  m.heads = heads;
  m.len = len;
  m.n_tiles = (len + kTile - 1) / kTile;
  m.scale = scale_from_bits(scale_bits);
  m.causal = causal;
  m.bias = (const float*)bias;
  m.bias_sb = sb;
  m.bias_sh = sh;
  m.bias_sq = sq;
  m.seg = (const int*)seg;
  return m;
}

// The splash kernels' mask, one for every (b, h) as the JAX package gives
// every head the same mask. Either
//  - a sliding window (window > 0, at most L): row i keeps columns
//    i - window < j <= i. Query tile t visits key tiles
//    max(0, 64 t - window + 1) / 64 .. t, key tile t query tiles
//    t .. min(n_tiles - 1, (64 t + 62 + window) / 64), and a tile (tq, tk)
//    is full when tk < tq and 64 tk >= 64 tq + 64 - window: ranges computed,
//    no table; or
//  - a block mask (window 0): `blocks` (n_blocks, n_blocks) 0/1 bytes at
//    block_size, causal or not, with the table ops/splash_mask.py builds:
//    for each query tile the compact list of key tiles that hold a kept
//    element (fwd_ptr, fwd_idx) and for each key tile the query tiles
//    (bwd_ptr, bwd_idx); an entry is 2 tile + full.
// An element of a tile that is not full is tested against the predicate.
struct SplashMask {
  int batch, heads, len, n_tiles;
  float scale;
  int window;
  const int *fwd_ptr, *fwd_idx, *bwd_ptr, *bwd_idx;
  const unsigned char* blocks;
  int block_size, n_blocks, causal;

  __device__ __forceinline__ void load_seg(int*, int, int, int) const {}
  __device__ __forceinline__ int window_kv_lo(int qt) const {
    return max(0, qt * kTile - window + 1) / kTile;
  }
  __device__ __forceinline__ bool window_full(int qt, int kt) const {
    return kt < qt && kt * kTile >= qt * kTile + kTile - window;
  }
  __device__ __forceinline__ int n_kv(int qt) const {
    return window > 0 ? qt - window_kv_lo(qt) + 1 : fwd_ptr[qt + 1] - fwd_ptr[qt];
  }
  __device__ __forceinline__ int kv_tile(int qt, int n, bool& full) const {
    if (window > 0) {
      const int kt = window_kv_lo(qt) + n;
      full = window_full(qt, kt);
      return kt;
    }
    const int e = fwd_idx[fwd_ptr[qt] + n];
    full = e & 1;
    return e >> 1;
  }
  __device__ __forceinline__ int n_q(int kt) const {
    if (window > 0) return min(n_tiles - 1, (kt * kTile + kTile - 2 + window) / kTile) - kt + 1;
    return bwd_ptr[kt + 1] - bwd_ptr[kt];
  }
  __device__ __forceinline__ int q_tile(int kt, int n, bool& full) const {
    if (window > 0) {
      const int qt = kt + n;
      full = window_full(qt, kt);
      return qt;
    }
    const int e = bwd_idx[bwd_ptr[kt] + n];
    full = e & 1;
    return e >> 1;
  }
  __device__ __forceinline__ bool keeps(int r, int c) const {
    if (window > 0) return c <= r && c > r - window;
    return (!causal || c <= r) && blocks[(r / block_size) * n_blocks + c / block_size];
  }
  __device__ __forceinline__ float score(int, int, int r, int c, float x, bool full, int,
                                         int) const {
    if (!full && (r >= len || c >= len || !keeps(r, c))) return -INFINITY;
    return x * scale;
  }
};

// The table is one int32 array: fwd_ptr (n_tiles + 1), fwd_idx (n_entries),
// bwd_ptr (n_tiles + 1), bwd_idx (n_entries).
inline SplashMask make_splash_mask(int batch, int heads, int len, int window, const void* table,
                                   const void* blocks, int block_size, int n_blocks,
                                   int n_entries, int causal, int scale_bits) {
  SplashMask m = {};
  m.batch = batch;
  m.heads = heads;
  m.len = len;
  m.n_tiles = (len + kTile - 1) / kTile;
  m.scale = scale_from_bits(scale_bits);
  m.window = window;
  if (window == 0) {
    m.fwd_ptr = (const int*)table;
    m.fwd_idx = m.fwd_ptr + m.n_tiles + 1;
    m.bwd_ptr = m.fwd_idx + n_entries;
    m.bwd_idx = m.bwd_ptr + m.n_tiles + 1;
  }
  m.blocks = (const unsigned char*)blocks;
  m.block_size = block_size;
  m.n_blocks = n_blocks;
  m.causal = causal;
  return m;
}

// The sizes the splash kernels take: a window in 1 .. L, or a table and a
// block mask that tiles L.
inline bool splash_args_ok(int batch, int heads, int len, int window, const void* table,
                           const void* blocks, int block_size, int n_blocks) {
  if (batch < 1 || heads < 1 || len < 1 || batch * heads > 65535) return false;
  if (window != 0) return window >= 1 && window <= len;
  return table != nullptr && blocks != nullptr && block_size >= 1 &&
         (long long)block_size * n_blocks == len;
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

// --- the kernel bodies, over a mask policy ---------------------------------

template <int D>
constexpr size_t fwd_smem_bytes() {
  return (2 * kTile * D + D * kTS + kTile * kTile) * sizeof(float);  // Qs, Vs, Kt, Ps
}
template <int D>
constexpr size_t bwd_dkv_smem_bytes() {
  return (2 * kTile * D + 2 * D * kTS + 2 * kTile * kTile) * sizeof(float);
}
// one (64, 64) tile of shared memory fewer than the dK/dV body: ds only
template <int D>
constexpr size_t bwd_dq_smem_bytes() {
  return bwd_dkv_smem_bytes<D>() - kTile * kTile * sizeof(float);
}

// The forward: one block owns (b, h, a tile of 64 queries); the query tile
// stays in shared memory while the block walks the key tiles its mask names,
// each K tile transposed and each V tile row-major in shared memory. Scores,
// the online softmax (running max m and sum l a row, rescaling the
// accumulator by exp(m_old - m_new)) and the (64, D) accumulator live in
// registers, f32 throughout. Query tiles run last first (under causal the
// heaviest first). Writes o and the logsumexp m + log(l).
template <int D, typename T, typename Mask>
__device__ __forceinline__ void attn_fwd(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, T* __restrict__ o,
                                         float* __restrict__ lse, const Mask& m) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // (64, D) queries, row-major
  float* Vs = Qs + kTile * D;                    // (64, D) values, row-major
  float* Kt = Vs + kTile * D;                    // (D, kTS) keys, transposed
  float* Ps = Kt + D * kTS;                      // (64, 64) probabilities, row-major
  __shared__ int seg_q[kTile], seg_k[kTile];

  const int len = m.len;
  const int qt = m.n_tiles - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / m.heads, h = bh % m.heads;
  const size_t base = (size_t)bh * len * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = qt * kTile;

  load_rows<D>(Qs, q + base, q0, len);
  m.load_seg(seg_q, b, q0, -1);

  float acc[4][D / 16];
  float mx_run[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mx_run[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  const int n_kv = m.n_kv(qt);
  for (int n = 0; n < n_kv; ++n) {
    bool full;
    const int k0 = m.kv_tile(qt, n, full) * kTile;
    __syncthreads();  // the previous tile's Kt, Vs and Ps are read
    load_rows_t<D>(Kt, k + base, k0, len);
    load_rows<D>(Vs, v + base, k0, len);
    m.load_seg(seg_k, b, k0, -2);
    __syncthreads();

    float s[4][4] = {};
    tile_abt<D>(s, Qs, Kt, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = m.score(b, h, q0 + rl, k0 + tx + 16 * j, s[i][j], full, seg_q[rl],
                          seg_k[tx + 16 * j]);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(mx_run[i], row_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(mx_run[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(sum);
      mx_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[rl * kTile + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
    tile_pb<D>(acc, Ps, Vs, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= len) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) o[base + (size_t)r * D + tx + 16 * j] = from_f<T>(acc[i][j] * inv);
    if (tx == 0) lse[(size_t)bh * len + r] = l[i] > 0.f ? mx_run[i] + logf(l[i]) : INFINITY;
  }
}

// Rows q0 .. q0 + 63 of the row statistics (lse +inf and delta 0 past L, so
// that padded rows give p = 0).
__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta, size_t row_base,
                                           int q0, int len) {
  if (threadIdx.x < kTile) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < len ? lse[row_base + r] : INFINITY;
    delta_s[threadIdx.x] = r < len ? delta[row_base + r] : 0.f;
  }
}

// The backward recomputes p = exp(s - lse) from the forward's row
// logsumexp and takes delta = rowsum(do * o) (f32 (B, H, L)) from the
// wrapper. With dp = do v^T and ds = p * (dp - delta):
//   dv = p^T do,   dk = ds^T q * scale,   dq = ds k * scale,   dbias = ds.
//
// dK/dV: one block owns (b, h, a tile of 64 keys) and walks the query tiles
// its mask names, with K and V row-major and each Q and dO tile transposed
// in shared memory; it computes the transposed score tile s^T and dp^T,
// writes p^T and ds^T to shared memory and accumulates dv and dk in
// registers.
template <int D, typename T, typename Mask>
__device__ __forceinline__ void attn_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
                                             const T* __restrict__ v,
                                             const T* __restrict__ dout,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta,
                                             T* __restrict__ dk, T* __restrict__ dv,
                                             const Mask& m) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // (64, D) keys, row-major
  float* Vs = Ks + kTile * D;                    // (64, D) values, row-major
  float* Qt = Vs + kTile * D;                    // (D, kTS) queries, transposed
  float* dOt = Qt + D * kTS;                     // (D, kTS) output grads, transposed
  float* Pt = dOt + D * kTS;                     // (64 keys, 64 queries) p^T
  float* dSt = Pt + kTile * kTile;               // (64 keys, 64 queries) ds^T
  __shared__ int seg_q[kTile], seg_k[kTile];
  __shared__ float lse_s[kTile], delta_s[kTile];

  const int len = m.len;
  const int kt = blockIdx.x;
  const int bh = blockIdx.y, b = bh / m.heads, h = bh % m.heads;
  const size_t base = (size_t)bh * len * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = kt * kTile;

  load_rows<D>(Ks, k + base, k0, len);
  load_rows<D>(Vs, v + base, k0, len);
  m.load_seg(seg_k, b, k0, -2);

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_q = m.n_q(kt);
  for (int n = 0; n < n_q; ++n) {
    bool full;
    const int q0 = m.q_tile(kt, n, full) * kTile;
    __syncthreads();  // the previous tile's Qt, dOt, Pt and dSt are read
    load_rows_t<D>(Qt, q + base, q0, len);
    load_rows_t<D>(dOt, dout + base, q0, len);
    m.load_seg(seg_q, b, q0, -1);
    load_stats(lse_s, delta_s, lse, delta, (size_t)bh * len, q0, len);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_abt<D>(s, Ks, Qt, tx, ty);   // s^T[key][query]
    tile_abt<D>(dp, Vs, dOt, tx, ty);  // dp^T[key][query]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int cl = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rl = tx + 16 * j;
        const float x = m.score(b, h, q0 + rl, k0 + cl, s[i][j], full, seg_q[rl], seg_k[cl]);
        const float p = x == -INFINITY ? 0.f : expf(x - lse_s[rl]);
        Pt[cl * kTile + rl] = p;
        dSt[cl * kTile + rl] = p * (dp[i][j] - delta_s[rl]);
      }
    }
    __syncthreads();
    tile_pb_t<D>(dv_acc, Pt, dOt, tx, ty);
    tile_pb_t<D>(dk_acc, dSt, Qt, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + 4 * ty + i;
    if (c >= len) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const size_t at = base + (size_t)c * D + tx + 16 * j;
      dk[at] = from_f<T>(dk_acc[i][j] * m.scale);
      dv[at] = from_f<T>(dv_acc[i][j]);
    }
  }
}

// dQ: one block owns (b, h, a tile of 64 queries) and walks the key tiles
// its mask names, with Q and dO row-major and each K and V tile transposed;
// it accumulates dq in registers and, when ds_out is given, writes ds to a
// (B, H, L, L) f32 buffer (the flash kernels' bias grad).
template <int D, typename T, typename Mask>
__device__ __forceinline__ void attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                                            const T* __restrict__ v, const T* __restrict__ dout,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta, T* __restrict__ dq,
                                            float* __restrict__ ds_out, const Mask& m) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // (64, D) queries, row-major
  float* dOs = Qs + kTile * D;                   // (64, D) output grads, row-major
  float* Kt = dOs + kTile * D;                   // (D, kTS) keys, transposed
  float* Vt = Kt + D * kTS;                      // (D, kTS) values, transposed
  float* dSs = Vt + D * kTS;                     // (64 queries, 64 keys) ds
  __shared__ int seg_q[kTile], seg_k[kTile];
  __shared__ float lse_s[kTile], delta_s[kTile];

  const int len = m.len;
  const int qt = m.n_tiles - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / m.heads, h = bh % m.heads;
  const size_t base = (size_t)bh * len * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = qt * kTile;

  load_rows<D>(Qs, q + base, q0, len);
  load_rows<D>(dOs, dout + base, q0, len);
  m.load_seg(seg_q, b, q0, -1);
  load_stats(lse_s, delta_s, lse, delta, (size_t)bh * len, q0, len);

  float dq_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dq_acc[i][j] = 0.f;

  const int n_kv = m.n_kv(qt);
  for (int n = 0; n < n_kv; ++n) {
    bool full;
    const int k0 = m.kv_tile(qt, n, full) * kTile;
    __syncthreads();  // the previous tile's Kt, Vt and dSs are read
    load_rows_t<D>(Kt, k + base, k0, len);
    load_rows_t<D>(Vt, v + base, k0, len);
    m.load_seg(seg_k, b, k0, -2);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_abt<D>(s, Qs, Kt, tx, ty);
    tile_abt<D>(dp, dOs, Vt, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = 4 * ty + i, r = q0 + rl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j, c = k0 + cl;
        const float x = m.score(b, h, r, c, s[i][j], full, seg_q[rl], seg_k[cl]);
        const float p = x == -INFINITY ? 0.f : expf(x - lse_s[rl]);
        const float ds = p * (dp[i][j] - delta_s[rl]);
        dSs[rl * kTile + cl] = ds;
        if (ds_out != nullptr && r < len && c < len)
          ds_out[((size_t)bh * len + r) * len + c] = ds;
      }
    }
    __syncthreads();
    tile_pb_t<D>(dq_acc, dSs, Kt, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= len) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dq[base + (size_t)r * D + tx + 16 * j] = from_f<T>(dq_acc[i][j] * m.scale);
  }
}

// --- launching ---------------------------------------------------------------

template <int D>
struct HeadDim {
  static constexpr int value = D;
};

// f(HeadDim<D>{}, T{}) for the operands' head_dim (64 or 128) and dtype (f32
// or bf16); an invalid value for any other.
template <typename F>
cudaError_t dispatch(int head_dim, int is_bf16, F f) {
  if (head_dim == 64) return is_bf16 ? f(HeadDim<64>{}, __nv_bfloat16{}) : f(HeadDim<64>{}, 0.f);
  if (head_dim == 128)
    return is_bf16 ? f(HeadDim<128>{}, __nv_bfloat16{}) : f(HeadDim<128>{}, 0.f);
  return cudaErrorInvalidValue;
}

// kernel on the (tiles of L, B * H) grid of 256 threads with `smem` bytes of
// dynamic shared memory, its arguments cast to the kernel's own types.
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), size_t smem, int len, int batch_heads,
                   cudaStream_t stream, A... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((len + kTile - 1) / kTile, batch_heads), kThreads, smem, stream>>>(
      ((P)args)...);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace ffc
