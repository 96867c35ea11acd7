// Device code shared by the attention kernels: the flash-attention kernels
// (flash_attn.cu, flash_attn_bwd.cu) and the splash-attention kernels
// (splash_attn.cu, splash_attn_bwd.cu).
//
// Layout is the JAX package's: q, k, v, o (B, H, L, D) contiguous and the
// row logsumexp (B, H, L) f32. Scores are s_ij = (q_i . k_j) * scale, plus a
// bias where the mask has one, and -inf where the mask hides (i, j).
//
// Every kernel works on 64 x 64 tiles of the score matrix. A block owns one
// tile of 64 rows of one (b, h): blockIdx.x is the tile and (b, h) is
// blockIdx.y + gridDim.y * blockIdx.z (block_bh), so that B * H may exceed
// the 65535 of one grid dimension. Shared memory holds f32 whatever the
// operands' dtype; softmax statistics and every sum are f32.
//
// The forward (attn_fwd) runs on the CUDA cores, every product an f32 FMA
// (no tensor cores in this version), with 256 threads: thread (ty, tx) =
// (tid / 16, tid % 16) owns rows 4 ty .. 4 ty + 3 and columns tx, tx + 16,
// tx + 32, tx + 48 of a tile, and the same rows and the columns tx + 16 j of
// a (64, D) accumulator. The 16 threads of one ty sit in one half-warp, so a
// row's max and sum are four shuffles. An operand read along the rows is
// kept row-major in shared memory ((64, D), read as float4 over D, the same
// address across a half-warp); one read along the columns is kept
// transposed ((D, 65), one pad float a row, so that 16 neighbouring columns
// and 32 neighbouring rows each fall on distinct banks).
//
// The backward (attn_bwd_dkv, attn_bwd_dq) runs its products on the tensor
// cores (mma.sync m16n8k8 TF32, tf32_mma.cuh) with 128 threads: warp w owns
// rows 16 w .. 16 w + 15 of the block's tile, and its score tiles and (16, D)
// accumulators live in the MMA's C fragments. f32 accuracy comes from a
// split: x = hi + lo with hi = tf32(x) and lo = x - hi (read by the tensor
// cores to TF32), and a product of two split operands sums lo hi + hi lo +
// hi hi (three passes; what they drop is about 2^-21 of each product, as in
// CUTLASS's split-TF32 f32 GEMM). A bf16 or f16 operand is exact in TF32 and
// has no lo part; p and ds are f32 and always split. The tensor cores
// truncate as they accumulate, so each tile's terms of dk, dv and dq are
// summed apart and added to the accumulators in f32 (accumulate). p and ds
// never leave registers: the C fragment of a score tile is the A fragment of
// the next product once that product reads the 8 k indices of each step in
// the order 0, 2, 4, 6, 1, 3, 5, 7 (frag_a_of_c, frag_b_perm), which
// permutes the terms of each sum and nothing else. Each tile is held once,
// row-major, at a row stride of D + 4 floats: the three fragment reads (A
// rows, B rows read as columns, B rows in the permuted order) then fall on
// 32 distinct banks. The walked tiles go through a two-stage ring: f32 ones
// by 16-byte cp.async, issued before the current tile's products; bf16 and
// f16 ones by 16-byte loads converted to f32 on the way in. The next tile's
// row statistics wait in registers.
//
// The three kernel bodies are written once over a mask policy, the kernel's
// parameter, which says which tiles a block visits and which scores of a
// visited tile it keeps:
//   seg_at(b, r, pad)             row r's segment id; load_seg(dst, b, row0,
//                                 pad) those of a tile's 64 rows
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
#include "tf32_mma.cuh"

#include <math.h>
#include <string.h>

#include <type_traits>

namespace ffc {
namespace attn {

constexpr int kTile = 64;         // queries and keys a tile
constexpr int kThreads = 256;     // the forward's 16 x 16 threads, a 4 x 4 block of a tile each
constexpr int kBwdThreads = 128;  // the backward's 4 warps, 16 rows of a tile each
constexpr int kTS = kTile + 1;    // row stride of the forward's transposed (D, 64) tile

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

  // Row r's segment id (0 for all when there are none; `pad` past L, which
  // matches no real id of the other side), and those of rows row0 .. row0 + 63.
  __device__ __forceinline__ int seg_at(int b, int r, int pad) const {
    return seg == nullptr ? 0 : (r < len ? seg[(size_t)b * len + r] : pad);
  }
  __device__ __forceinline__ void load_seg(int* dst, int b, int row0, int pad) const {
    if (threadIdx.x < kTile) dst[threadIdx.x] = seg_at(b, row0 + threadIdx.x, pad);
  }
  // A tile (qt, kt) is full when no segment ids, no edge of L and (under
  // causal) no diagonal cut it.
  __device__ __forceinline__ bool tile_full(int qt, int kt) const {
    return seg == nullptr && (max(qt, kt) + 1) * kTile <= len && (!causal || kt < qt);
  }
  __device__ __forceinline__ int n_kv(int qt) const { return causal ? qt + 1 : n_tiles; }
  __device__ __forceinline__ int kv_tile(int qt, int n, bool& full) const {
    full = tile_full(qt, n);
    return n;
  }
  __device__ __forceinline__ int n_q(int kt) const { return causal ? n_tiles - kt : n_tiles; }
  __device__ __forceinline__ int q_tile(int kt, int n, bool& full) const {
    const int qt = causal ? kt + n : n;
    full = tile_full(qt, kt);
    return qt;
  }
  __device__ __forceinline__ float score(int b, int h, int r, int c, float x, bool full,
                                         int seg_r, int seg_c) const {
    if (!full && (r >= len || c >= len || (causal && c > r) || seg_r != seg_c)) return -INFINITY;
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

  __device__ __forceinline__ int seg_at(int, int, int) const { return 0; }
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
  if (batch < 1 || heads < 1 || len < 1) return false;
  if (window != 0) return window >= 1 && window <= len;
  return table != nullptr && blocks != nullptr && block_size >= 1 &&
         (long long)block_size * n_blocks == len;
}

// The backward's 16-byte loads need operands on 16-byte boundaries (the
// wrappers copy one that is not).
inline bool aligned16(const void* q, const void* k, const void* v, const void* dout) {
  return (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) & 15) == 0;
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

// acc[i][j] += sum_c P[4 ty + i][c] * B[c][tx + 16 j] over the 64 columns of
// a row-major (64, 64) tile P, B row-major (64, D): the rows' block of P B.
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

// The (b, h) index of this block: launch folds B * H over gridDim.y and
// gridDim.z, and a block past B * H returns at once.
__device__ __forceinline__ int block_bh() { return blockIdx.y + gridDim.y * blockIdx.z; }

template <int D>
constexpr size_t fwd_smem_bytes() {
  return (2 * kTile * D + D * kTS + kTile * kTile) * sizeof(float);  // Qs, Vs, Kt, Ps
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

  const int bh = block_bh();
  if (bh >= m.batch * m.heads) return;
  const int len = m.len;
  const int qt = m.n_tiles - 1 - blockIdx.x;
  const int b = bh / m.heads, h = bh % m.heads;
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

// --- the backward, on the tensor cores --------------------------------------
//
// It recomputes p = exp(s - lse) (as 2^((s - lse) log2 e)) from the
// forward's row logsumexp and takes
// delta = rowsum(do * o) (f32 (B, H, L)) from the wrapper. With
// dp = do v^T and ds = p * (dp - delta):
//   dv = p^T do,   dk = ds^T q * scale,   dq = ds k * scale,   dbias = ds.
// Element e of a warp's C fragment j lies at row g + 8 (e / 2) and column
// 8 j + 2 t + e % 2 of its (16, 8 NT) tile, g = lane / 4 and t = lane % 4.

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the special-function unit (ex2.approx.ftz: a relative error of
// about 2^-22, and 0 below 2^-126, where a p adds nothing to a grad); exp2f
// wraps the same instruction in a path for subnormal results.
__device__ __forceinline__ float fast_exp2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Row stride, in floats, of a (64, D) tile in the backward's shared memory.
template <int D>
__host__ __device__ constexpr int bwd_ld() {
  return D + 4;
}

// Two tiles the block keeps (K and V, or Q and dO) and two stages of the two
// it walks.
template <int D>
constexpr size_t bwd_smem_bytes() {
  return 6 * kTile * bwd_ld<D>() * sizeof(float);
}

// Rows row0 .. row0 + 63 of a (L, D) slab into a row-major (64, bwd_ld) f32
// tile, zeros past L. f32 by 16-byte asynchronous copies, complete after the
// next cp_async_wait that covers them (the zeros past L are plain stores);
// bf16 and f16 by 16-byte loads, converted in registers. Unrolled by 2 only:
// a full unroll keeps every piece's address in registers through the loop.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int len) {
  constexpr int LD = bwd_ld<D>();
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll 2
    for (int i = 0; i < kTile * D / 4 / kBwdThreads; ++i) {
      const int e = threadIdx.x + i * kBwdThreads, r = e / (D / 4), c = e % (D / 4) * 4;
      if (row0 + r < len)
        cp_async16(dst + r * LD + c, src + (size_t)(row0 + r) * D + c);
      else
        *reinterpret_cast<float4*>(dst + r * LD + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
#pragma unroll 2
    for (int i = 0; i < kTile * D / 8 / kBwdThreads; ++i) {
      const int e = threadIdx.x + i * kBwdThreads, r = e / (D / 8), c = e % (D / 8) * 8;
      float x[8] = {};
      if (row0 + r < len) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
        const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) x[j] = to_f(h[j]);
      }
      float4* d4 = reinterpret_cast<float4*>(dst + r * LD + c);
      d4[0] = make_float4(x[0], x[1], x[2], x[3]);
      d4[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
  }
}

// x as TF32 operands: hi = tf32(x), and with kSplit lo = x - hi; without it
// x must be exact in TF32 (a bf16 or f16 value) and lo is 0. tf32() rounds
// to nearest, ties away from zero, as cvt.rna.tf32.f32 does, by adding half
// a TF32 ulp to the bits (sign and magnitude) and dropping the low 13; the
// tensor cores ignore those 13 bits, so hi is passed before they are
// cleared, and lo (exact in f32) as it is, which truncates it to TF32: an
// error of at most 2^-11 of lo, 2^-22 of x, the size of the lo lo term the
// split drops. Three operations a value, where cvt.rna.tf32.f32 compiles to
// four (it also tests for inf and NaN) and a second cvt for lo to four more.
template <bool kSplit>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t bits = __float_as_uint(x);
  if (kSplit) {
    hi = bits + 0x1000u;
    lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
  } else {
    hi = bits;
    lo = 0u;
  }
}

// The A fragment of rows r0 .. r0 + 15, columns k0 .. k0 + 7 of a tile.
template <int LD, bool kSplit>
__device__ __forceinline__ void frag_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* tile,
                                       int r0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = tile + (r0 + g) * LD + k0 + t;
  split_tf32<kSplit>(p[0], hi[0], lo[0]);
  split_tf32<kSplit>(p[8 * LD], hi[1], lo[1]);
  split_tf32<kSplit>(p[4], hi[2], lo[2]);
  split_tf32<kSplit>(p[8 * LD + 4], hi[3], lo[3]);
}

// The B fragment of B = tile^T, B[k][n] = tile[n0 + n][k0 + k].
template <int LD, bool kSplit>
__device__ __forceinline__ void frag_b_t(uint32_t (&hi)[2], uint32_t (&lo)[2], const float* tile,
                                         int n0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = tile + (n0 + g) * LD + k0 + t;
  split_tf32<kSplit>(p[0], hi[0], lo[0]);
  split_tf32<kSplit>(p[4], hi[1], lo[1]);
}

// The B fragment of B = tile, B[k][n] = tile[k0 + k][n0 + n], its k slots in
// frag_a_of_c's order: slot t holds row k0 + 2 t, slot t + 4 row k0 + 2 t + 1.
template <int LD, bool kSplit>
__device__ __forceinline__ void frag_b_perm(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                            const float* tile, int k0, int n0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = tile + (k0 + 2 * t) * LD + n0 + g;
  split_tf32<kSplit>(p[0], hi[0], lo[0]);
  split_tf32<kSplit>(p[LD], hi[1], lo[1]);
}

// The A fragment with the rows and columns of the C fragment c, its k slots
// permuted as frag_b_perm reads B: slot t is column 2 t, slot t + 4 column
// 2 t + 1. c holds p or ds, f32, so it is split.
__device__ __forceinline__ void frag_a_of_c(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                            const float (&c)[4]) {
  split_tf32<true>(c[0], hi[0], lo[0]);
  split_tf32<true>(c[2], hi[1], lo[1]);
  split_tf32<true>(c[1], hi[2], lo[2]);
  split_tf32<true>(c[3], hi[3], lo[3]);
}

// d += a b to f32 accuracy: the small terms lo hi and hi lo first, then
// hi hi; an operand exact in TF32 has no lo term.
template <bool kSplitA, bool kSplitB>
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                          const uint32_t (&bl)[2]) {
  if (kSplitA) mma_tf32(d, al, bh);
  if (kSplitB) mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// s (the C fragments of the warp's rows r0 .. r0 + 15 and the columns c0 ..
// c0 + 8 NT - 1) = A B^T over D, A and B row-major (64, bwd_ld) tiles, in
// groups of KG k-steps: each group's terms are summed apart and added to s
// in f32, which keeps the tensor cores' truncation to a chain of KG steps.
template <int D, int NT, int KG, bool kSplit>
__device__ __forceinline__ void product_t(float (&s)[NT][4], const float* A, const float* B,
                                          int r0, int c0) {
  constexpr int LD = bwd_ld<D>();
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 1
  for (int g0 = 0; g0 < D; g0 += 8 * KG) {
    float part[NT][4] = {};
#pragma unroll
    for (int k0 = g0; k0 < g0 + 8 * KG; k0 += 8) {
      uint32_t ah[4], al[4], bh[2], bl[2];
      frag_a<LD, kSplit>(ah, al, A, r0, k0);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        frag_b_t<LD, kSplit>(bh, bl, B, c0 + 8 * j, k0);
        mma_split<kSplit, kSplit>(part[j], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
  }
}

// Two score-shaped products for the warp's rows r0 .. r0 + 15 and the
// columns c0 .. c0 + 8 NT - 1: s = A1 B1^T and dp = A2 B2^T over D, the four
// tiles row-major (64, bwd_ld). s[j], dp[j]: the C fragments of columns
// c0 + 8 j .. At D = 64 in f32 (the GPT path) the two chains of 24 mma run
// interleaved, straight into s and dp (product_t there took the dK/dV + dQ
// pair 12% longer on an H100); a longer chain (D = 128), or one whose single
// pass leaves the rounding of a cancelling dp - delta to the accumulation
// alone (bf16 and f16), is cut into groups (product_t).
template <int D, int NT, bool kSplit>
__device__ __forceinline__ void score_tiles(float (&s)[NT][4], float (&dp)[NT][4],
                                            const float* A1, const float* B1, const float* A2,
                                            const float* B2, int r0, int c0) {
  constexpr int LD = bwd_ld<D>();
  if constexpr (kSplit && D == 64) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 8) {
      uint32_t ah[4], al[4], bh[2], bl[2];
      frag_a<LD, kSplit>(ah, al, A1, r0, k0);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        frag_b_t<LD, kSplit>(bh, bl, B1, c0 + 8 * j, k0);
        mma_split<kSplit, kSplit>(s[j], ah, al, bh, bl);
      }
      frag_a<LD, kSplit>(ah, al, A2, r0, k0);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        frag_b_t<LD, kSplit>(bh, bl, B2, c0 + 8 * j, k0);
        mma_split<kSplit, kSplit>(dp[j], ah, al, bh, bl);
      }
    }
  } else {
    constexpr int KG = kSplit ? 4 : 2;  // chains of 12 mma (3 passes) or of 2
    product_t<D, NT, KG, kSplit>(s, A1, B1, r0, c0);
    product_t<D, NT, KG, kSplit>(dp, A2, B2, r0, c0);
  }
}

// acc (the warp's 16 rows by D, as D / 8 C fragments) += P B over 8 NT
// terms: P the C fragments p (columns c0 ..), B rows c0 .. c0 + 8 NT - 1 of a
// row-major (64, bwd_ld) tile. The tensor cores truncate as they accumulate,
// so one chain of mma over a whole row drifts by about 2^-24 of acc a step:
// with dk's 384 steps at L = 1024 that read 1.7e-5 of the largest |dk| on an
// H100, against 1e-6 with these terms summed apart (64 columns of D at a
// time) and added to acc in f32.
template <int D, int NT, bool kSplitB>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const float (&p)[NT][4],
                                           const float* B, int c0) {
  constexpr int LD = bwd_ld<D>(), G = D == 64 ? 8 : 4;  // C fragments summed apart at once
#pragma unroll
  for (int n0 = 0; n0 < D / 8; n0 += G) {
    float part[G][4] = {};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ah[4], al[4];
      frag_a_of_c(ah, al, p[j]);
#pragma unroll
      for (int n = 0; n < G; ++n) {
        uint32_t bh[2], bl[2];
        frag_b_perm<LD, kSplitB>(bh, bl, B, c0 + 8 * j, 8 * (n0 + n));
        mma_split<true, kSplitB>(part[n], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int n = 0; n < G; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
  }
}

// The warp's accumulator times mul into rows row0 .. row0 + 15 of a (L, D)
// slab, rows past L dropped.
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float (&acc)[D / 8][4],
                                           int row0, int len, float mul) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    if (r >= len) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      T* out = dst + (size_t)r * D + 8 * n + 2 * t;
      out[0] = from_f<T>(acc[n][2 * i] * mul);
      out[1] = from_f<T>(acc[n][2 * i + 1] * mul);
    }
  }
}

// A query row's statistics: lse (+inf past L, so that p = 0 there), delta
// (0 past L) and segment id.
struct RowStats {
  float lse, delta;
  int seg;
};

template <typename Mask>
__device__ __forceinline__ RowStats row_stats(const Mask& m, const float* __restrict__ lse,
                                              const float* __restrict__ delta, int b,
                                              size_t row_base, int r) {
  const bool in = r < m.len;
  return {in ? lse[row_base + r] : INFINITY, in ? delta[row_base + r] : 0.f, m.seg_at(b, r, -1)};
}

// dK/dV: one block owns (b, h, a tile of 64 keys), keeps K and V, and walks
// the query tiles its mask names, Q and dO through the ring. Each warp
// computes its 16 keys' rows of s^T = K Q^T and dp^T = V dO^T, turns them
// into p^T and ds^T in registers and accumulates dv += p^T dO and
// dk += ds^T Q in C fragments, over 64 queries at a time at D = 64 and 8 at
// D = 128 (where the accumulators take twice the registers).
template <int D, typename T, typename Mask>
__device__ __forceinline__ void attn_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
                                             const T* __restrict__ v,
                                             const T* __restrict__ dout,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta,
                                             T* __restrict__ dk, T* __restrict__ dv,
                                             const Mask& m) {
  constexpr int LD = bwd_ld<D>(), NT = D == 64 ? 8 : 1;
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // (64, LD) keys
  float* Vs = Ks + kTile * LD;                   // (64, LD) values
  float* Qs = Vs + kTile * LD;                   // two stages of (64, LD) queries
  float* dOs = Qs + 2 * kTile * LD;              // two stages of (64, LD) output grads
  __shared__ float lse_s[2][kTile], delta_s[2][kTile];
  __shared__ int seg_q[2][kTile], seg_k[kTile];

  const int bh = block_bh();
  if (bh >= m.batch * m.heads) return;
  const int len = m.len, kt = blockIdx.x, b = bh / m.heads, h = bh % m.heads;
  const size_t base = (size_t)bh * len * D, row_base = (size_t)bh * len;
  const int k0 = kt * kTile, r0 = threadIdx.x / 32 * 16;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int n_q = m.n_q(kt);
  bool full;

  load_tile<D>(Ks, k + base, k0, len);
  load_tile<D>(Vs, v + base, k0, len);
  m.load_seg(seg_k, b, k0, -2);
  if (n_q > 0) {
    const int q0 = m.q_tile(kt, 0, full) * kTile;
    load_tile<D>(Qs, q + base, q0, len);
    load_tile<D>(dOs, dout + base, q0, len);
    if (threadIdx.x < kTile) {
      const RowStats st = row_stats(m, lse, delta, b, row_base, q0 + threadIdx.x);
      lse_s[0][threadIdx.x] = st.lse;
      delta_s[0][threadIdx.x] = st.delta;
      seg_q[0][threadIdx.x] = st.seg;
    }
  }
  cp_async_commit();

  float acc_dk[D / 8][4] = {}, acc_dv[D / 8][4] = {};
  for (int n = 0; n < n_q; ++n) {
    const int cur = n & 1, nxt = cur ^ 1;
    const int q0 = m.q_tile(kt, n, full) * kTile;
    RowStats next = {};
    if (n + 1 < n_q) {  // the next tile's copies fly while this one is multiplied
      bool next_full;
      const int q1 = m.q_tile(kt, n + 1, next_full) * kTile;
      load_tile<D>(Qs + nxt * kTile * LD, q + base, q1, len);
      load_tile<D>(dOs + nxt * kTile * LD, dout + base, q1, len);
      if (threadIdx.x < kTile) next = row_stats(m, lse, delta, b, row_base, q1 + threadIdx.x);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile n, its statistics and (n = 0) K and V are in shared memory

    const float* Qc = Qs + cur * kTile * LD;
    const float* dOc = dOs + cur * kTile * LD;
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += 8 * NT) {
      float s[NT][4], dp[NT][4];
      asm volatile("" ::: "memory");  // the kept tiles' loads stay here, not in registers
      score_tiles<D, NT, kSplit>(s, dp, Ks, Qc, Vs, dOc, r0, c0);  // s^T, dp^T
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = r0 + g + 8 * (e >> 1), qc = c0 + 8 * j + 2 * t + (e & 1);
          const float x = m.score(b, h, q0 + qc, k0 + kr, s[j][e], full, seg_q[cur][qc],
                                  seg_k[kr]);
          const float p = x == -INFINITY ? 0.f : fast_exp2((x - lse_s[cur][qc]) * kLog2e);
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - delta_s[cur][qc]);
        }
      accumulate<D, NT, kSplit>(acc_dv, s, dOc, c0);   // dv += p^T do
      accumulate<D, NT, kSplit>(acc_dk, dp, Qc, c0);   // dk += ds^T q
    }
    if (n + 1 < n_q && threadIdx.x < kTile) {
      lse_s[nxt][threadIdx.x] = next.lse;
      delta_s[nxt][threadIdx.x] = next.delta;
      seg_q[nxt][threadIdx.x] = next.seg;
    }
    __syncthreads();  // every warp is done with stage cur before tile n + 2 lands in it
  }
  cp_async_wait<0>();

  store_rows<D>(dk + base, acc_dk, k0 + r0, len, m.scale);
  store_rows<D>(dv + base, acc_dv, k0 + r0, len, 1.f);
}

// dQ: one block owns (b, h, a tile of 64 queries), keeps Q and dO, and walks
// the key tiles its mask names, K and V through the ring, the longest rows'
// tiles first. Each warp computes its 16 queries' rows of s = Q K^T and
// dp = dO V^T, turns them into ds in registers (and, when ds_out is given,
// writes ds to a (B, H, L, L) f32 buffer: the flash kernels' bias grad) and
// accumulates dq += ds K in C fragments, over 64 keys at a time at D = 64
// and 32 at D = 128. A thread's two rows keep their statistics in registers.
template <int D, typename T, typename Mask>
__device__ __forceinline__ void attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                                            const T* __restrict__ v, const T* __restrict__ dout,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta, T* __restrict__ dq,
                                            float* __restrict__ ds_out, const Mask& m) {
  constexpr int LD = bwd_ld<D>(), NT = D == 64 ? 8 : 4;
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // (64, LD) queries
  float* dOs = Qs + kTile * LD;                  // (64, LD) output grads
  float* Ks = dOs + kTile * LD;                  // two stages of (64, LD) keys
  float* Vs = Ks + 2 * kTile * LD;               // two stages of (64, LD) values
  __shared__ int seg_k[2][kTile];

  const int bh = block_bh();
  if (bh >= m.batch * m.heads) return;
  const int len = m.len, qt = m.n_tiles - 1 - blockIdx.x, b = bh / m.heads, h = bh % m.heads;
  const size_t base = (size_t)bh * len * D, row_base = (size_t)bh * len;
  const int q0 = qt * kTile, r0 = threadIdx.x / 32 * 16;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int n_kv = m.n_kv(qt);
  const RowStats row0 = row_stats(m, lse, delta, b, row_base, q0 + r0 + g);
  const RowStats row1 = row_stats(m, lse, delta, b, row_base, q0 + r0 + g + 8);
  bool full;

  load_tile<D>(Qs, q + base, q0, len);
  load_tile<D>(dOs, dout + base, q0, len);
  if (n_kv > 0) {
    const int k0 = m.kv_tile(qt, 0, full) * kTile;
    load_tile<D>(Ks, k + base, k0, len);
    load_tile<D>(Vs, v + base, k0, len);
    if (threadIdx.x < kTile) seg_k[0][threadIdx.x] = m.seg_at(b, k0 + threadIdx.x, -2);
  }
  cp_async_commit();

  float acc[D / 8][4] = {};
  for (int n = 0; n < n_kv; ++n) {
    const int cur = n & 1, nxt = cur ^ 1;
    const int k0 = m.kv_tile(qt, n, full) * kTile;
    int next_seg = 0;
    if (n + 1 < n_kv) {  // the next tile's copies fly while this one is multiplied
      bool next_full;
      const int k1 = m.kv_tile(qt, n + 1, next_full) * kTile;
      load_tile<D>(Ks + nxt * kTile * LD, k + base, k1, len);
      load_tile<D>(Vs + nxt * kTile * LD, v + base, k1, len);
      if (threadIdx.x < kTile) next_seg = m.seg_at(b, k1 + threadIdx.x, -2);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile n and (n = 0) Q and dO are in shared memory

    const float* Kc = Ks + cur * kTile * LD;
    const float* Vc = Vs + cur * kTile * LD;
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += 8 * NT) {
      float s[NT][4], dp[NT][4];
      asm volatile("" ::: "memory");  // the kept tiles' loads stay here, not in registers
      score_tiles<D, NT, kSplit>(s, dp, Qs, Kc, dOs, Vc, r0, c0);  // s, dp
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const RowStats& row = e < 2 ? row0 : row1;
          const int r = q0 + r0 + g + 8 * (e >> 1), kc = c0 + 8 * j + 2 * t + (e & 1);
          const int c = k0 + kc;
          const float x = m.score(b, h, r, c, s[j][e], full, row.seg, seg_k[cur][kc]);
          const float p = x == -INFINITY ? 0.f : fast_exp2((x - row.lse) * kLog2e);
          dp[j][e] = p * (dp[j][e] - row.delta);
          if (ds_out != nullptr && r < len && c < len) ds_out[(row_base + r) * len + c] = dp[j][e];
        }
      accumulate<D, NT, kSplit>(acc, dp, Kc, c0);  // dq += ds k
    }
    if (n + 1 < n_kv && threadIdx.x < kTile) seg_k[nxt][threadIdx.x] = next_seg;
    __syncthreads();  // every warp is done with stage cur before tile n + 2 lands in it
  }
  cp_async_wait<0>();

  store_rows<D>(dq + base, acc, q0 + r0, len, m.scale);
}

// --- launching ---------------------------------------------------------------

template <int D>
struct HeadDim {
  static constexpr int value = D;
};

// The operands' dtype as the C entries take it.
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename F, typename Dim>
cudaError_t dispatch_dtype(int dtype, Dim dim, F f) {
  if (dtype == kF32) return f(dim, 0.f);
  if (dtype == kBF16) return f(dim, __nv_bfloat16{});
  if (dtype == kF16) return f(dim, __half{});
  return cudaErrorInvalidValue;
}

// f(HeadDim<D>{}, T{}) for the operands' head_dim (64 or 128) and dtype
// (DType: f32, bf16 or f16); an invalid value for any other.
template <typename F>
cudaError_t dispatch(int head_dim, int dtype, F f) {
  if (head_dim == 64) return dispatch_dtype(dtype, HeadDim<64>{}, f);
  if (head_dim == 128) return dispatch_dtype(dtype, HeadDim<128>{}, f);
  return cudaErrorInvalidValue;
}

constexpr int kMaxGridY = 65535;

// kernel on the (tiles of L, B * H) grid of `threads` threads with `smem`
// bytes of dynamic shared memory, its arguments cast to the kernel's own
// types. B * H is folded over gridDim.y (at most 65535) and gridDim.z
// (block_bh); blockIdx.x stays the tile.
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), int threads, size_t smem, int len, int batch_heads,
                   cudaStream_t stream, A... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int z = (batch_heads + kMaxGridY - 1) / kMaxGridY;  // at most z - 1 idle columns
  const dim3 grid((len + kTile - 1) / kTile, (batch_heads + z - 1) / z, z);
  kernel<<<grid, threads, smem, stream>>>(((P)args)...);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace ffc
