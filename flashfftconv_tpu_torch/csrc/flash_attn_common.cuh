// Device code shared by the attention kernels: the flash-attention kernels
// (flash_attn.cu, flash_attn_bwd.cu) and the splash-attention kernels
// (splash_attn.cu, splash_attn_bwd.cu).
//
// Layout is the JAX package's: q, k, v, o (B, H, L, D) contiguous and the
// row logsumexp (B, H, L) f32. Scores are s_ij = (q_i . k_j) * scale, plus a
// bias where the mask has one, and -inf where the mask hides (i, j).
//
// Every kernel works on 64 x 64 tiles of the score matrix. A block owns one
// tile of 64 rows of one (b, h): blockIdx.x is the tile (above D = 1024 the
// tile and a D slice, see "above D = 128" below) and (b, h) is
// blockIdx.y + gridDim.y * blockIdx.z (block_bh), so that B * H may exceed
// the 65535 of one grid dimension. Shared memory holds f32 whatever the
// operands' dtype; softmax statistics and every sum are f32.
//
// Every product runs on the tensor cores (mma.sync m16n8k8 TF32,
// tf32_mma.cuh). Up to D = 128 a block has 128 threads: warp w owns rows
// 16 w .. 16 w + 15 of the block's tile, and its score tiles and (16, D)
// accumulators live in the MMA's C fragments. f32 accuracy comes from a
// split: x = hi + lo with hi = tf32(x) and lo = x - hi (read by the tensor
// cores to TF32), and a product of two split operands sums lo hi + hi lo +
// hi hi (three passes; what they drop is about 2^-21 of each product, as in
// CUTLASS's split-TF32 f32 GEMM). A bf16 or f16 operand is exact in TF32 and
// has no lo part; p and ds are f32 and always split. The tensor cores
// truncate as they accumulate, so each tile's terms of o, dk, dv and dq are
// summed apart and added to the accumulators in f32 (accumulate). p and ds
// never leave registers: the C fragment of a score tile is the A fragment of
// the next product once that product reads the 8 k indices of each step in
// the order 0, 2, 4, 6, 1, 3, 5, 7 (frag_a_of_c, frag_b_perm), which
// permutes the terms of each sum and nothing else. Each tile is held once,
// row-major, at a row stride of D + 4 floats: the three fragment reads (A
// rows, B rows read as columns, B rows in the permuted order) then fall on
// 32 distinct banks. The walked tiles go through a two-stage ring: f32 ones
// by 16-byte cp.async, issued before the current tile's products; bf16 and
// f16 ones by 16-byte loads converted to f32 on the way in.
// The forward (attn_fwd) keeps Q and walks K and V: s = q k^T, the online
// softmax on the C fragments (a thread's rows g and g + 8, the row max a
// quad shuffle, 2^x by fast_exp2), o += p v. The backward (attn_bwd_dkv,
// attn_bwd_dq) keeps K and V, or Q and dO, walks the other pair, and keeps
// the next tile's row statistics in registers.
// From D = 256 to 1024 the forward and the backward are
// flash_attn_fwd_wide.cuh's and flash_attn_bwd_wide.cuh's, on wgmma in
// thread block clusters; above 1024 both split D across blocks (the wide
// bodies here); see "above D = 128" below.

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

constexpr int kTile = 64;            // queries and keys a tile
constexpr int kNarrowThreads = 128;  // up to D = 128: 4 warps, 16 rows of a tile each
constexpr int kMaxClustered = 1024;  // the widest head_dim of the clustered bodies
constexpr int kSliceDim = 256;       // the columns of a slice above it

// D slices a block of the head_dim: 1 up to kMaxClustered.
inline int slices_of(int head_dim) {
  return head_dim > kMaxClustered ? (head_dim + kSliceDim - 1) / kSliceDim : 1;
}

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
// other ids is masked. head_dim is q's, n_slices its D slices (slices_of).
struct FlashMask {
  int batch, heads, len, n_tiles, head_dim, n_slices;
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

inline FlashMask make_flash_mask(int batch, int heads, int len, int head_dim, int causal,
                                 const void* bias, int sb, int sh, int sq, const void* seg,
                                 int scale_bits) {
  FlashMask m = {};
  m.batch = batch;
  m.heads = heads;
  m.len = len;
  m.n_tiles = (len + kTile - 1) / kTile;
  m.head_dim = head_dim;
  m.n_slices = slices_of(head_dim);
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
// head_dim and n_slices as in FlashMask.
struct SplashMask {
  int batch, heads, len, n_tiles, head_dim, n_slices;
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
inline SplashMask make_splash_mask(int batch, int heads, int len, int head_dim, int window,
                                   const void* table, const void* blocks, int block_size,
                                   int n_blocks, int n_entries, int causal, int scale_bits) {
  SplashMask m = {};
  m.batch = batch;
  m.heads = heads;
  m.len = len;
  m.n_tiles = (len + kTile - 1) / kTile;
  m.head_dim = head_dim;
  m.n_slices = slices_of(head_dim);
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

// The kernels' 16-byte loads need operands on 16-byte boundaries (the
// wrappers copy one that is not).
inline bool aligned16(const void* q, const void* k, const void* v, const void* dout) {
  return (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) & 15) == 0;
}

// --- the kernel bodies, over a mask policy ---------------------------------

// The (b, h) index of this block: launch folds B * H over gridDim.y and
// gridDim.z, and a block past B * H returns at once.
__device__ __forceinline__ int block_bh() { return blockIdx.y + gridDim.y * blockIdx.z; }

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

// Row stride, in floats, of a tile in shared memory: D + 4, so that the
// fragment reads fall on 32 distinct banks.
template <int D>
__host__ __device__ constexpr int tile_ld() {
  return D + 4;
}

// The sliced bodies below (above D = 1024, kSliceDim columns a block): the
// backward keeps kWideRows rows of its tile, and both walk wide_walk rows
// of the other side a step, one stage, with one warp for every 64 columns.
constexpr int kWideRows = 16;

template <int D>
__host__ __device__ constexpr int wide_walk() {
  return D <= 256 ? kTile : kTile / 2;
}

// Threads a block: 4 warps up to D = 128, D / 64 above.
template <int D>
__host__ __device__ constexpr int body_threads() {
  return D <= 128 ? kNarrowThreads : 32 * (D / 64);
}

// The sliced forward above D = 1024 (attn_fwd_wide, D = kSliceDim columns
// a block): R = 32 kept queries, W walked keys a step, and warps of 16 rows
// by 64 columns of o: NRG row groups of NWC warps each. A row group's NS
// score tiles a step are shared out over its warps, TPW each at most.
// (Warps of 128 columns, which let the whole 64-row tile stay, spilled
// 600-900 bytes at 255 registers in f32.)
template <int D>
struct FwdWide {
  static constexpr int kR = kTile / 2;
  static constexpr int kW = wide_walk<D>();
  static constexpr int kNRG = kR / 16, kNWC = D / 64;
  static constexpr int kThreads = 32 * kNRG * kNWC;
  static constexpr int kNS = kW / 8, kTPW = (kNS + kNWC - 1) / kNWC;
};

template <int D>
__host__ __device__ constexpr int fwd_threads() {
  if constexpr (D <= 128)
    return kNarrowThreads;
  else
    return FwdWide<D>::kThreads;
}

// The forward up to D = 128: the kept query tile and two stages of K and V.
// The sliced one: the kept queries, the walked K and V, and for each row
// group the A fragments of p (float4 a lane and 8-key step) and each score
// tile's row maxima: 175,616 B.
template <int D>
constexpr size_t fwd_smem_bytes() {
  if constexpr (D <= 128) {
    return 5 * kTile * tile_ld<D>() * sizeof(float);
  } else {
    using F = FwdWide<D>;
    return (F::kR + 2 * F::kW) * tile_ld<D>() * sizeof(float) +
           F::kNRG * F::kNS * (32 * sizeof(float4) + 16 * sizeof(float));
  }
}

// The backward up to D = 128: two tiles the block keeps (K and V, or Q and
// dO) and two stages of the two it walks. Above: the two kept parts of
// kWideRows rows, the two walked parts, and the A fragments of p and ds for
// the kept rows.
template <int D>
constexpr size_t bwd_smem_bytes() {
  if constexpr (D <= 128) {
    return 6 * kTile * tile_ld<D>() * sizeof(float);
  } else {
    return (2 * kWideRows + 2 * wide_walk<D>()) * tile_ld<D>() * sizeof(float) +
           2 * (wide_walk<D>() / 8) * 32 * sizeof(float4);
  }
}

// Rows row0 .. row0 + ROWS - 1 of a (L, D) slab into a row-major (ROWS,
// tile_ld) f32 tile by THREADS threads, zeros past L. f32 by 16-byte
// asynchronous copies, complete after the next cp_async_wait that covers
// them (the zeros past L are plain stores); bf16 and f16 by 16-byte loads,
// converted in registers. Unrolled by 2 only: a full unroll keeps every
// piece's address in registers through the loop. kSliced: the tile is the
// D-column slice from column col0 of an (L, ld) slab, zeros past column ld.
template <int D, typename T, int ROWS = kTile, int THREADS = kNarrowThreads, bool kSliced = false>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int len, int ld = D, int col0 = 0) {
  constexpr int LD = tile_ld<D>();
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll 2
    for (int i = 0; i < ROWS * D / 4 / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS, r = e / (D / 4), c = e % (D / 4) * 4;
      if (row0 + r < len && (!kSliced || col0 + c < ld))
        cp_async16(dst + r * LD + c, src + (size_t)(row0 + r) * ld + col0 + c);
      else
        *reinterpret_cast<float4*>(dst + r * LD + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
#pragma unroll 2
    for (int i = 0; i < ROWS * D / 8 / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS, r = e / (D / 8), c = e % (D / 8) * 8;
      float x[8] = {};
      if (row0 + r < len && (!kSliced || col0 + c < ld)) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + col0 + c);
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

// s (the C fragments of the warp's rows r0 .. r0 + 15 and the columns c0 ..
// c0 + 8 NT - 1) = A B^T over D, A and B row-major (64, tile_ld) tiles, in
// groups of KG k-steps: each group's terms are summed apart and added to s
// in f32, which keeps the tensor cores' truncation to a chain of KG steps.
template <int D, int NT, int KG, bool kSplit>
__device__ __forceinline__ void product_t(float (&s)[NT][4], const float* A, const float* B,
                                          int r0, int c0) {
  constexpr int LD = tile_ld<D>();
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
// tiles row-major (64, tile_ld). s[j], dp[j]: the C fragments of columns
// c0 + 8 j .. At D = 64 in f32 (the GPT path) the two chains of 24 mma run
// interleaved, straight into s and dp (product_t there took the dK/dV + dQ
// pair 12% longer on an H100); a longer chain (D = 128), or one whose single
// pass leaves the rounding of a cancelling dp - delta to the accumulation
// alone (bf16 and f16), is cut into groups (product_t).
template <int D, int NT, bool kSplit>
__device__ __forceinline__ void score_tiles(float (&s)[NT][4], float (&dp)[NT][4],
                                            const float* A1, const float* B1, const float* A2,
                                            const float* B2, int r0, int c0) {
  constexpr int LD = tile_ld<D>();
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
// row-major (64, tile_ld) tile. The tensor cores truncate as they accumulate,
// so one chain of mma over a whole row drifts by about 2^-24 of acc a step:
// with dk's 384 steps at L = 1024 that read 1.7e-5 of the largest |dk| on an
// H100, against 1e-6 with these terms summed apart (64 columns of D at a
// time) and added to acc in f32.
template <int D, int NT, bool kSplitB>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const float (&p)[NT][4],
                                           const float* B, int c0) {
  constexpr int LD = tile_ld<D>(), G = D == 64 ? 8 : 4;  // C fragments summed apart at once
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

// The warp's accumulator (N C fragments: columns c0 .. c0 + 8 N - 1) into
// rows row0 .. row0 + 15 of an (L, ld) slab, row g + 8 i times mul[i], rows
// past L dropped.
template <int D, typename T, int N>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float (&acc)[N][4],
                                           int row0, int len, const float (&mul)[2],
                                           int c0 = 0, int ld = D) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    if (r >= len) continue;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      T* out = dst + (size_t)r * ld + c0 + 8 * n + 2 * t;
      out[0] = from_f<T>(acc[n][2 * i] * mul[i]);
      out[1] = from_f<T>(acc[n][2 * i + 1] * mul[i]);
    }
  }
}

// The same with one multiplier for both rows.
template <int D, typename T, int N>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float (&acc)[N][4],
                                           int row0, int len, float mul, int c0 = 0,
                                           int ld = D) {
  const float muls[2] = {mul, mul};
  store_rows<D>(dst, acc, row0, len, muls, c0, ld);
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

// The max and the sum over the four threads of a quad (t = 0 .. 3: the
// columns of one row of a C fragment).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One step of the online softmax for a thread's two rows (g and g + 8):
// the new running max m_run from the step's row max mx (-inf where the row
// sees nothing yet), the factor alpha that rescales what was accumulated,
// and m_use, the max the step's p = exp(s - m_use) subtract (0 while the row
// has seen nothing, so that no -inf - -inf arises).
__device__ __forceinline__ void softmax_step(float (&m_run)[2], const float (&mx)[2],
                                             float (&alpha)[2], float (&m_use)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m_run[i], mx[i]);
    m_use[i] = m_new == -INFINITY ? 0.f : m_new;
    alpha[i] = fast_exp2((m_run[i] - m_use[i]) * kLog2e);
    m_run[i] = m_new;
  }
}

__device__ __forceinline__ float softmax_p(float x, float m_use) {
  return x == -INFINITY ? 0.f : fast_exp2((x - m_use) * kLog2e);
}

// The forward's output: rows row0 + g, row0 + g + 8 of o (columns c0 ..)
// as acc / l, l the row sums summed over the quad; and, where write_lse,
// their logsumexp m + log(l) (+inf for a row that saw no key, whose output
// is 0).
template <int D, typename T, int N>
__device__ __forceinline__ void store_fwd(T* __restrict__ o, float* __restrict__ lse,
                                          const float (&acc)[N][4], const float (&m_run)[2],
                                          const float (&l_run)[2], int row0, int len,
                                          bool write_lse, int c0 = 0, int ld = D) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  float l[2], inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l_run[i]);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
  store_rows<D>(o, acc, row0, len, inv, c0, ld);
  if (write_lse && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + g + 8 * i;
      if (r < len) lse[r] = l[i] > 0.f ? m_run[i] + logf(l[i]) : INFINITY;
    }
  }
}

// The forward up to D = 128: one block of 4 warps owns (b, h, a tile of 64
// queries), keeps Q, and walks the key tiles its mask names, K and V
// through the ring, query tiles last first (under causal the heaviest
// first). Each warp computes its 16 queries' score tile s = Q K^T over the
// tile's keys (64 a step at D = 64, 32 at D = 128) in C fragments, runs the
// online softmax on them (a thread's rows g
// and g + 8: the row max is a quad shuffle, the row sums stay a thread's own
// until the end), rescales its (16, D) accumulator and adds p v, p passed
// from C to A fragments in registers (frag_a_of_c).
template <int D, typename T, typename Mask>
__device__ __forceinline__ void attn_fwd(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, T* __restrict__ o,
                                         float* __restrict__ lse, const Mask& m) {
  // Keys a softmax step: the tile's 64 at D = 64, 32 at D = 128, where the
  // (16, 128) accumulator takes 64 registers a thread (with 64 keys the
  // instances spilled at 255 registers).
  constexpr int LD = tile_ld<D>(), NT = D == 64 ? 8 : 4;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int KG = kSplit ? (D == 64 ? 8 : 4) : 2;  // the score chains, as in score_tiles
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // (64, LD) queries
  float* Ks = Qs + kTile * LD;                   // two stages of (64, LD) keys
  float* Vs = Ks + 2 * kTile * LD;               // two stages of (64, LD) values
  __shared__ int seg_k[2][kTile];

  const int bh = block_bh();
  if (bh >= m.batch * m.heads) return;
  const int len = m.len, qt = m.n_tiles - 1 - blockIdx.x, b = bh / m.heads, h = bh % m.heads;
  const size_t base = (size_t)bh * len * D;
  const int q0 = qt * kTile, r0 = threadIdx.x / 32 * 16;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int n_kv = m.n_kv(qt);
  const int seg_r[2] = {m.seg_at(b, q0 + r0 + g, -1), m.seg_at(b, q0 + r0 + g + 8, -1)};
  bool full;

  load_tile<D>(Qs, q + base, q0, len);
  if (n_kv > 0) {
    const int k0 = m.kv_tile(qt, 0, full) * kTile;
    load_tile<D>(Ks, k + base, k0, len);
    load_tile<D>(Vs, v + base, k0, len);
    if (threadIdx.x < kTile) seg_k[0][threadIdx.x] = m.seg_at(b, k0 + threadIdx.x, -2);
  }
  cp_async_commit();

  float acc[D / 8][4] = {};
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
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
    __syncthreads();  // tile n and (n = 0) Q are in shared memory

    const float* Kc = Ks + cur * kTile * LD;
    const float* Vc = Vs + cur * kTile * LD;
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += 8 * NT) {
      float s[NT][4];
      asm volatile("" ::: "memory");  // the kept tile's loads stay here, not in registers
      product_t<D, NT, KG, kSplit>(s, Qs, Kc, r0, c0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = c0 + 8 * j + 2 * t + (e & 1);
          s[j][e] = m.score(b, h, q0 + r0 + g + 8 * (e >> 1), k0 + kc, s[j][e], full,
                            seg_r[e >> 1], seg_k[cur][kc]);
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);
      float alpha[2], m_use[2];
      softmax_step(m_run, mx, alpha, m_use);
#pragma unroll
      for (int i = 0; i < 2; ++i) l_run[i] *= alpha[i];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = softmax_p(s[j][e], m_use[e >> 1]);
          l_run[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n8][e] *= alpha[e >> 1];
      accumulate<D, NT, kSplit>(acc, s, Vc, c0);  // o += p v
    }
    if (n + 1 < n_kv && threadIdx.x < kTile) seg_k[nxt][threadIdx.x] = next_seg;
    __syncthreads();  // every warp is done with stage cur before tile n + 2 lands in it
  }
  cp_async_wait<0>();

  store_fwd<D>(o + base, lse + (size_t)bh * len, acc, m_run, l_run, q0 + r0, len, true);
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
  constexpr int LD = tile_ld<D>(), NT = D == 64 ? 8 : 1;
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
  constexpr int LD = tile_ld<D>(), NT = D == 64 ? 8 : 4;
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

// --- above D = 128 -----------------------------------------------------------
//
// At D = 128 a warp's (16, D) accumulators take 64 registers a thread for
// each output, and the tiles 202,752 B of shared memory; both grow with D.
// From D = 256 to 1024 the forward and the backward are
// flash_attn_fwd_wide.cuh's and flash_attn_bwd_wide.cuh's: the D slices of
// a tile, 128 columns each, in one thread block cluster, the partial scores
// summed over distributed shared memory. Above 1024, where such a cluster
// would pass the portable 8 blocks, they are the sliced bodies below
// (attn_fwd_wide, attn_bwd_dkv_wide, attn_bwd_dq_wide).
//
// There no block holds a row's D columns: 16 kept rows and 32 walked ones
// at a stride of D + 4 floats pass a block's 232,448 B at D = 590. D is cut
// into slices of kSliceDim = 256 columns (the last one zero-padded when
// kSliceDim does not divide D), and each (tile, slice) pair is a block of
// its own (blockIdx.x = tile * n_slices + slice; one template at D = 256
// serves every D, the slice count a runtime value). Each block computes its
// score tiles over all of D, slice by slice in order (each slice's q, k, v
// or do columns loaded in turn into the step's tiles; the kept rows are
// loaded again with them), then accumulates and writes only its own slice
// of o, dk and dv, or dq, reloading that slice of the walked rows first
// where the last slice loaded was another. Every block of a tile computes
// the same scores in the same order, so their p, and in the forward their
// running max and row sums, agree bit for bit: slice 0 alone writes the
// logsumexp and the bias's grad ds, and each output element still has one
// writer. The cost: every block does the score products over all of D, so
// with S = ceil(D / 256) slices the forward does (S + 1) / 2 times the
// products of an unsliced one, dK/dV (2 S + 2) / 4 and dQ (2 S + 1) / 3 (at
// D = 2048, S = 8: 4.5x, 4.5x and 5.7x), and loads of q and k, or of all
// four, grow the same way. The forward keeps R = 32 rows of its tile at a
// time (its two parts in turn) and the backward kWideRows = 16 (four
// parts), with D / 64 warps of 64 columns: each warp computes whole 16 x 8
// score tiles over D (its row group's W / 8 of them shared out over the
// group's warps), and p (and ds) pass through shared memory as A fragments
// (float4 a lane: the C fragment in frag_a_of_c's order) that every warp of
// the group reads for its chunk of the output. The forward's row maxima go
// through shared memory too, so that every warp of a row group rescales by
// the same factor.

// A score tile's C fragment c (p or ds) as the A fragment its consumer reads.
__device__ __forceinline__ float4 frag_of_c(const float (&c)[4]) {
  return make_float4(c[0], c[2], c[1], c[3]);
}

// acc (the warp's 16 rows by the 64 columns c0 .., as 8 C fragments) += P B
// over the W walked rows: P the (16, W) fragments frags[j * 32 + lane] of
// 8-row step j (frag_of_c), B rows 0 .. W - 1 of a row-major (W, tile_ld)
// tile. Each step's terms are summed apart and added in f32, as in
// accumulate.
// The steps unroll by kUnroll: 2 in the sliced backward, 1 in the forward,
// where a second step's fragments took the D = 256 bf16 and f16 instances 8
// bytes of stack at 255 registers.
template <int D, int W, bool kSplitB, int kUnroll = 2>
__device__ __forceinline__ void accumulate_wide(float (&acc)[8][4], const float4* frags,
                                                const float* B, int c0) {
  constexpr int LD = tile_ld<D>(), G = 4;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n0 = 0; n0 < 8; n0 += G) {
    float part[G][4] = {};
#pragma unroll kUnroll
    for (int j = 0; j < W / 8; ++j) {
      const float4 f = frags[j * 32 + lane];
      uint32_t ah[4], al[4];
      split_tf32<true>(f.x, ah[0], al[0]);
      split_tf32<true>(f.y, ah[1], al[1]);
      split_tf32<true>(f.z, ah[2], al[2]);
      split_tf32<true>(f.w, ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < G; ++n) {
        uint32_t bh[2], bl[2];
        frag_b_perm<LD, kSplitB>(bh, bl, B, 8 * j, c0 + 8 * (n0 + n));
        mma_split<true, kSplitB>(part[n], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int n = 0; n < G; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
  }
}

// Where the sliced bodies are: the tile (query or key) and the D slice of
// this block, the slices, and the row stride of q, k, v.
struct WidePlace {
  int tile, slice, n_slices, ld;
};

template <typename Mask>
__device__ __forceinline__ WidePlace wide_place(const Mask& m) {
  const int tile = blockIdx.x / m.n_slices;
  return {tile, (int)blockIdx.x - tile * m.n_slices, m.n_slices, m.head_dim};
}

// Rows row0 .. of slice j (columns D j ..) of an (L, ld) slab into a
// (ROWS, tile_ld) tile, zeros past column ld.
template <int D, typename T, int ROWS, int THREADS>
__device__ __forceinline__ void load_part(float* dst, const T* __restrict__ src, int row0,
                                          int len, const WidePlace& at, int j) {
  load_tile<D, T, ROWS, THREADS, true>(dst, src, row0, len, at.ld, j * D);
}

// The forward above D = 1024: one block owns (b, h, a tile of 64 queries,
// one D slice of it) and takes it in parts of R = FwdWide::kR queries, each
// over every key tile its mask names. Warp (rg, cg) keeps o's rows 16 rg ..
// and columns 64 cg .. of the part's slice. Each walked step: the row
// group's score tiles over D, slice by slice in order, their row maxima
// through shared memory, the online softmax, p as A fragments through
// shared memory, o += p v.
template <int D, typename T, typename Mask>
__device__ __forceinline__ void attn_fwd_wide(const T* __restrict__ q, const T* __restrict__ k,
                                              const T* __restrict__ v, T* __restrict__ o,
                                              float* __restrict__ lse, const Mask& m) {
  using F = FwdWide<D>;
  constexpr int LD = tile_ld<D>(), R = F::kR, W = F::kW, NS = F::kNS, NWC = F::kNWC;
  constexpr int TPW = F::kTPW, NTH = F::kThreads;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int KG = 2;  // chains of 6 mma in f32: with 12 the f32 instances spilled
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);                   // (R, LD) queries
  float* Ks = Qs + R * LD;                                        // (W, LD) keys
  float* Vs = Ks + W * LD;                                        // (W, LD) values
  float4* Pf = reinterpret_cast<float4*>(Vs + W * LD);            // (NRG, NS, 32) p
  float* tile_max = reinterpret_cast<float*>(Pf + F::kNRG * NS * 32);  // (NRG, NS, 16)
  __shared__ int seg_q[kTile], seg_k[kTile];

  const int bh = block_bh();
  if (bh >= m.batch * m.heads) return;
  const WidePlace at = wide_place(m);
  const int len = m.len, qt = m.n_tiles - 1 - at.tile, b = bh / m.heads, h = bh % m.heads;
  const size_t base = (size_t)bh * len * at.ld;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int rg = warp / NWC, cg = warp % NWC, r0 = 16 * rg;
  const int g = lane >> 2, t = lane & 3;
  const int c_out = at.slice * D + 64 * cg;  // the warp's first column of o
  float4* Pr = Pf + rg * NS * 32;                  // the row group's fragments
  float* max_r = tile_max + rg * NS * 16;          // and row maxima
  const float* Qr = Qs + r0 * LD;                  // and queries
  const int n_kv = m.n_kv(qt);

  for (int part = 0; part < kTile / R; ++part) {
    const int q0 = qt * kTile + part * R;
    __syncthreads();  // the previous part's Qs and seg_q are read
    if (threadIdx.x < R) seg_q[threadIdx.x] = m.seg_at(b, q0 + threadIdx.x, -1);
    float acc[8][4] = {};
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    for (int n = 0; n < n_kv; ++n) {
      bool full;
      const int kt0 = m.kv_tile(qt, n, full) * kTile;
      for (int wp = 0; wp < kTile / W; ++wp) {
        const int k0 = kt0 + wp * W;
        __syncthreads();  // the previous step's tiles, fragments and maxima are read
        if (threadIdx.x < W) seg_k[threadIdx.x] = m.seg_at(b, k0 + threadIdx.x, -2);
        // this slice of V comes with the first slice's Q and K
        load_part<D, T, W, NTH>(Vs, v + base, k0, len, at, at.slice);
        float s[TPW][4] = {};
        for (int j = 0; j < at.n_slices; ++j) {  // s = q k^T over D, slice by slice
          if (j > 0) __syncthreads();  // slice j - 1's Qs and Ks are read
          load_part<D, T, R, NTH>(Qs, q + base, q0, len, at, j);
          load_part<D, T, W, NTH>(Ks, k + base, k0, len, at, j);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
#pragma unroll
          for (int i = 0; i < TPW; ++i) {
            const int jt = cg + NWC * i;
            if (jt < NS) {
              float x[1][4];
              asm volatile("" ::: "memory");
              product_t<D, 1, KG, kSplit>(x, Qr, Ks, 0, 8 * jt);
#pragma unroll
              for (int e = 0; e < 4; ++e) s[i][e] += x[0][e];
            }
          }
        }
#pragma unroll
        for (int i = 0; i < TPW; ++i) {  // the masked scores and each tile's row maxima
          const int jt = cg + NWC * i;
          if (jt < NS) {
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int rl = r0 + g + 8 * (e >> 1), kc = 8 * jt + 2 * t + (e & 1);
              s[i][e] = m.score(b, h, q0 + rl, k0 + kc, s[i][e], full, seg_q[rl], seg_k[kc]);
              mx[e >> 1] = fmaxf(mx[e >> 1], s[i][e]);
            }
            mx[0] = quad_max(mx[0]);
            mx[1] = quad_max(mx[1]);
            if (t == 0) {
              max_r[jt * 16 + g] = mx[0];
              max_r[jt * 16 + g + 8] = mx[1];
            }
          }
        }
        __syncthreads();  // the maxima
        float mx[2] = {-INFINITY, -INFINITY}, alpha[2], m_use[2];
#pragma unroll
        for (int jt = 0; jt < NS; ++jt) {
          mx[0] = fmaxf(mx[0], max_r[jt * 16 + g]);
          mx[1] = fmaxf(mx[1], max_r[jt * 16 + g + 8]);
        }
        softmax_step(m_run, mx, alpha, m_use);
#pragma unroll
        for (int i = 0; i < TPW; ++i) {
          const int jt = cg + NWC * i;
          if (jt < NS) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[i][e] = softmax_p(s[i][e], m_use[e >> 1]);
            Pr[jt * 32 + lane] = frag_of_c(s[i]);
          }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 2; ++i) l_run[i] *= alpha[i];
#pragma unroll
        for (int jt = 0; jt < NS; ++jt) {  // the row sums, from the fragments every warp reads
          const float4 f = Pr[jt * 32 + lane];
          l_run[0] += f.x + f.z;
          l_run[1] += f.y + f.w;
        }
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n8][e] *= alpha[e >> 1];
        accumulate_wide<D, W, kSplit, 1>(acc, Pr, Vs, 64 * cg);  // o += p v
      }
    }
    if (c_out < at.ld)
      store_fwd<D>(o + base, lse + (size_t)bh * len, acc, m_run, l_run, q0 + r0, len,
                   at.slice == 0 && cg == 0, c_out, at.ld);
  }
}

// A walked step's s and dp tiles over all of D for the sliced backward:
// the kept rows' tiles A1 (s) and A2 (dp) against the walked rows' B1 and
// B2, slice by slice (each slice's four tiles loaded in turn from a1, b1,
// a2, b2: kept rows R from a0, walked W from b0), for the warp's score
// tiles jt = warp + NW i.
template <int D, typename T, int TPW, bool kSplit>
__device__ __forceinline__ void wide_scores(float (&s)[TPW][4], float (&dp)[TPW][4], float* A1,
                                            float* B1, float* A2, float* B2,
                                            const T* __restrict__ a1, const T* __restrict__ b1,
                                            const T* __restrict__ a2, const T* __restrict__ b2,
                                            int a0, int b0, int len, const WidePlace& at) {
  constexpr int R = kWideRows, W = wide_walk<D>(), NS = W / 8, NW = D / 64;
  constexpr int NTH = body_threads<D>();
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < TPW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
  for (int j = 0; j < at.n_slices; ++j) {
    if (j > 0) __syncthreads();  // slice j - 1's tiles are read
    load_part<D, T, R, NTH>(A1, a1, a0, len, at, j);
    load_part<D, T, R, NTH>(A2, a2, a0, len, at, j);
    load_part<D, T, W, NTH>(B1, b1, b0, len, at, j);
    load_part<D, T, W, NTH>(B2, b2, b0, len, at, j);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int jt = warp + NW * i;
      if (jt < NS) {
        float x[1][4], y[1][4];
        asm volatile("" ::: "memory");
        score_tiles<D, 1, kSplit>(x, y, A1, B1, A2, B2, 0, 8 * jt);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][e] += x[0][e];
          dp[i][e] += y[0][e];
        }
      }
    }
  }
}

// dK/dV above D = 1024: one block owns (b, h, a tile of 64 keys, one D
// slice of it) and takes its four parts of 16 keys in turn, each over every
// query tile its mask names.
template <int D, typename T, typename Mask>
__device__ __forceinline__ void attn_bwd_dkv_wide(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, const Mask& m) {
  constexpr int LD = tile_ld<D>(), R = kWideRows, W = wide_walk<D>(), NS = W / 8;
  constexpr int NW = D / 64, NTH = body_threads<D>(), TPW = (NS + NW - 1) / NW;
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // (R, LD) keys
  float* Vs = Ks + R * LD;                       // (R, LD) values
  float* Qs = Vs + R * LD;                       // (W, LD) queries
  float* dOs = Qs + W * LD;                      // (W, LD) output grads
  float4* Pf = reinterpret_cast<float4*>(dOs + W * LD);  // (NS, 32) fragments of p^T
  float4* DSf = Pf + NS * 32;                             // and of ds^T
  __shared__ float lse_s[kTile], delta_s[kTile];
  __shared__ int seg_q[kTile], seg_k[kTile];

  const int bh = block_bh();
  if (bh >= m.batch * m.heads) return;
  const WidePlace at = wide_place(m);
  const int len = m.len, kt = at.tile, b = bh / m.heads, h = bh % m.heads;
  const size_t base = (size_t)bh * len * at.ld, row_base = (size_t)bh * len;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c_out = at.slice * D + 64 * warp;  // the warp's first column of dk and dv
  const int n_q = m.n_q(kt);

  for (int part = 0; part < kTile / R; ++part) {
    const int k0 = kt * kTile + part * R;
    __syncthreads();  // the previous part's Ks, Vs and seg_k are read
    m.load_seg(seg_k, b, k0, -2);
    float acc_dk[8][4] = {}, acc_dv[8][4] = {};
    for (int n = 0; n < n_q; ++n) {
      bool full;
      const int qt0 = m.q_tile(kt, n, full) * kTile;
      for (int wp = 0; wp < kTile / W; ++wp) {
        const int q0 = qt0 + wp * W;
        __syncthreads();  // the previous step's Qs, dOs, fragments and statistics are read
        if (threadIdx.x < W) {
          const RowStats st = row_stats(m, lse, delta, b, row_base, q0 + threadIdx.x);
          lse_s[threadIdx.x] = st.lse;
          delta_s[threadIdx.x] = st.delta;
          seg_q[threadIdx.x] = st.seg;
        }
        // s^T, dp^T of the 16 keys, queries 8 jt .., to p^T and ds^T fragments
        auto grads = [&](float (&s)[4], float (&dp)[4], int jt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kr = g + 8 * (e >> 1), qc = 8 * jt + 2 * t + (e & 1);
            const float x = m.score(b, h, q0 + qc, k0 + kr, s[e], full, seg_q[qc], seg_k[kr]);
            const float p = x == -INFINITY ? 0.f : fast_exp2((x - lse_s[qc]) * kLog2e);
            s[e] = p;
            dp[e] = p * (dp[e] - delta_s[qc]);
          }
          Pf[jt * 32 + lane] = frag_of_c(s);
          DSf[jt * 32 + lane] = frag_of_c(dp);
        };
        float s[TPW][4], dp[TPW][4];
        wide_scores<D, T, TPW, kSplit>(s, dp, Ks, Qs, Vs, dOs, k + base, q + base, v + base,
                                       dout + base, k0, q0, len, at);
        if (at.slice != at.n_slices - 1) {  // this slice's q and do for the products
          __syncthreads();
          load_part<D, T, W, NTH>(Qs, q + base, q0, len, at, at.slice);
          load_part<D, T, W, NTH>(dOs, dout + base, q0, len, at, at.slice);
          cp_async_commit();
          cp_async_wait<0>();
        }
#pragma unroll
        for (int i = 0; i < TPW; ++i)
          if (warp + NW * i < NS) grads(s[i], dp[i], warp + NW * i);
        __syncthreads();
        accumulate_wide<D, W, kSplit>(acc_dv, Pf, dOs, 64 * warp);   // dv += p^T do
        accumulate_wide<D, W, kSplit>(acc_dk, DSf, Qs, 64 * warp);   // dk += ds^T q
      }
    }
    if (c_out < at.ld) {
      store_rows<D>(dk + base, acc_dk, k0, len, m.scale, c_out, at.ld);
      store_rows<D>(dv + base, acc_dv, k0, len, 1.f, c_out, at.ld);
    }
  }
}

// dQ above D = 1024: one block owns (b, h, a tile of 64 queries, one D
// slice of it) and takes its four parts of 16 queries in turn, each over
// every key tile its mask names.
template <int D, typename T, typename Mask>
__device__ __forceinline__ void attn_bwd_dq_wide(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, float* __restrict__ ds_out, const Mask& m) {
  constexpr int LD = tile_ld<D>(), R = kWideRows, W = wide_walk<D>(), NS = W / 8;
  constexpr int NW = D / 64, NTH = body_threads<D>(), TPW = (NS + NW - 1) / NW;
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // (R, LD) queries
  float* dOs = Qs + R * LD;                      // (R, LD) output grads
  float* Ks = dOs + R * LD;                      // (W, LD) keys
  float* Vs = Ks + W * LD;                       // (W, LD) values
  float4* DSf = reinterpret_cast<float4*>(Vs + W * LD);  // (NS, 32) fragments of ds
  __shared__ float lse_s[kWideRows], delta_s[kWideRows];
  __shared__ int seg_q[kWideRows], seg_k[kTile];

  const int bh = block_bh();
  if (bh >= m.batch * m.heads) return;
  const WidePlace at = wide_place(m);
  const int len = m.len, qt = m.n_tiles - 1 - at.tile, b = bh / m.heads, h = bh % m.heads;
  const size_t base = (size_t)bh * len * at.ld, row_base = (size_t)bh * len;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c_out = at.slice * D + 64 * warp;  // the warp's first column of dq
  const bool write_ds = ds_out != nullptr && at.slice == 0;
  const int n_kv = m.n_kv(qt);

  for (int part = 0; part < kTile / R; ++part) {
    const int q0 = qt * kTile + part * R;
    __syncthreads();  // the previous part's Qs, dOs and statistics are read
    if (threadIdx.x < R) {
      const RowStats st = row_stats(m, lse, delta, b, row_base, q0 + threadIdx.x);
      lse_s[threadIdx.x] = st.lse;
      delta_s[threadIdx.x] = st.delta;
      seg_q[threadIdx.x] = st.seg;
    }
    float acc[8][4] = {};
    for (int n = 0; n < n_kv; ++n) {
      bool full;
      const int kt0 = m.kv_tile(qt, n, full) * kTile;
      for (int wp = 0; wp < kTile / W; ++wp) {
        const int k0 = kt0 + wp * W;
        __syncthreads();  // the previous step's Ks, Vs, fragments and seg_k are read
        if (threadIdx.x < W) seg_k[threadIdx.x] = m.seg_at(b, k0 + threadIdx.x, -2);
        // s, dp of the 16 queries, keys 8 jt .., to ds fragments (and ds_out)
        auto grads = [&](const float (&s)[4], float (&dp)[4], int jt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rl = g + 8 * (e >> 1), kc = 8 * jt + 2 * t + (e & 1);
            const int r = q0 + rl, c = k0 + kc;
            const float x = m.score(b, h, r, c, s[e], full, seg_q[rl], seg_k[kc]);
            const float p = x == -INFINITY ? 0.f : fast_exp2((x - lse_s[rl]) * kLog2e);
            dp[e] = p * (dp[e] - delta_s[rl]);
            if (write_ds && r < len && c < len) ds_out[(row_base + r) * len + c] = dp[e];
          }
          DSf[jt * 32 + lane] = frag_of_c(dp);
        };
        float s[TPW][4], dp[TPW][4];
        wide_scores<D, T, TPW, kSplit>(s, dp, Qs, Ks, dOs, Vs, q + base, k + base,
                                       dout + base, v + base, q0, k0, len, at);
        if (at.slice != at.n_slices - 1) {  // this slice's k for the product
          __syncthreads();
          load_part<D, T, W, NTH>(Ks, k + base, k0, len, at, at.slice);
          cp_async_commit();
          cp_async_wait<0>();
        }
#pragma unroll
        for (int i = 0; i < TPW; ++i)
          if (warp + NW * i < NS) grads(s[i], dp[i], warp + NW * i);
        __syncthreads();
        accumulate_wide<D, W, kSplit>(acc, DSf, Ks, 64 * warp);  // dq += ds k
      }
    }
    if (c_out < at.ld) store_rows<D>(dq + base, acc, q0, len, m.scale, c_out, at.ld);
  }
}

// The bodies for the head_dims of this file: D = 64 and 128 narrow, above
// 1024 (SL) in slices of D = kSliceDim columns (from 256 to 1024 the
// clustered bodies of flash_attn_fwd_wide.cuh and flash_attn_bwd_wide.cuh).
template <int D, bool SL, typename T, typename Mask>
__device__ __forceinline__ void fwd(const T* __restrict__ q, const T* __restrict__ k,
                                    const T* __restrict__ v, T* __restrict__ o,
                                    float* __restrict__ lse, const Mask& m) {
  static_assert(D <= 128 || SL, "the unsliced wide forward is flash_attn_fwd_wide.cuh's");
  if constexpr (D <= 128)
    attn_fwd<D, T>(q, k, v, o, lse, m);
  else
    attn_fwd_wide<D, T, Mask>(q, k, v, o, lse, m);
}

template <int D, bool SL, typename T, typename Mask>
__device__ __forceinline__ void bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v, const T* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta, T* __restrict__ dk,
                                        T* __restrict__ dv, const Mask& m) {
  static_assert(D <= 128 || SL, "the unsliced wide backward is flash_attn_bwd_wide.cuh's");
  if constexpr (D <= 128)
    attn_bwd_dkv<D, T>(q, k, v, dout, lse, delta, dk, dv, m);
  else
    attn_bwd_dkv_wide<D, T, Mask>(q, k, v, dout, lse, delta, dk, dv, m);
}

template <int D, bool SL, typename T, typename Mask>
__device__ __forceinline__ void bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                                       const T* __restrict__ v, const T* __restrict__ dout,
                                       const float* __restrict__ lse,
                                       const float* __restrict__ delta, T* __restrict__ dq,
                                       float* __restrict__ ds_out, const Mask& m) {
  static_assert(D <= 128 || SL, "the unsliced wide backward is flash_attn_bwd_wide.cuh's");
  if constexpr (D <= 128)
    attn_bwd_dq<D, T>(q, k, v, dout, lse, delta, dq, ds_out, m);
  else
    attn_bwd_dq_wide<D, T, Mask>(q, k, v, dout, lse, delta, dq, ds_out, m);
}

// --- launching ---------------------------------------------------------------

// A kernel instance's head_dim: D columns a block, and with SL D slices of
// a wider head.
template <int D, bool SL = false>
struct HeadDim {
  static constexpr int value = D;
  static constexpr bool sliced = SL;
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

// f(HeadDim{}, T{}) for the head_dims of this file's bodies (64, 128, or
// any multiple of 128 above kMaxClustered, in slices of kSliceDim; 256 to
// 1024 launch the clustered bodies) and the operands' dtype (DType: f32,
// bf16 or f16); an invalid value for any other.
template <typename F>
cudaError_t dispatch(int head_dim, int dtype, F f) {
  if (head_dim == 64) return dispatch_dtype(dtype, HeadDim<64>{}, f);
  if (head_dim == 128) return dispatch_dtype(dtype, HeadDim<128>{}, f);
  if (head_dim > kMaxClustered && head_dim % 128 == 0)
    return dispatch_dtype(dtype, HeadDim<kSliceDim, true>{}, f);
  return cudaErrorInvalidValue;
}

constexpr int kMaxGridY = 65535;

// kernel on the (tiles of L times D slices, B * H) grid of `threads`
// threads with `smem` bytes of dynamic shared memory, its arguments cast to
// the kernel's own types. B * H is folded over gridDim.y (at most 65535) and
// gridDim.z (block_bh); blockIdx.x is the tile (times the slices, and the
// slice: wide_place).
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), int threads, size_t smem, int len, int batch_heads,
                   int slices, cudaStream_t stream, A... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int z = (batch_heads + kMaxGridY - 1) / kMaxGridY;  // at most z - 1 idle columns
  const dim3 grid((len + kTile - 1) / kTile * slices, (batch_heads + z - 1) / z, z);
  kernel<<<grid, threads, smem, stream>>>(((P)args)...);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace ffc
