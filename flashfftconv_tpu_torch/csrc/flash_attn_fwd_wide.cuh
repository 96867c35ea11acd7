// The attention forward above head_dim 128, up to 1024: o and the row
// logsumexp on warpgroup products (wgmma) in thread block clusters.
// flash_attn.cu runs it under FlashMask, splash_attn.cu under SplashMask;
// above 1024 both keep the D-sliced body attn_fwd_wide of
// flash_attn_common.cuh, and at 64 and 128 attn_fwd.
//
// A cluster of S = D / 128 blocks owns (b, h, a tile of 64 queries), the
// query tiles of the last (heaviest) rows launched first. Block s of the
// cluster (its rank) holds columns 128 s .. 128 s + 127 of the tile's
// queries and walks the same columns of the key tiles its mask names, one
// whole tile of 64 keys a step. A block has two warpgroups. The queries stay
// in shared memory for the whole walk (with their lo part in f32, made
// once); K and V come one stage each, in f32 by TMA (K as soon as every warp
// has read the last one, each warpgroup's 64 columns of V as soon as that
// warpgroup has), in bf16 and f16 through registers, converted on the way
// in. The 64 query rows are cut into S pieces of whole 8-row groups, and
// block j owns piece j. For key tile n:
//  A. the partial scores over the block's columns, transposed: warpgroup w
//     computes s^T = K Q^T for the 64 keys by queries 32 w .. 32 w + 31
//     (wgmma m64n32k8 TF32, A the key tile in registers, B the queries in
//     shared memory; 4 groups of 4 k-steps, each issued before the last is
//     waited for), stages them in p's layout, and sends each other block's
//     piece, one contiguous run, into that block's receive buffer by a bulk
//     copy (cp.async.bulk shared::cta to shared::cluster) that the
//     receiver's mbarrier counts;
//  D. block j adds the S partials of its rows in slice order, masks, and
//     runs the online softmax on them (the running max, the factor alpha
//     that rescales what was accumulated, the row sums l), writes its rows
//     of p and their alpha over its own partials, and bulk-copies them into
//     every other block, counted there by a second mbarrier;
//  B. once they are in, every block holds the same p, bit for bit, and
//     makes its lo part itself;
//  C. o^T = o^T alpha + V^T p^T (wgmma m64n64k8, A this block's V read
//     transposed from shared memory into registers, B p in shared memory):
//     warpgroup w keeps 64-column chunk w of the block's o^T.
// The steps are pipelined two deep: step n runs A for tile n + 1, then B
// and C for tile n, then D for tile n + 1, so that the scores run while p
// flies and the products while the partials do. Partials, p, alpha and the
// mbarriers have a stage for each parity of n; a block's partials of a tile
// reach an owner only after every owner's p of the tile two before, which
// follow their reads of that stage, so no cluster barrier is needed in the
// walk. At the end each owner sends its rows' l to every block and writes
// their logsumexp, and every block writes its 128 columns of o = o / l. So
// the scores are computed once, not once a slice, each K and V tile is
// loaded once a query tile, every output element has one writer, no
// atomics, and the bits do not depend on timing.
//
// TF32 operands of wgmma are K-major in shared memory: the queries lie in
// walked_at<64>'s order (4 columns of every row in turn), p with the keys
// as columns in core matrices of 8 rows (p_at). The scores take the queries
// as B and K as A, so that only the queries need a lo tile in shared
// memory, made once; the o product takes V as A, read transposed. K and V
// are read only into registers, so they lie as TMA writes 32-column boxes
// with the 128-byte swizzle (kv_at): a box row is 128 bytes, where boxes of
// 4-column rows (16 bytes) moved the tiles at a fraction of the rate, and
// the fragment reads stay on distinct banks. f32 accuracy as in
// flash_attn_bwd_wide.cuh: lo b_hi + hi b_lo + hi b_hi, each group of 4
// k-steps summed apart and added in f32.
//
// Bound on the H100 at the @640 shape of chip_smoke.py's timing (B=4, H=8,
// L=2048, D=640, f32, causal): q k^T and p v over the causal half (171.8
// GFLOP, 2 a multiply-add) take 1.04 ms as three TF32 passes at 494.7
// TFLOP/s, against 0.28 ms for its bytes (q, k, v read once, o and the
// logsumexp written once at 3.35 TB/s): operations. Shared memory a block:
// 232,320 B in f32 (the queries and their lo 65,536, K and V 65,536, two
// stages of p and a lo 49,152, two stages of the receive buffer 49,152,
// alignment slack 1,024, static 1,920), so one block an SM, 256 threads.
#pragma once

#include "flash_attn_bwd_wide.cuh"

namespace ffc {
namespace attn {

constexpr int kFwdWalk = kTile;                  // walked keys a step: a whole key tile
constexpr int kFwdTileFloats = kTile * kWgDim;   // the queries, K or V of a block
constexpr int kFwdPFloats = kTile * kFwdWalk;    // p: 64 queries by 64 keys

// The rows of the largest piece of a cluster of S (whole 8-row groups,
// ceil(8 / S) of them), and a stage of the receive buffer: S - 1 pieces'
// partials from the other blocks, the most over the cluster sizes (6144
// floats, at S = 7, whose pieces are 16 rows and 8).
__host__ __device__ constexpr int piece_rows(int S) { return 8 * ((8 + S - 1) / S); }
constexpr int fwd_recv_floats() {
  int most = 0;
  for (int s = 2; s <= kMaxCluster; ++s) {
    const int f = (s - 1) * piece_rows(s) * kFwdWalk;
    most = f > most ? f : most;
  }
  return most;
}
constexpr int kFwdRecvFloats = fwd_recv_floats();

// Shared memory a block, with 1024 bytes of slack to align K and V.
template <bool kSplit>
constexpr size_t wg_fwd_smem_bytes() {
  return ((kSplit ? 4 : 3) * kFwdTileFloats + 3 * kFwdPFloats + 2 * kFwdRecvFloats) *
             sizeof(float) +
         1024;
}

// The block's 128 columns of query rows row0 .. row0 + 63 of an (L, ld)
// slab into hi (the values; the tensor cores read them truncated to TF32)
// and, in f32, lo = x - trunc(x), both in walked_at<64>'s order, zeros past
// L. bf16 and f16 are exact in TF32: no lo.
template <typename T>
__device__ __forceinline__ void load_queries(float* hi, float* lo, const T* __restrict__ src,
                                             int row0, int len, int ld, int col0) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll 2
    for (int i = threadIdx.x; i < kTile * kWgDim / 4; i += kWgThreads) {
      const int r = i & (kTile - 1), c = (i / kTile) * 4;
      const float4 x =
          row0 + r < len
              ? *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * ld + col0 + c)
              : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(hi + walked_at<kTile>(r, c)) = x;
      *reinterpret_cast<float4*>(lo + walked_at<kTile>(r, c)) = tf32_lo(x);
    }
  } else {
#pragma unroll 2
    for (int i = threadIdx.x; i < kTile * kWgDim / 8; i += kWgThreads) {
      const int r = i & (kTile - 1), c = (i / kTile) * 8;
      const uint4 raw =
          row0 + r < len
              ? *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + col0 + c)
              : make_uint4(0u, 0u, 0u, 0u);
      const T* h = reinterpret_cast<const T*>(&raw);
      *reinterpret_cast<float4*>(hi + walked_at<kTile>(r, c)) =
          make_float4(to_f(h[0]), to_f(h[1]), to_f(h[2]), to_f(h[3]));
      *reinterpret_cast<float4*>(hi + walked_at<kTile>(r, c + 4)) =
          make_float4(to_f(h[4]), to_f(h[5]), to_f(h[6]), to_f(h[7]));
    }
  }
}

// Offset of (query q, key c) in p: K-major core matrices (8 queries by 4
// keys, 128 contiguous bytes) 128 bytes apart along the keys and 2048 along
// the queries, so that each 8-query group is a contiguous 2048 bytes.
__device__ __forceinline__ int p_at(int q, int c) {
  return (q >> 3) * (8 * kFwdWalk) + (c >> 2) * 32 + (q & 7) * 4 + (c & 3);
}

// Offset of (row r, column c) of a key or value tile (64 rows, 128 columns)
// as TMA writes it with the 128-byte swizzle (kv_map): four blocks of 32
// columns, each 64 rows of 128 bytes, the 16-byte chunk j of row r at
// j ^ (r % 8) (the tile 1024-byte aligned). A fragment read, 8 rows of a
// chunk or 8 chunks of a row, then falls on distinct banks.
__device__ __forceinline__ int kv_at(int r, int c) {
  return (c >> 5) * (kTile * 32) + r * 32 + ((((c >> 2) & 7) ^ (r & 7)) << 2) + (c & 3);
}

// A fragments of 4 k-steps (columns k0 .. k0 + 31) of a key tile's 64 rows,
// as kept_frags reads a row-major tile.
template <bool kSplit>
__device__ __forceinline__ void kv_frags(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                         const float* A, int k0) {
  const int wq = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int r = 16 * wq + g;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = k0 + 8 * kk + t;
    split_tf32<kSplit>(A[kv_at(r, c)], hi[kk][0], lo[kk][0]);
    split_tf32<kSplit>(A[kv_at(r + 8, c)], hi[kk][1], lo[kk][1]);
    split_tf32<kSplit>(A[kv_at(r, c + 4)], hi[kk][2], lo[kk][2]);
    split_tf32<kSplit>(A[kv_at(r + 8, c + 4)], hi[kk][3], lo[kk][3]);
  }
}

// A fragments of the transpose of a value tile, its rows k0 .. k0 + 31 the k
// index of 4 k-steps: the warpgroup's 64 rows are the tile's columns d0 ..
// d0 + 63.
template <bool kSplit>
__device__ __forceinline__ void kv_t_frags(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                           const float* B, int d0, int k0) {
  const int wq = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int d = d0 + 16 * wq + g;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = k0 + 8 * kk + t;
    split_tf32<kSplit>(B[kv_at(c, d)], hi[kk][0], lo[kk][0]);
    split_tf32<kSplit>(B[kv_at(c, d + 8)], hi[kk][1], lo[kk][1]);
    split_tf32<kSplit>(B[kv_at(c + 4, d)], hi[kk][2], lo[kk][2]);
    split_tf32<kSplit>(B[kv_at(c + 4, d + 8)], hi[kk][3], lo[kk][3]);
  }
}

// A warpgroup's pieces of 64 rows by 64 columns of a bf16 or f16 key or
// value tile (walked_fetch<T, 64>'s) converted and stored at dst, the
// tile's column block pair of those columns, in kv_at's order.
template <typename T>
__device__ __forceinline__ void kv_put(float* dst, const uint4 (&raw)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, c;
    walked_piece<kTile>(i, r, c);
    const T* h = reinterpret_cast<const T*>(&raw[i]);
    *reinterpret_cast<float4*>(dst + kv_at(r, c)) =
        make_float4(to_f(h[0]), to_f(h[1]), to_f(h[2]), to_f(h[3]));
    *reinterpret_cast<float4*>(dst + kv_at(r, c + 4)) =
        make_float4(to_f(h[4]), to_f(h[5]), to_f(h[6]), to_f(h[7]));
  }
}

// The max and the sum over the 4 lanes of a warp that share lane % 8 (one
// owned row).
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
}
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

// The body. Launched in clusters of S = head_dim / 128 blocks along x
// (blockIdx.x = tile * S + rank) by launch_clustered; k_map, v_map: the f32
// tensor maps of fwd_maps (unread in bf16 and f16).
template <typename T, typename Mask>
__device__ __forceinline__ void attn_fwd_wg(const T* __restrict__ q, const T* __restrict__ k,
                                            const T* __restrict__ v, T* __restrict__ o,
                                            float* __restrict__ lse, const Mask& m,
                                            const CUtensorMap* k_map, const CUtensorMap* v_map) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kHalf = kFwdTileFloats / 2;  // a warpgroup's 64 columns of V (or K)
  extern __shared__ __align__(128) float4 smem_fwd[];
  float* Ks = reinterpret_cast<float*>(smem_fwd) +  // (64 keys, 128 columns), 1024-aligned
              ((1024 - (wg::smem_addr(smem_fwd) & 1023)) & 1023) / 4;
  float* Vs = Ks + kFwdTileFloats;                   // (64 keys, 128 columns)
  float* Qh = Vs + kFwdTileFloats;                   // (64 queries, 128 columns)
  float* Ql = Qh + (kSplit ? kFwdTileFloats : 0);    // f32: their lo
  float* Ph = Ql + kFwdTileFloats;  // two stages: a tile's partials (by query row), then its p
  float* Pl = Ph + 2 * kFwdPFloats;  // the lo of the p being multiplied
  float* Rv = Pl + kFwdPFloats;      // two stages: [other slice][owned rows of p] received
  __shared__ __align__(16) float alpha_s[2][kTile];
  __shared__ float l_s[kTile];
  __shared__ float part_s[32][4];             // the owned rows' maxima (and sums) by warp
  __shared__ int seg_q[kTile], seg_k[kTile];
  __shared__ int first_row[kMaxCluster + 1];  // the first query row of each block's piece
  __shared__ uint64_t k_bar, v_bar[2];        // f32: K landed; warpgroup w's half of V
  __shared__ uint64_t r_bar[2];               // a stage's partials of the owned rows landed
  __shared__ uint64_t p_bar[2];               // a stage's p and alpha landed from every block

  const int bh = block_bh();
  if (bh >= m.batch * m.heads) return;  // the whole cluster: it shares blockIdx.y, z
  const int S = m.head_dim / kWgDim, slice = (int)blockIdx.x % S, tile = (int)blockIdx.x / S;
  const int len = m.len, ld = m.head_dim, col0 = slice * kWgDim;
  const int b = bh / m.heads, h = bh % m.heads;
  const size_t base = (size_t)bh * len * ld;
  const int tid = threadIdx.x, wgi = tid >> 7, wq = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int qt = m.n_tiles - 1 - tile, q0 = qt * kTile;
  const int n_kv = m.n_kv(qt), pr = piece_rows(S);
  auto key_row0 = [&](int n, bool& full) { return m.kv_tile(qt, n, full) * kTile; };

  if (tid <= kMaxCluster) first_row[tid] = tid <= S ? 8 * ((tid * 8 + S - 1) / S) : 0;
  if (tid < kTile) seg_q[tid] = m.seg_at(b, q0 + tid, -1);
  if (tid == 0) {
    wg::mbar_init(&k_bar);
    wg::mbar_init(&v_bar[0]);
    wg::mbar_init(&v_bar[1]);
    wg::mbar_init(&r_bar[0]);
    wg::mbar_init(&r_bar[1]);
    wg::mbar_init(&p_bar[0]);
    wg::mbar_init(&p_bar[1]);
  }
  wg::mbar_init_fence();
  load_queries<T>(Qh, Ql, q + base, q0, len, ld, col0);
  __syncthreads();

  // f32: K by one thread, each warpgroup's half of V by one of its threads,
  // completing on their mbarriers. bf16 and f16: each warpgroup fetches its
  // 64 columns of K and of V into registers, and stores them later.
  auto issue_k = [&](int n) {
    bool full;
    const int r0 = key_row0(n, full);
    wg::mbar_expect(&k_bar, kFwdTileFloats * sizeof(float));
#pragma unroll
    for (int cb = 0; cb < 4; ++cb)
      wg::tma_load_3d(Ks + cb * kTile * 32, k_map, col0 + 32 * cb, r0, bh, &k_bar);
  };
  auto issue_v = [&](int n) {
    bool full;
    const int r0 = key_row0(n, full);
    wg::mbar_expect(&v_bar[wgi], kHalf * sizeof(float));
#pragma unroll
    for (int cb = 0; cb < 2; ++cb)
      wg::tma_load_3d(Vs + wgi * kHalf + cb * kTile * 32, v_map, col0 + 64 * wgi + 32 * cb, r0,
                      bh, &v_bar[wgi]);
  };
  uint4 kraw[4], vraw[4];
  auto fetch = [&](uint4 (&raw)[4], const T* src, int n) {
    bool full;
    walked_fetch<T, kTile>(raw, src + base, key_row0(n, full), len, ld, col0 + 64 * wgi);
  };
  if (n_kv > 0) {
    if constexpr (kSplit) {
      if (tid == 0) issue_k(0);
      if ((tid & 127) == 0) issue_v(0);
    } else {
      fetch(kraw, k, 0);
      fetch(vraw, v, 0);
      kv_put<T>(Ks + wgi * kHalf, kraw);
      kv_put<T>(Vs + wgi * kHalf, vraw);
    }
  }
  wg::fence_smem_for_mma();  // the queries, for the products' B
  wg::cluster_sync();        // every block of the cluster runs, its barriers set up

  const int own0 = first_row[slice], n_own = first_row[slice + 1] - own0;
  float acc[32] = {};  // o^T: columns 64 wgi + 16 wq + g (+ 8) by queries 8 (i / 4) + 2 t + i % 2
  // The owned rows, at most 4 groups of 8: warpgroup w takes groups w and
  // w + 2 in turn (i = 0, 1), lane % 8 the row, warp wq keys 16 wq .. 16 wq
  // + 15 of it, 4 a thread (c_own); so that 8 lanes store one 4-key group of
  // 8 rows of p, 128 contiguous bytes.
  const int lane = tid & 31, c_own = 4 * (4 * wq + (lane >> 3));
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  // Step n (-1 .. n_kv - 1) computes the partial scores of key tile n + 1
  // and sends them (A), makes p of tile n whole (B), adds its p v to o (C),
  // and reduces this block's rows of tile n + 1 and sends their p (D): the
  // scores run while p flies, the products while the partials do.
  int k_next = 0;  // the first key of tile n + 1
  bool full_next = false;
  for (int n = -1; n < n_kv; ++n) {
    const int nx = n + 1;
    const bool ahead = nx < n_kv;
    float* Pn = Ph + (nx & 1) * kFwdPFloats;  // tile n + 1's stage
    float* Rn = Rv + (nx & 1) * kFwdRecvFloats;
    if (ahead) {
      k_next = key_row0(nx, full_next);
      if (tid < kFwdWalk) seg_k[tid] = m.seg_at(b, k_next + tid, -2);
      if constexpr (kSplit) wg::mbar_wait(&k_bar, nx & 1);

      // A. this slice's partial of s^T (keys by this warpgroup's 32
      // queries): four groups of 4 k-steps, each issued before the last one
      // is waited for
      float sc[16];
      {
        uint32_t ah[2][4][4], al[2][4][4];
        float part[2][16];
        const int qoff = 32 * wgi * 4;  // the warpgroup's queries in the B tiles
#pragma unroll
        for (int kg = 0; kg < 4; ++kg) {
          const int x = kg & 1;
          kv_frags<kSplit>(ah[x], al[x], Ks, 32 * kg);
          mma_issue<kSplit, kSplit>(part[x], ah[x], al[x], Qh + kg * 8 * kTile * 4 + qoff,
                                    Ql + kg * 8 * kTile * 4 + qoff, 2 * kTile * 4,
                                    kTile * 4 * 4, 128);
          if (kg > 0) {
            wg::wait<1>();
            wg::hold(part[x ^ 1]);
            wg::hold(ah[x ^ 1]);
            wg::hold(al[x ^ 1]);
#pragma unroll
            for (int i = 0; i < 16; ++i) sc[i] = kg == 1 ? part[0][i] : sc[i] + part[x ^ 1][i];
          }
        }
        wg::wait<0>();
        wg::hold(part[1]);
        wg::hold(ah[1]);
        wg::hold(al[1]);
#pragma unroll
        for (int i = 0; i < 16; ++i) sc[i] += part[1][i];
      }
      // The partials staged in p's layout, then each other block's piece of
      // rows, one contiguous run, into its receive buffer by a bulk copy
      // that its mbarrier counts (this block's own piece stays where it is,
      // and becomes its p; a piece's rows are rewritten by their p only
      // after their owner has received them).
#pragma unroll
      for (int i = 0; i < 16; ++i)
        Pn[p_at(32 * wgi + 8 * (i >> 2) + 2 * t + (i & 1), 16 * wq + g + 8 * ((i >> 1) & 1))] =
            sc[i];
      wg::fence_smem_for_mma();  // for the bulk copies
      __syncthreads();           // the partials are staged; every warp has read K
      if constexpr (kSplit) {
        if (tid == 0 && nx + 1 < n_kv) issue_k(nx + 1);
      } else {  // stored after the products below
        if (nx + 1 < n_kv) fetch(kraw, k, nx + 1);
        if (nx > 0) fetch(vraw, v, nx);
      }
      if (tid == 0) {
        wg::mbar_expect(&r_bar[nx & 1], (S - 1) * n_own * kFwdWalk * sizeof(float));
        wg::mbar_expect(&p_bar[nx & 1], (kTile - n_own) * (kFwdWalk + 1) * sizeof(float));
      }
      const int j = tid >> 5;  // a warp a destination
      if ((tid & 31) == 0 && j < S && j != slice) {
        const int r0 = first_row[j], at = slice - (slice > j);  // this block among j's others
        wg::bulk_copy_cluster(wg::map_rank(Rn + at * pr * kFwdWalk, j), Pn + r0 * kFwdWalk,
                              (first_row[j + 1] - r0) * kFwdWalk * sizeof(float),
                              wg::map_rank(&r_bar[nx & 1], j));
      }
    }

    if (n >= 0) {
      // B. p of tile n whole in this block (no cluster barrier is needed in
      // a step: a block's partials of a tile reach an owner only after every
      // owner's p of the tile two before, which follow their reads of its
      // stage), and its lo part
      const float* Pc = Ph + (n & 1) * kFwdPFloats;
      wg::mbar_wait(&p_bar[n & 1], (n >> 1) & 1);
      for (int i = tid; i < kFwdPFloats / 4; i += kWgThreads)
        reinterpret_cast<float4*>(Pl)[i] = tf32_lo(reinterpret_cast<const float4*>(Pc)[i]);
      wg::fence_smem_for_mma();
      __syncthreads();

      // C. o^T = o^T alpha + V^T p^T: chunk wgi, both groups of 4 k-steps (32
      // keys each) issued before the first is waited for
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha_s[n & 1][8 * (i >> 2) + 2 * t + (i & 1)];
      if constexpr (kSplit) wg::mbar_wait(&v_bar[wgi], n & 1);
      {
        uint32_t ah[2][4][4], al[2][4][4];
        float part[2][32];
#pragma unroll
        for (int kg = 0; kg < 2; ++kg) {
          kv_t_frags<kSplit>(ah[kg], al[kg], Vs, 64 * wgi, 32 * kg);
          mma_issue<kSplit, true>(part[kg], ah[kg], al[kg], Pc + kg * 8 * 32, Pl + kg * 8 * 32,
                                  2 * 32, 32 * 4, 8 * kFwdWalk * 4);
        }
        wg::wait<1>();
        wg::hold(part[0]);
        wg::hold(ah[0]);
        wg::hold(al[0]);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] += part[0][i];
        wg::wait<0>();
        wg::hold(part[1]);
        wg::hold(ah[1]);
        wg::hold(al[1]);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] += part[1][i];
      }
      if (ahead) {
        warpgroup_sync();  // the warpgroup's reads of its V columns are done
        if constexpr (kSplit) {
          if ((tid & 127) == 0) issue_v(nx);
        } else {
          kv_put<T>(Vs + wgi * kHalf, vraw);
        }
      }
    }
    if (!ahead) break;
    if constexpr (!kSplit) {
      if (nx + 1 < n_kv) kv_put<T>(Ks + wgi * kHalf, kraw);
    }

    // D. this block's rows of tile n + 1: the sums in slice order, the mask,
    // the online softmax, and p and alpha into this block's stage, then by
    // bulk copies into every other block's
    wg::mbar_wait(&r_bar[nx & 1], (nx >> 1) & 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int lr = 8 * (wgi + 2 * i) + (lane & 7), row = own0 + lr;
      if (lr - (lane & 7) >= n_own) break;  // the same for the whole warpgroup
      float* own = Pn + p_at(row, c_own);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j) {
        if (j < S) {
          const float* src = j == slice ? own : Rn + (j - (j > slice)) * pr * kFwdWalk +
                                                     p_at(lr, c_own);
          const float4 xa = *reinterpret_cast<const float4*>(src);
          x = j == 0 ? xa : make_float4(x.x + xa.x, x.y + xa.y, x.z + xa.z, x.w + xa.w);
        }
      }
      const float xs[4] = {x.x, x.y, x.z, x.w};
      float sv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sv[e] = m.score(b, h, q0 + row, k_next + c_own + e, xs[e], full_next, seg_q[row],
                        seg_k[c_own + e]);
      const float mw = row_max(fmaxf(fmaxf(sv[0], sv[1]), fmaxf(sv[2], sv[3])));
      if (lane < 8) part_s[lr][wq] = mw;
      warpgroup_sync();
      const float mx = fmaxf(fmaxf(part_s[lr][0], part_s[lr][1]),
                             fmaxf(part_s[lr][2], part_s[lr][3]));
      const float m_new = fmaxf(m_run[i], mx), m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = fast_exp2((m_run[i] - m_use) * kLog2e);
      m_run[i] = m_new;
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = softmax_p(sv[e], m_use);
      l_run[i] = l_run[i] * alpha + ((p[0] + p[1]) + (p[2] + p[3]));
      *reinterpret_cast<float4*>(own) = make_float4(p[0], p[1], p[2], p[3]);
      if (wq == 0 && lane < 8) alpha_s[nx & 1][row] = alpha;
      wg::fence_smem_for_mma();  // for the bulk copies
    }
    __syncthreads();  // this block's rows of p are in
    const int j = tid >> 5;
    if ((tid & 31) == 0 && j < S && j != slice) {
      const uint32_t bar = wg::map_rank(&p_bar[nx & 1], j);
      wg::bulk_copy_cluster(wg::map_rank(Pn + own0 * kFwdWalk, j), Pn + own0 * kFwdWalk,
                            n_own * kFwdWalk * sizeof(float), bar);
      wg::bulk_copy_cluster(wg::map_rank(&alpha_s[nx & 1][own0], j), &alpha_s[nx & 1][own0],
                            n_own * sizeof(float), bar);
    }
  }

  // 5. each owner's rows: l into every block, and their logsumexp (+inf for
  // a row that saw no key, whose o is 0)
  __syncthreads();  // the last step's maxima are read
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int lr = 8 * (wgi + 2 * i) + (lane & 7), row = own0 + lr;
    if (lr - (lane & 7) >= n_own) break;
    const float lw = row_sum(l_run[i]);
    if (lane < 8) part_s[lr][wq] = lw;
    warpgroup_sync();
    if (wq == 0 && lane < 8) {
      const float l = (part_s[lr][0] + part_s[lr][1]) + (part_s[lr][2] + part_s[lr][3]);
      for (int j = 0; j < S; ++j) wg::st_cluster(wg::map_rank(&l_s[row], j), l);
      if (q0 + row < len)
        lse[(size_t)bh * len + q0 + row] = l > 0.f ? m_run[i] + logf(l) : INFINITY;
    }
  }
  wg::cluster_sync();  // every l is in; no block leaves while stores into it may be in flight

  // 6. o = o / l: this warpgroup's 64 columns of the block's 128
  const int d = col0 + 64 * wgi + 16 * wq + g;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int qr = 8 * (i >> 2) + 2 * t + (i & 1), row = q0 + qr, col = d + 8 * ((i >> 1) & 1);
    const float l = l_s[qr];
    if (row < len) o[base + (size_t)row * ld + col] = from_f<T>(acc[i] * (l > 0.f ? 1.f / l : 0.f));
  }
}

// The TMA tensor map of an f32 key or value (B * H, L, head_dim) tensor at
// base: 3-D, (head_dim, L, B * H), a box of 32 columns by 64 rows written
// with the 128-byte swizzle (kv_at); rows past L read as zeros.
inline cudaError_t kv_map(CUtensorMap* map, const void* base, int batch_heads, int len,
                          int head_dim) {
  TensorMapEncode encode;
  const cudaError_t err = tensor_map_encoder(encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)head_dim, (cuuint64_t)len, (cuuint64_t)batch_heads};
  const cuuint64_t strides[2] = {(cuuint64_t)head_dim * 4, (cuuint64_t)len * head_dim * 4};
  const cuuint32_t box[3] = {32, kTile, 1}, unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor maps of K and V of a launch: f32 only (bf16 and f16 tiles are
// loaded through registers; their maps stay zero).
template <typename T>
cudaError_t fwd_maps(CUtensorMap& k_map, CUtensorMap& v_map, const void* k, const void* v,
                     int batch_heads, int len, int head_dim) {
  memset(&k_map, 0, sizeof(k_map));
  memset(&v_map, 0, sizeof(v_map));
  if (!std::is_same<T, float>::value) return cudaSuccess;
  const cudaError_t err = kv_map(&k_map, k, batch_heads, len, head_dim);
  return err != cudaSuccess ? err : kv_map(&v_map, v, batch_heads, len, head_dim);
}

}  // namespace attn
}  // namespace ffc
