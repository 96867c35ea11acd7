// The attention backward above head_dim 128, up to 1024: dK/dV and dQ on
// warpgroup products (wgmma) in thread block clusters. flash_attn_bwd.cu
// runs it under FlashMask, splash_attn_bwd.cu under SplashMask; above 1024
// both keep the D-sliced bodies of flash_attn_common.cuh.
//
// A cluster of S = D / 128 blocks owns (b, h, a tile of 64 kept rows): keys
// for dK/dV, queries for dQ. Block s of the cluster (its rank) holds columns
// 128 s .. 128 s + 127 of the kept rows (A1 and A2: K and V, or Q and dO)
// and of the walked rows (B1 and B2: Q and dO, or K and V), 32 a step. A
// block has two warpgroups: warpgroup 0 loads B1 and computes with it,
// warpgroup 1 B2. The walked tiles come through a two-stage ring, in f32 by
// TMA (one thread of the warpgroup issues the copy of the next step's tile,
// which lands on the stage's mbarrier; walked_map), in bf16 and f16 through
// registers, converted on the way in; each is loaded once a kept tile. A
// step:
//  1. the partial scores over the block's columns: warpgroup 0
//     s = A1 B1^T, warpgroup 1 dp = A2 B2^T (64 x 32 each, wgmma m64n32k8
//     TF32, A the kept rows in registers, B the walked tile in shared memory;
//     4 groups of 4 k-steps, each issued before the last is waited for);
//  2. the cluster sums them: the 2048 scores of a step are cut into S
//     contiguous pieces (in the order of the p and ds tiles), block j owns
//     piece j, and every block stages its partials in its own shared memory
//     and stores piece j of them, a run of float4s, into block j's receive
//     buffer; after a cluster barrier block j adds the S partials in slice
//     order, masks, and turns them into p = exp(s - lse) and
//     ds = p (dp - delta) (only it writes those elements of the bias grad),
//     and stores its piece of p and ds into every block by st.async, whose
//     bytes each block's mbarrier counts; once they are in, every block
//     holds the same p and ds, bit for bit, and makes their lo parts
//     (below) itself;
//  3. grads, the outputs transposed (wgmma m64n64k8, A the walked tile read
//     transposed from shared memory into registers, B p or ds in shared
//     memory): in dK/dV warpgroup 0 accumulates dk^T += q^T ds^T and
//     warpgroup 1 dv^T += do^T p^T, each over the slice's two 64-column
//     chunks, so that each reads only its own walked tile and grad tile and
//     the two meet only at the cluster barriers; in dQ warpgroup w
//     accumulates chunk w of dq^T += k^T ds^T.
// So the scores are computed once, not once a slice, and every block
// writes only its own 128 columns of dk and dv, or dq: one writer an element,
// no atomics, the same bits from run to run.
//
// TF32 operands of wgmma must be K-major in shared memory (its transpose
// flags are for 16-bit types only). Every B operand is laid out so (the
// walked tile with D contiguous for the scores, p and ds with the walked
// rows contiguous for the grads), and the products that need the walked tile
// the other way round take it as A, whose register fragments any layout
// can feed. f32 accuracy comes from the split of flash_attn_common.cuh:
// lo b_hi + hi b_lo + hi b_hi; in shared memory the tensor cores read hi
// as the f32 value truncated to TF32, so a B operand keeps beside it a
// tile of lo = x - trunc(x) (the walked tiles in f32 and p and ds always);
// an A operand is split in registers. bf16 and f16 operands are exact in
// TF32 and have no lo part. Each group of 4 k-steps is summed apart and added
// to the scores in f32, and each step's grads are added to dk, dv or dq in
// f32, as the tensor cores truncate as they accumulate.
//
// Bound on the H100 at the @256 shape of chip_smoke.py's timing (B=4, H=8,
// L=2048, D=256, f32, causal): dK/dV's four products over the causal half
// (137.4 GFLOP, 2 a multiply-add) take 0.83 ms as three TF32 passes at
// 494.7 TFLOP/s, dQ's three 0.63 ms, against 0.12 and 0.10 ms for their
// bytes (q, k, v and do read once, dk and dv or dq written once at 3.35
// TB/s): operations. Shared memory a block: 215,296 B in f32 (kept 67,584,
// the ring 65,536, the walked lo tiles 32,768, two receive buffers 16,640,
// p and ds with their lo 32,768), so one block an SM, 256 threads.
#pragma once

#include "flash_attn_common.cuh"
#include "wgmma.cuh"

namespace ffc {
namespace attn {

constexpr int kWgDim = 128;      // head_dim columns a block of the cluster holds
constexpr int kWgWalk = 32;      // walked rows a step
constexpr int kWgThreads = 256;  // two warpgroups
constexpr int kMaxCluster = 8;   // the portable cluster size: D up to 1024
constexpr int kKeptLd = kWgDim + 4;                   // row stride of a kept tile
constexpr int kWalkedFloats = kWgWalk * kWgDim;        // a walked tile
constexpr int kGradFloats = kTile * kWgWalk;           // a p or ds tile
constexpr int kScoreGroups = kTile * kWgWalk / 4;      // float4 groups of a step's scores
constexpr int kRecvFloats = (kScoreGroups + kMaxCluster) * 4;
static_assert(kMaxCluster * kWgDim == kMaxClustered, "the clustered head_dims");

// The head_dims the clustered bodies take (this backward, and the forward of
// flash_attn_fwd_wide.cuh): above 128 up to 1024.
inline bool clustered(int head_dim) {
  return head_dim > 128 && head_dim <= kMaxCluster * kWgDim && head_dim % kWgDim == 0;
}

template <bool kSplit>
constexpr size_t wg_bwd_smem_bytes() {
  return (2 * kTile * kKeptLd + 4 * kWalkedFloats + (kSplit ? 2 * kWalkedFloats : 0) +
          2 * kRecvFloats + 4 * kGradFloats) *
         sizeof(float);
}

// Offset of (row r, column c) of a walked tile (ROWS rows, 128 columns,
// K = the columns): the ROWS rows' 16 bytes of each 4 columns in turn, so
// that a core matrix (8 rows by 4 columns) is 128 contiguous bytes, 16 ROWS
// bytes along K apart and 128 along the rows. It is the order in which TMA
// writes a (4 columns, ROWS rows, 32 column groups) box (walked_map).
template <int ROWS = kWgWalk>
__device__ __forceinline__ int walked_at(int r, int c) {
  return (c >> 2) * (ROWS * 4) + r * 4 + (c & 3);
}
// Offset of (kept row r, walked column c) of a p or ds tile (64 x 32,
// K = the walked columns): 128 bytes along K apart, 1024 along the rows.
__device__ __forceinline__ int grad_at(int r, int c) {
  return (r >> 3) * 256 + (c >> 2) * 32 + (r & 7) * 4 + (c & 3);
}

// x - trunc_tf32(x): what the tensor cores drop of an f32 they read as TF32.
__device__ __forceinline__ float tf32_lo(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}
__device__ __forceinline__ float4 tf32_lo(float4 x) {
  return make_float4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
}

// Rows row0 .. row0 + ROWS - 1, columns col0 .. col0 + 4096 / ROWS - 1 (128
// at 32 rows; 64 at 64, the forward's pieces of a key or value tile) of an
// (L, ld) bf16 or f16 slab, zeros past L, by the 128 threads of a warpgroup,
// in two halves: walked_fetch loads a thread's 16-byte pieces (8 columns,
// walked_piece's) into registers, walked_put converts them to f32 and stores
// them into a walked tile. Each 8 lanes take 8 rows of one piece: their
// stores are 128 contiguous bytes. (f32 tiles come by TMA.)
template <int ROWS>
__device__ __forceinline__ void walked_piece(int i, int& r, int& c) {
  const int lane = threadIdx.x & 31, u = ((threadIdx.x >> 5) & 3) * 4 + i;
  r = (u % (ROWS / 8)) * 8 + (lane & 7);
  c = ((u / (ROWS / 8)) * 4 + (lane >> 3)) * 8;
}

template <typename T, int ROWS = kWgWalk>
__device__ __forceinline__ void walked_fetch(uint4 (&raw)[4], const T* __restrict__ src,
                                             int row0, int len, int ld, int col0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, c;
    walked_piece<ROWS>(i, r, c);
    raw[i] = row0 + r < len
                 ? *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + col0 + c)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T>
__device__ __forceinline__ void walked_put(float* dst, const uint4 (&raw)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, c;
    walked_piece<kWgWalk>(i, r, c);
    const T* h = reinterpret_cast<const T*>(&raw[i]);
    *reinterpret_cast<float4*>(dst + walked_at(r, c)) =
        make_float4(to_f(h[0]), to_f(h[1]), to_f(h[2]), to_f(h[3]));
    *reinterpret_cast<float4*>(dst + walked_at(r, c + 4)) =
        make_float4(to_f(h[4]), to_f(h[5]), to_f(h[6]), to_f(h[7]));
  }
}

// The 128 threads of this thread's warpgroup wait for each other.
__device__ __forceinline__ void warpgroup_sync() {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + (int)(threadIdx.x >> 7)) : "memory");
}

// A fragments of 4 k-steps (columns k0 .. k0 + 31) of the warpgroup's 64
// rows of a kept tile (row-major, stride kKeptLd).
template <bool kSplit>
__device__ __forceinline__ void kept_frags(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                           const float* A, int k0) {
  const int wq = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = A + (16 * wq + g) * kKeptLd + k0 + t;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split_tf32<kSplit>(p[8 * kk], hi[kk][0], lo[kk][0]);
    split_tf32<kSplit>(p[8 * kk + 8 * kKeptLd], hi[kk][1], lo[kk][1]);
    split_tf32<kSplit>(p[8 * kk + 4], hi[kk][2], lo[kk][2]);
    split_tf32<kSplit>(p[8 * kk + 8 * kKeptLd + 4], hi[kk][3], lo[kk][3]);
  }
}

// A fragments of the transpose of a walked tile, its 32 rows the k index:
// the warpgroup's 64 rows are the tile's columns d0 .. d0 + 63.
template <bool kSplit>
__device__ __forceinline__ void walked_t_frags(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                               const float* B, int d0) {
  const int wq = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int d = d0 + 16 * wq + g;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = 8 * kk + t;
    split_tf32<kSplit>(B[walked_at(c, d)], hi[kk][0], lo[kk][0]);
    split_tf32<kSplit>(B[walked_at(c, d + 8)], hi[kk][1], lo[kk][1]);
    split_tf32<kSplit>(B[walked_at(c + 4, d)], hi[kk][2], lo[kk][2]);
    split_tf32<kSplit>(B[walked_at(c + 4, d + 8)], hi[kk][3], lo[kk][3]);
  }
}

// Issue d = sum over 4 k-steps of a b as one committed group, without
// waiting: the products of the split (lo hi, hi lo, hi hi; without kSplitA
// no lo hi, without kSplitB no hi lo), b's hi at bh, its lo at bl, k-step kk
// at bh + kk * step_floats; b's core matrices lbo bytes apart along K and
// sbo along N. d and a stay untouched until a wait covers the group.
template <bool kSplitA, bool kSplitB, int N>
__device__ __forceinline__ void mma_issue(float (&d)[N], const uint32_t (&ah)[4][4],
                                          const uint32_t (&al)[4][4], const float* bh,
                                          const float* bl, int step_floats, uint32_t lbo,
                                          uint32_t sbo) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dh = wg::smem_desc(bh + kk * step_floats, lbo, sbo);
    if (kSplitA) wg::mma(d, al[kk], dh, 1);
    if (kSplitB) wg::mma(d, ah[kk], wg::smem_desc(bl + kk * step_floats, lbo, sbo), 1);
    wg::mma(d, ah[kk], dh, 1);
  }
  wg::commit();
}

// The body. kDkv: dK/dV, kept rows are keys (A1 = k, A2 = v), walked rows
// queries (B1 = q, B2 = do), out1 = dk, out2 = dv. Else dQ: kept queries
// (A1 = q, A2 = do), walked keys (B1 = k, B2 = v), out1 = dq, and ds_out,
// when given, the (B, H, L, L) f32 bias grad. Launched in clusters of
// S = head_dim / 128 blocks along x (blockIdx.x = tile * S + rank).
template <typename T, typename Mask, bool kDkv>
__device__ __forceinline__ void attn_bwd_wg(const T* __restrict__ q, const T* __restrict__ k,
                                            const T* __restrict__ v,
                                            const T* __restrict__ dout,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta,
                                            T* __restrict__ out1, T* __restrict__ out2,
                                            float* __restrict__ ds_out, const Mask& m,
                                            const CUtensorMap* map1, const CUtensorMap* map2) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ __align__(128) float4 smem_wg[];
  float* A1 = reinterpret_cast<float*>(smem_wg);  // (64, kKeptLd) kept rows
  float* A2 = A1 + kTile * kKeptLd;
  float* B1 = A2 + kTile * kKeptLd;              // two stages of a walked tile
  float* B2 = B1 + 2 * kWalkedFloats;
  float* B1lo = B2 + 2 * kWalkedFloats;          // f32: the current stage's lo
  float* B2lo = B1lo + (kSplit ? kWalkedFloats : 0);
  float* Xr = B2lo + (kSplit ? kWalkedFloats : 0);  // partials of s received, [slice][group]
  float* Yr = Xr + kRecvFloats;                        // and of dp
  float* Ghi = Yr + kRecvFloats;                       // ds (64 x 32) and its lo
  float* Glo = Ghi + kGradFloats;
  float* Phi = Glo + kGradFloats;                      // dK/dV: p and its lo
  float* Plo = Phi + kGradFloats;                      // (Plo, Glo: first the partials)
  __shared__ float lse_s[2][kTile], delta_s[2][kTile];  // dK/dV: walked rows; dQ: [0] kept
  __shared__ int seg_w[2][kWgWalk], seg_kept[kTile];
  __shared__ int first_g[kMaxCluster + 1];  // the first score group of each block's piece
  __shared__ uint64_t tma_bar[2][2];        // f32: [warpgroup][stage], its walked tile landed
  __shared__ uint64_t pds_bar;              // a step's p and ds landed from every block

  const int bh = block_bh();
  if (bh >= m.batch * m.heads) return;  // the whole cluster: it shares blockIdx.y, z
  const int S = m.head_dim / kWgDim, slice = (int)blockIdx.x % S, tile = (int)blockIdx.x / S;
  const int len = m.len, ld = m.head_dim, col0 = slice * kWgDim;
  const int b = bh / m.heads, h = bh % m.heads;
  const size_t base = (size_t)bh * len * ld, row_base = (size_t)bh * len;
  const int tid = threadIdx.x, wgi = tid >> 7, wq = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int kt = kDkv ? tile : m.n_tiles - 1 - tile;  // the kept tile (dQ: longest rows first)
  const int kept0 = kt * kTile;
  const int n_walk = kDkv ? m.n_q(kt) : m.n_kv(kt);
  const int n_steps = 2 * n_walk, pg = (kScoreGroups + S - 1) / S;
  const T* a1 = kDkv ? k : q;
  const T* a2 = kDkv ? v : dout;
  const T* b1 = kDkv ? q : k;
  const T* b2 = kDkv ? dout : v;
  auto walked_row0 = [&](int n, bool& full) {
    const int j = kDkv ? m.q_tile(kt, n >> 1, full) : m.kv_tile(kt, n >> 1, full);
    return j * kTile + (n & 1) * kWgWalk;
  };

  if (tid <= kMaxCluster) first_g[tid] = tid <= S ? (tid * kScoreGroups + S - 1) / S : 0;
  // the kept rows' slice, and their statistics
  load_tile<kWgDim, T, kTile, kWgThreads, true>(A1, a1 + base, kept0, len, ld, col0);
  load_tile<kWgDim, T, kTile, kWgThreads, true>(A2, a2 + base, kept0, len, ld, col0);
  if (tid < kTile) {
    if constexpr (kDkv) {
      seg_kept[tid] = m.seg_at(b, kept0 + tid, -2);
    } else {
      const RowStats st = row_stats(m, lse, delta, b, row_base, kept0 + tid);
      lse_s[0][tid] = st.lse;
      delta_s[0][tid] = st.delta;
      seg_kept[tid] = st.seg;
    }
  }
  // the walked step's statistics: a query row's (dK/dV) or a key's segment id (dQ)
  auto walked_stats = [&](int n, RowStats& st) {
    bool full;
    const int r = walked_row0(n, full) + tid;
    if constexpr (kDkv)
      st = row_stats(m, lse, delta, b, row_base, r);
    else
      st.seg = m.seg_at(b, r, -2);
  };
  auto put_stats = [&](int stage, const RowStats& st) {
    if constexpr (kDkv) {
      lse_s[stage][tid] = st.lse;
      delta_s[stage][tid] = st.delta;
    }
    seg_w[stage][tid] = st.seg;
  };
  // Warpgroup 0 loads B1 and its lo part, warpgroup 1 B2: each the tile its
  // scores take. f32 by TMA: one thread of the warpgroup issues the copy of
  // a step's tile, which completes on the stage's mbarrier.
  float* Bw = wgi == 0 ? B1 : B2;
  float* Bwlo = wgi == 0 ? B1lo : B2lo;
  const T* bw = (wgi == 0 ? b1 : b2) + base;
  const CUtensorMap* map_w = wgi == 0 ? map1 : map2;
  const bool issuer = (tid & 127) == 0;
  auto walked_tma = [&](int n, int stage) {
    bool full;
    wg::mbar_expect(&tma_bar[wgi][stage], kWalkedFloats * sizeof(float));
    wg::tma_load_4d(Bw + stage * kWalkedFloats, map_w, 0, walked_row0(n, full),
                    col0 / 4, bh, &tma_bar[wgi][stage]);
  };
  if (tid < 4) wg::mbar_init(&tma_bar[tid >> 1][tid & 1]);
  if (tid == 4) wg::mbar_init(&pds_bar);
  wg::mbar_init_fence();
  __syncthreads();
  uint4 raw[4];  // bf16 and f16: the next step's pieces of this warpgroup's tile
  if (n_steps > 0) {
    if constexpr (kSplit) {
      if (issuer) walked_tma(0, 0);
    } else {
      bool full;
      walked_fetch(raw, bw, walked_row0(0, full), len, ld, col0);
      walked_put<T>(Bw, raw);
    }
    if (tid < kWgWalk) {
      RowStats st = {};
      walked_stats(0, st);
      put_stats(0, st);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  wg::fence_smem_for_mma();
  wg::cluster_sync();  // the kept rows are in; every block of the cluster runs

  // dK/dV: warpgroup 0 accumulates dk^T, warpgroup 1 dv^T, each both 64-column
  // chunks of the slice, so that each reads only its own walked tile and its
  // own grad tile (ds, or p); dQ: warpgroup w dq^T's chunk w.
  constexpr int NC = kDkv ? 2 : 1;
  float acc[NC][32] = {};
  float* Gh = kDkv && wgi == 1 ? Phi : Ghi;  // the B operand of this warpgroup's grads
  float* Gl = kDkv && wgi == 1 ? Plo : Glo;
  for (int n = 0; n < n_steps; ++n) {
    const int cur = n & 1, nxt = cur ^ 1;
    bool full;
    const int w0 = walked_row0(n, full);
    if constexpr (kDkv)  // step n - 1's grads have read stage nxt
      warpgroup_sync();
    else
      __syncthreads();
    if constexpr (kSplit) {  // the next step's tile flies while this one is multiplied
      if (issuer && n + 1 < n_steps) walked_tma(n + 1, nxt);
      wg::mbar_wait(&tma_bar[wgi][cur], (n >> 1) & 1);  // this step's tile is in
    }
    const float* Bc1 = B1 + cur * kWalkedFloats;
    const float* Bh = Bw + cur * kWalkedFloats;
    if constexpr (kSplit) {  // its lo tile
      for (int i = tid & 127; i < kWalkedFloats / 4; i += 128)
        reinterpret_cast<float4*>(Bwlo)[i] = tf32_lo(reinterpret_cast<const float4*>(Bh)[i]);
      wg::fence_smem_for_mma();
      warpgroup_sync();
    }

    // 1. this slice's partial of s (warpgroup 0) or dp (warpgroup 1): four
    // groups of 4 k-steps, each issued before the last one is waited for
    float sc[16];
    {
      const float* A = wgi == 0 ? A1 : A2;
      uint32_t ah[2][4][4], al[2][4][4];
      float part[2][16];
#pragma unroll
      for (int kg = 0; kg < 4; ++kg) {
        const int x = kg & 1;
        kept_frags<kSplit>(ah[x], al[x], A, 32 * kg);
        mma_issue<kSplit, kSplit>(part[x], ah[x], al[x], Bh + 8 * kWgWalk * 4 * kg,
                                  Bwlo + 8 * kWgWalk * 4 * kg, 2 * kWgWalk * 4,
                                  kWgWalk * 4 * 4, 128);
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
    // 2. the partials, staged in this block's lo tiles in the order of the p
    // and ds tiles (grad_at), then each block's piece of them, a contiguous
    // run of float4s, into that block's receive buffer
    {
      float* stage = wgi == 0 ? Glo : Plo;  // dK/dV: Gl
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int r = 16 * wq + g + 8 * ((i >> 1) & 1), c = 8 * (i >> 2) + 2 * t;
        *reinterpret_cast<float2*>(stage + grad_at(r, c)) = make_float2(sc[i], sc[i + 1]);
      }
      warpgroup_sync();
      float* recv = wgi == 0 ? Xr : Yr;
      for (int gl = tid & 127; gl < kScoreGroups; gl += 128) {
        const int owner = gl * S / kScoreGroups;
        float* dst = recv + (slice * pg + gl - first_g[owner]) * 4;
        wg::st_cluster(wg::map_rank(dst, owner), reinterpret_cast<const float4*>(stage)[gl]);
      }
    }
    wg::cluster_sync();  // every slice's partials of this block's piece are here
    if (tid == 0) wg::mbar_expect(&pds_bar, (kDkv ? 2 : 1) * kGradFloats * sizeof(float));
    // 3. this block's piece: the sums in slice order, p and ds, into every block
    if (tid < first_g[slice + 1] - first_g[slice]) {
      const float4* xr = reinterpret_cast<const float4*>(Xr);
      const float4* yr = reinterpret_cast<const float4*>(Yr);
      float4 x = xr[tid], y = yr[tid];
      for (int j = 1; j < S; ++j) {
        const float4 xa = xr[j * pg + tid], ya = yr[j * pg + tid];
        x = make_float4(x.x + xa.x, x.y + xa.y, x.z + xa.z, x.w + xa.w);
        y = make_float4(y.x + ya.x, y.y + ya.y, y.z + ya.z, y.w + ya.w);
      }
      const int off = 4 * (first_g[slice] + tid);  // grad_at(r, c0)
      const int r = (off >> 8) * 8 + ((off >> 2) & 7), c0 = ((off >> 5) & 7) * 4;
      const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + e;
        const int row = kDkv ? w0 + c : kept0 + r, col = kDkv ? kept0 + r : w0 + c;
        const int seg_r = kDkv ? seg_w[cur][c] : seg_kept[r];
        const int seg_c = kDkv ? seg_kept[r] : seg_w[cur][c];
        const float l = kDkv ? lse_s[cur][c] : lse_s[0][r];
        const float dl = kDkv ? delta_s[cur][c] : delta_s[0][r];
        const float s = m.score(b, h, row, col, xs[e], full, seg_r, seg_c);
        p[e] = s == -INFINITY ? 0.f : fast_exp2((s - l) * kLog2e);
        ds[e] = p[e] * (ys[e] - dl);
        if (!kDkv && ds_out != nullptr && row < len && col < len)
          ds_out[(row_base + row) * len + col] = ds[e];
      }
      const float4 dh = make_float4(ds[0], ds[1], ds[2], ds[3]);
      const float4 ph = make_float4(p[0], p[1], p[2], p[3]);
      for (int j = 0; j < S; ++j) {
        const uint32_t bar = wg::map_rank(&pds_bar, j);
        wg::st_async(wg::map_rank(Ghi + off, j), dh, bar);
        if (kDkv) wg::st_async(wg::map_rank(Phi + off, j), ph, bar);
      }
    }
    // p and ds whole in this block (each reader fences below). No cluster
    // barrier is needed here: a block's next partials reach an owner only
    // after every owner's p and ds of this step, which follow its reduction,
    // and p and ds are rewritten only after the next step's barrier.
    wg::mbar_wait(&pds_bar, n & 1);
    if constexpr (kDkv) {  // the lo part of this warpgroup's grad tile
      for (int i = tid & 127; i < kScoreGroups; i += 128)
        reinterpret_cast<float4*>(Gl)[i] = tf32_lo(reinterpret_cast<const float4*>(Gh)[i]);
      wg::fence_smem_for_mma();
      warpgroup_sync();
    } else {
      for (int i = tid; i < kScoreGroups; i += kWgThreads)
        reinterpret_cast<float4*>(Gl)[i] = tf32_lo(reinterpret_cast<const float4*>(Gh)[i]);
      wg::fence_smem_for_mma();
      __syncthreads();
    }
    RowStats next = {};
    // 4. the grads: dk^T += q^T ds^T (warpgroup 0) and dv^T += do^T p^T
    // (warpgroup 1), both chunks issued before the first is waited for; or
    // dq^T += k^T ds^T, chunk w
    {
      const float* Bt = kDkv ? Bh : Bc1;
      uint32_t ah[NC][4][4], al[NC][4][4];
      float part[NC][32];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        walked_t_frags<kSplit>(ah[c], al[c], Bt, 64 * (kDkv ? c : wgi));
        mma_issue<kSplit, true>(part[c], ah[c], al[c], Gh, Gl, 64, 128, 1024);
      }
      // The next step's statistics, and in bf16 and f16 its tile, fly while
      // the grads are multiplied (issued after the cluster barriers, whose
      // release would wait for them).
      if (n + 1 < n_steps) {
        if constexpr (!kSplit) {
          bool next_full;
          walked_fetch(raw, bw, walked_row0(n + 1, next_full), len, ld, col0);
        }
        if (tid < kWgWalk) walked_stats(n + 1, next);
      }
      if constexpr (kDkv) {
        wg::wait<1>();
        wg::hold(part[0]);
        wg::hold(ah[0]);
        wg::hold(al[0]);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[0][i] += part[0][i];
      }
      wg::wait<0>();
      wg::hold(part[NC - 1]);
      wg::hold(ah[NC - 1]);
      wg::hold(al[NC - 1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[NC - 1][i] += part[NC - 1][i];
    }
    if (n + 1 < n_steps) {
      if constexpr (!kSplit) {
        walked_put<T>(Bw + nxt * kWalkedFloats, raw);
        wg::fence_smem_for_mma();
      }
      if (tid < kWgWalk) put_stats(nxt, next);
    }
  }
  wg::cluster_sync();  // no block leaves while stores into it may be in flight

  // out^T (64 columns of D by the 64 kept rows) into rows kept0 .. of out
  T* out = kDkv && wgi == 1 ? out2 : out1;
  const float mul = kDkv && wgi == 1 ? 1.f : m.scale;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = col0 + 64 * (kDkv ? c : wgi) + 16 * wq + g;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = kept0 + 8 * (i >> 2) + 2 * t + (i & 1), col = d + 8 * ((i >> 1) & 1);
      if (row < len) out[base + (size_t)row * ld + col] = from_f<T>(acc[c][i] * mul);
    }
  }
}

// The TMA tensor map of a walked f32 (B * H, L, head_dim) tensor at base:
// 4-D, (4 columns, L rows, head_dim / 4 column groups, B * H), a box of
// (4, 32, 32, 1) being one step's walked tile in walked_at's order; rows
// past L read as zeros.
using TensorMapEncode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                     const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                     const cuuint32_t*, CUtensorMapInterleave,
                                     CUtensorMapSwizzle, CUtensorMapL2promotion,
                                     CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint (so that
// nothing links libcuda), into encode.
inline cudaError_t tensor_map_encoder(TensorMapEncode& encode) {
  static TensorMapEncode found_fn = nullptr;
  if (found_fn == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
    found_fn = reinterpret_cast<TensorMapEncode>(fn);
  }
  encode = found_fn;
  return cudaSuccess;
}

inline cudaError_t walked_map(CUtensorMap* map, const void* base, int batch_heads, int len,
                              int head_dim) {
  TensorMapEncode encode;
  const cudaError_t err = tensor_map_encoder(encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {4, (cuuint64_t)len, (cuuint64_t)head_dim / 4,
                              (cuuint64_t)batch_heads};
  const cuuint64_t strides[3] = {(cuuint64_t)head_dim * 4, 16, (cuuint64_t)len * head_dim * 4};
  const cuuint32_t box[4] = {4, kWgWalk, kWgDim / 4, 1}, unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor maps of the two walked tensors w1, w2 of a launch: f32 only
// (bf16 and f16 tiles are loaded through registers; their maps stay zero).
template <typename T>
cudaError_t walked_maps(CUtensorMap& m1, CUtensorMap& m2, const void* w1, const void* w2,
                        int batch_heads, int len, int head_dim) {
  memset(&m1, 0, sizeof(m1));
  memset(&m2, 0, sizeof(m2));
  if (!std::is_same<T, float>::value) return cudaSuccess;
  const cudaError_t err = walked_map(&m1, w1, batch_heads, len, head_dim);
  return err != cudaSuccess ? err : walked_map(&m2, w2, batch_heads, len, head_dim);
}

// kernel on the (tiles of L times S, B * H) grid in clusters of S =
// head_dim / 128 blocks along x, with kWgThreads threads and `smem` bytes
// of dynamic shared memory; an error if no such cluster fits an SM set.
template <typename... P, typename... A>
cudaError_t launch_clustered(void (*kernel)(P...), size_t smem, int len, int batch_heads,
                             int head_dim, cudaStream_t stream, A... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int S = head_dim / kWgDim;
  const int z = (batch_heads + kMaxGridY - 1) / kMaxGridY;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((len + kTile - 1) / kTile * S, (batch_heads + z - 1) / z, z);
  cfg.blockDim = dim3(kWgThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, ((P)args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace ffc
