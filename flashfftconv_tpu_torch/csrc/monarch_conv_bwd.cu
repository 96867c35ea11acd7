// monarch_conv_bwd: backward of the fused causal FFT convolution, and
// dk_finish, which turns its dk spectrum partials into dk.
//
// monarch_conv_bwd replaces the TPU kernel _bwd_fused_io_tiles
// (flashfftconv_tpu/ops/monarch_pallas.py, def at l.1281, pallas_call at
// l.1432): for every (b, h) row, with g = dout * post and ug = u * pre,
//   du_inner = irfft(G conj(K))[:L]    -> du = du_inner * pre, dpre = du_inner * u
//   y_inner  = irfft(U K)[:L] (gated)  -> dpost = y_inner * dout
//   P[b, h]  = G conj(U)               (the row's share of dk's spectrum)
// and the sum of P over the batch, which the TPU kernel accumulates across
// its sequential batch grid axis. Its instances for N <= 512 also replace
// _direct_bwd_fused_io_tiles (def at l.1460, pallas_call at l.1572), the
// same function as dense DFT products: the wrapper direct_conv_bwd
// (ops/monarch_cuda.py) launches them through the same C entry. At
// M2-BERT's shape (B=128, H=768, L=128, N=256, bf16) the function reads 25 MB
// each of u and dout and writes 25 MB of du (22 us at 3.35 TB/s) against
// about 2 GFLOP of f32 FFT operations (30 us at 67 TFLOP/s); the park (101
// MB) and the 16 partials (13 MB) are the design's own traffic there.
// dk_finish is the card's counterpart of
// _finish_dk (l.2953, an XLA Monarch IDFT in the JAX package):
// dk[h] = irfft(sum_g partials[g, h])[:k_len], in f32.
//
// Bound on the H100: at B=4, H=768, L=8192, N=16384 (bf16, ungated) the
// function reads 50 MB each of u and dout and 50 MB of f32 spectrum and
// writes 50 MB of du and one 50 MB dk spectrum (about 75 us at 3.35 TB/s);
// its three 8192-point complex FFTs a row in f32 (about 6.4 GFLOP, about
// 96 us at 67 TFLOP/s) bound it. The park below (201 MB written once, read
// back from L2) is this design's own traffic.
//
// Design on the H100. One instantiation per FFT size, dtype and gating
// (monarch_conv_bwd_kernel<LOG_M, T, GATED>, N = 16 ... 32768; the C entry
// dispatches on N) of monarch_conv.cu's in-register row FFT (row_fft.cuh):
// T = M/P threads a row, P points each, every index a compile-time
// constant, up to M = 1024 several rows a 128-thread block; stage 0 loads
// 16 bytes a thread straight from device memory, the pointwise passes take
// frequency pairs (f, M - f) from the natural-order spectrum in shared
// memory, and the stores write 16 bytes a thread, scaled by 1/M and
// truncated at L. For each row:
//   1. load g (dout * post, kept in f32 as in the JAX gated kernel), FFT,
//      split: G. Park G in the row's slot of a (B, H, M+1) scratch in device
//      memory; times conj(K), unsplit, inverse FFT; store du (and dpre).
//   2. load ug (u * pre rounded to T as in the forward, so that U is the
//      spectrum of the very input the forward convolved), FFT, split: U.
//      P = G conj(U), G read back from the slot by the thread that wrote it
//      microseconds before (L2 serves it). Gated: P to the slot, then U K,
//      unsplit, inverse FFT, store dpost. Ungated: P stays in shared memory
//      in place of U (P[M] in a slot of its own).
//   Only one row of M points fits beside the FFT at N = 32768 (128 KB), so
//   one spectrum is parked while the other is computed; the registers hold
//   the FFT's 2P floats, never the parked spectrum.
//   3. The sum over the batch. The B rows of a channel run in groups of c
//      rows (c = bwd_group(B) in ops/monarch.py: the largest power of two
//      <= 8 that divides B, passed in as group), and the blocks that hold a
//      group run as one thread block cluster (c / rows-a-block blocks, at
//      least 1). Blocks stay channel-major (row = h B + b), so a cluster is
//      consecutive b of one h. After a cluster barrier each block sums a
//      1/cluster slice of the frequencies over its groups' rows, in b order,
//      and writes the group's partial: ungated from the blocks' shared
//      memory (distributed shared memory across the cluster), gated from the
//      slots, which L2 holds. A second barrier keeps each block's shared
//      memory alive until the others have read it.
//   partials is (B / c, H, M+1): one a channel at B = 4, eight at B = 64,
//   one a row where c = 1 (B odd). No float atomics: every partial has one
//   writer and a fixed order of terms, so two calls give the same bits.
// Code size and registers. The two passes are one loop, not unrolled, so
// that one copy of the forward FFT, the inverse FFT and the store serves
// both: unrolled, the kernel's code was far larger than monarch_conv's, and
// its second pass alone took longer than the whole first. The pointwise
// pairs are unrolled by 4 (fully unrolled, their loads were hoisted together
// and spilled). As in monarch_conv, the row's offset and the index math are
// recomputed from a second read of threadIdx.x (fresh_tid) and the inverse
// stage 0 takes the lines of thread tr ^ 1; the mid stages' and the inverse
// stage 0's store slots are recomputed from tr passed through a warp
// shuffle, which the compiler cannot fold into the loads' slots (kept, they
// spilled at P = 32). ptxas: no stack frame, no spills.
//
// dk_finish on the H100: one instantiation per FFT size (dk_finish_kernel
// <LOG_M>, N = 16 ... 32768; the C entry keeps its plan arguments and
// dispatches on N = 2 M) of the same row FFT: T = M/P threads a channel,
// P points each, up to M = 1024 several channels a 128-thread block.
//   - The pointwise pass: each thread takes frequency pairs (f, M - f),
//     f = tr + T q, reads the partials of both in order (coalesced:
//     neighbouring threads read neighbouring frequencies; the partials'
//     index the outer loop, so that the loads of all a thread's pairs fly at
//     once), sums them, unsplits (split_tw from the block's root table), and
//     writes the conjugate to the row's two swizzled slots; f = M/2 alone.
//   - The inverse FFT is the forward transform of the conjugate (stage 0's
//     lines from shared memory), conjugated at the store.
//   - The store: E = 2 points (4 samples of f32, 16 bytes) a store where
//     the channel's row of dk is aligned and whole there, scaled by 1/M,
//     truncated at k_len.
// Bound on the H100 at H=768, N=16384: the function reads one (H, M+1)
// spectrum (50 MB) and writes dk (25 MB), 0.0225 ms at 3.35 TB/s; each
// partial beyond the first is the design's own traffic (none at B = 4,
// where monarch_conv_bwd leaves one a channel).

#include <cooperative_groups.h>

#include "row_fft.cuh"

namespace ffc {
namespace mbwd {

using namespace row;
namespace cg = cooperative_groups;

// Blocks of one cluster: a group of c rows over blocks of C::kRows rows.
template <class C>
__host__ __device__ constexpr int cluster_blocks(int group) {
  return group > C::kRows ? group / C::kRows : 1;
}

// Shared memory: the block's rows, the root table, and P[M] of each row.
template <class C>
constexpr size_t smem_bytes() {
  return C::kSmem + C::kRows * sizeof(float2);
}

// The global row (h B + b) of thread tid; past B * H on the last block's
// idle rows.
template <class C>
__device__ __forceinline__ int row_of(int tid) {
  return blockIdx.x * C::kRows + tid / C::kT;
}

// True if every operand's row at off starts on a 16-byte boundary.
template <bool GATED, typename T>
__device__ __forceinline__ bool rows_aligned(size_t off, const T* u, const T* pre, const T* post,
                                             const T* dout, const T* du, const T* dpre,
                                             const T* dpost) {
  const bool a = aligned16(u + off, dout + off, du + off, du + off);
  return GATED ? a && aligned16(pre + off, post + off, dpre + off, dpost + off) : a;
}

// Stage 0's lines of one row from device memory, v[e * F0 + j] = z[j * R0 + r]
// for the lines r = E tr + e: the packed points of samples 2E (j T + tr) ..
// + 2E - 1 of a (times b when gated, rounded to T if ROUND); zeros past L
// and on an idle row.
template <class C, typename T, bool GATED, bool ROUND>
__device__ __forceinline__ void load_row(float2 (&v)[C::kP], const T* __restrict__ a,
                                         const T* __restrict__ b, int tr, int length,
                                         bool active, bool aligned) {
#pragma unroll
  for (int j = 0; j < C::kF0; ++j) {
    const int i = 2 * C::kE * (j * C::kT + tr);
    float x[2 * C::kE];
#pragma unroll
    for (int c = 0; c < 2 * C::kE; ++c) x[c] = 0.f;
    if (active && i < length) load_vec<T, GATED, ROUND>(x, a, b, i, length, aligned);
#pragma unroll
    for (int e = 0; e < C::kE; ++e) v[e * C::kF0 + j] = make_float2(x[2 * e], x[2 * e + 1]);
  }
}

// The forward FFT of stage 0's lines in v; natural order in s after.
template <class C>
__device__ __forceinline__ void forward_fft(float2 (&v)[C::kP], float2* s, const float2* tab,
                                            int tr) {
#pragma unroll
  for (int e = 0; e < C::kE; ++e) first_stage_line<C>(v + e * C::kF0, s, tab, C::kE * tr + e);
  mid_stages<C, 1, true>(v, s, tab, tr);
  last_stage<C>(v, s, tr);
}

// The inverse FFT of the conjugate held in s: the forward transform, stage
// 0's lines from shared memory on the lines of thread tr ^ 1 (see the
// registers note above), their stores' slots recomputed from t0 passed
// through a warp shuffle; natural order in s after.
template <class C>
__device__ __forceinline__ void inverse_fft(float2* s, const float2* tab, int tr) {
  float2 v[C::kP];
  const int t0 = tr ^ (C::kT > 1 ? 1 : 0);
#pragma unroll
  for (int e = 0; e < C::kE; ++e)
#pragma unroll
    for (int j = 0; j < C::kF0; ++j) v[e * C::kF0 + j] = s[swz(j * C::kR0 + C::kE * t0 + e)];
  const int t1 = __shfl_sync(0xffffffffu, t0, threadIdx.x & 31);
#pragma unroll
  for (int e = 0; e < C::kE; ++e) first_stage_line<C>(v + e * C::kF0, s, tab, C::kE * t1 + e);
  mid_stages<C, 1, true>(v, s, tab, tr);
  last_stage<C>(v, s, tr);
}

// y[2n] + i y[2n+1] = conj(s[n]) / M for the E points from n0.
template <class C>
__device__ __forceinline__ void read_out(float* y, const float2* s, int n0) {
  const float scale = 1.f / (float)C::kM;
#pragma unroll
  for (int e = 0; e < C::kE; ++e) {
    const float2 z = s[swz(n0 + e)];
    y[2 * e] = z.x * scale;
    y[2 * e + 1] = -z.y * scale;
  }
}

// fn(f, self) for the frequency pairs (f, M - f) of thread tr: f = tr + T q
// < M/2, then M/2, its own partner (self), on thread 0. Unrolled by 4: fully
// unrolled, the loads of all P/2 pairs were hoisted together and spilled.
template <class C, class Fn>
__device__ __forceinline__ void for_pairs(int tr, Fn&& fn) {
#pragma unroll 4
  for (int q = 0; q < C::kP / 2; ++q) fn(tr + C::kT * q, false);
  if (tr == 0) fn(C::kM / 2, true);
}

__device__ __forceinline__ float2 conj2(float2 z) { return make_float2(z.x, -z.y); }

template <int LOG_M, typename T, bool GATED>
__global__ void __launch_bounds__(CfgT<LOG_M, T>::kThreads, min_blocks<LOG_M, T>())
    monarch_conv_bwd_kernel(const T* __restrict__ u, const T* __restrict__ pre,
                            const T* __restrict__ post, const T* __restrict__ dout,
                            const float2* __restrict__ k_f, T* __restrict__ du,
                            T* __restrict__ dpre, T* __restrict__ dpost,
                            float2* __restrict__ park, float2* __restrict__ partials,
                            const float2* __restrict__ split_tw, int batch, int channels,
                            int length, int group) {
  using C = CfgT<LOG_M, T>;
  constexpr int kM = C::kM, kT = C::kT, kP = C::kP, kE = C::kE;
  extern __shared__ float4 smem_raw[];
  float2* smem = reinterpret_cast<float2*>(smem_raw);
  float2* tab = smem + C::kRows * kM;
  float2* last = tab + C::kLo + C::kHi;  // P[M] of each row (ungated)
  size_t off;
  int h;
  load_table<C>(tab, split_tw);

  // Pass 0: G = rfft(g), du; pass 1: U = rfft(ug), P, dpost. One copy of
  // each FFT serves both passes (a loop, not unrolled): the kernel's code
  // stays near monarch_conv's size.
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    {
      float2 v[kP];
      const int tid = fresh_tid(), tr = tid % kT;
      const bool active = row_offset<C>(tid, batch, channels, length, off, h);
      const bool aligned = rows_aligned<GATED>(off, u, pre, post, dout, du, dpre, dpost);
      if (pass == 0)
        load_row<C, T, GATED, false>(v, dout + off, GATED ? post + off : nullptr, tr, length,
                                     active, aligned);
      else
        load_row<C, T, GATED, true>(v, u + off, GATED ? pre + off : nullptr, tr, length,
                                    active, aligned);
      __syncthreads();
      forward_fft<C>(v, smem + (tid / kT) * kM, tab, tr);
    }
    __syncthreads();
    {
      const int tid = fresh_tid(), tr = tid % kT;
      float2* s = smem + (tid / kT) * kM;
      const bool active = row_offset<C>(tid, batch, channels, length, off, h);
      const float2* kf = k_f + (size_t)h * (kM + 1);
      float2* slot = park + (size_t)row_of<C>(tid) * (kM + 1);
      if (pass == 0) {
        // Park G; conj(unsplit(G conj K)) for the inverse.
        for_pairs<C>(tr, [&](int f, bool self) {
          const float2 w = root<C>(tab, f);
          float2 ga, gb, za, zb;
          split_pair(s[swz(f)], s[swz((kM - f) & (kM - 1))], w, ga, gb);
          if (active) {
            __stcg(slot + f, ga);
            if (!self) __stcg(slot + kM - f, gb);
          }
          unsplit_pair(cmul_conj(ga, __ldg(kf + f)), cmul_conj(gb, __ldg(kf + kM - f)), w, za,
                       zb);
          s[swz(f)] = conj2(za);
          if (f != 0 && !self) s[swz(kM - f)] = conj2(zb);
        });
      } else {
        // P = G conj(U): gated to the slot, then conj(unsplit(U K)) for the
        // inverse; ungated in place of U.
        float2* p_last = last + tid / kT;
        for_pairs<C>(tr, [&](int f, bool self) {
          const float2 w = root<C>(tab, f), zero = make_float2(0.f, 0.f);
          float2 ua, ub;
          split_pair(s[swz(f)], s[swz((kM - f) & (kM - 1))], w, ua, ub);
          const float2 pa = cmul_conj(active ? __ldcg(slot + f) : zero, ua);
          const float2 pb = self ? pa : cmul_conj(active ? __ldcg(slot + kM - f) : zero, ub);
          if constexpr (GATED) {
            if (active) {
              __stcg(slot + f, pa);
              if (!self) __stcg(slot + kM - f, pb);
            }
            float2 za, zb;
            unsplit_pair(cmul(ua, __ldg(kf + f)), cmul(ub, __ldg(kf + kM - f)), w, za, zb);
            s[swz(f)] = conj2(za);
            if (f != 0 && !self) s[swz(kM - f)] = conj2(zb);
          } else {
            s[swz(f)] = pa;
            if (f == 0)
              *p_last = pb;
            else if (!self)
              s[swz(kM - f)] = pb;
          }
        });
      }
    }
    if (!GATED && pass == 1) break;
    __syncthreads();
    inverse_fft<C>(smem + (fresh_tid() / kT) * kM, tab, fresh_tid() % kT);
    __syncthreads();
    // Pass 0: du = du_inner (* pre), dpre = du_inner * u; pass 1: dpost =
    // y_inner * dout.
    const int tid = fresh_tid(), tr = tid % kT;
    const float2* s = smem + (tid / kT) * kM;
    if (row_offset<C>(tid, batch, channels, length, off, h)) {
      const bool aligned = rows_aligned<GATED>(off, u, pre, post, dout, du, dpre, dpost);
#pragma unroll
      for (int q = 0; q < kP / kE; ++q) {
        const int n0 = kE * (tr + kT * q), i = 2 * n0;
        if (i >= length) continue;
        float y[2 * kE];
        read_out<C>(y, s, n0);
        if constexpr (GATED) {
          if (pass == 0) {
            store_vec<T, true>(dpre + off, u + off, i, length, aligned, y);
            read_out<C>(y, s, n0);
            store_vec<T, true>(du + off, pre + off, i, length, aligned, y);
          } else {
            store_vec<T, true>(dpost + off, dout + off, i, length, aligned, y);
          }
        } else {
          store_vec<T, false>(du + off, nullptr, i, length, aligned, y);
        }
      }
    }
  }
  if constexpr (GATED) __threadfence();

  // 3. The group's partial: this block's slice of the frequencies, each
  // summed over the group's rows in b order.
  const int cs = cluster_blocks<C>(group);
  if (cs > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
  {
    const int rank = blockIdx.x % cs, chunk = (kM + cs) / cs;
    const int row0 = (blockIdx.x - rank) * C::kRows;
    const int items = cs * C::kRows / group * chunk;
    for (int idx = threadIdx.x; idx < items; idx += C::kThreads) {
      const int q = idx / chunk, f = rank * chunk + idx - q * chunk;
      const int grow = row0 + q * group;
      if (f > kM || grow >= batch * channels) continue;
      float2 acc = make_float2(0.f, 0.f);
      for (int j = 0; j < group; ++j) {
        const int lr = q * group + j;
        float2 p;
        if constexpr (GATED) {
          p = __ldcg(park + (size_t)(row0 + lr) * (kM + 1) + f);
        } else {
          float2* a = f < kM ? smem + (lr % C::kRows) * kM + swz(f) : last + lr % C::kRows;
          p = cs > 1 ? *cg::this_cluster().map_shared_rank(a, lr / C::kRows) : *a;
        }
        acc = j == 0 ? p : make_float2(acc.x + p.x, acc.y + p.y);
      }
      const int hh = grow / batch, bb = grow - hh * batch;
      partials[((size_t)(bb / group) * channels + hh) * (kM + 1) + f] = acc;
    }
  }
  if (cs > 1) cg::this_cluster().sync();
}

template <int LOG_M, typename T, bool GATED>
cudaError_t launch_one(const void* u, const void* pre, const void* post, const void* dout,
                       const void* k_f, void* du, void* dpre, void* dpost, void* park,
                       void* partials, const void* split_tw, int batch, int channels,
                       int length, int group, cudaStream_t stream) {
  using C = CfgT<LOG_M, T>;
  auto kernel = monarch_conv_bwd_kernel<LOG_M, T, GATED>;
  constexpr size_t kSmem = smem_bytes<C>();
  if constexpr (kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((long long)batch * channels + C::kRows - 1) / C::kRows));
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster_blocks<C>(group);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, (const T*)u, (const T*)pre, (const T*)post, (const T*)dout,
      (const float2*)k_f, (T*)du, (T*)dpre, (T*)dpost, (float2*)park, (float2*)partials,
      (const float2*)split_tw, batch, channels, length, group);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.
template <int LOG_M>
cudaError_t launch(const void* u, const void* pre, const void* post, const void* dout,
                   const void* k_f, void* du, void* dpre, void* dpost, void* park,
                   void* partials, const void* split_tw, int batch, int channels, int length,
                   int group, int dtype, cudaStream_t st) {
  const bool gated = pre != nullptr;
#define FFC_MBWD_ONE(T, G)                                                                    \
  launch_one<LOG_M, T, G>(u, pre, post, dout, k_f, du, dpre, dpost, park, partials, split_tw, \
                          batch, channels, length, group, st)
  if (dtype == 0) return gated ? FFC_MBWD_ONE(float, true) : FFC_MBWD_ONE(float, false);
  if (dtype == 1)
    return gated ? FFC_MBWD_ONE(__nv_bfloat16, true) : FFC_MBWD_ONE(__nv_bfloat16, false);
#undef FFC_MBWD_ONE
  return cudaErrorInvalidValue;
}

}  // namespace mbwd

namespace dkf {

using namespace row;

// f32 dk: E = 2 packed points (4 samples, 16 bytes) a store.
template <int LOG_M>
using CfgF = Cfg<LOG_M, 1>;

// dk[h, :k_len] = irfft(sum_b P[b, h])[:k_len] for the channels h of this
// block.
template <int LOG_M>
__global__ void __launch_bounds__(CfgF<LOG_M>::kThreads, CfgF<LOG_M>::kMinBlocks)
    dk_finish_kernel(const float2* __restrict__ partials, float* __restrict__ dk,
                     const float2* __restrict__ split_tw, int batch, int channels, int k_len) {
  using C = CfgF<LOG_M>;
  constexpr int kM = C::kM, kT = C::kT, kP = C::kP, kE = C::kE, kF0 = C::kF0, kR0 = C::kR0;
  extern __shared__ float4 smem_raw[];
  float2* smem = reinterpret_cast<float2*>(smem_raw);
  float2* tab = smem + C::kRows * kM;
  load_table<C>(tab, split_tw);
  __syncthreads();

  // The pointwise pass: pairs (f, M - f), f = tr + T q < M/2, and M/2 alone:
  // Y = sum_b P[b, h], in b order, unsplit and conjugated for the inverse.
  // The batch loop is the outer one, so that a thread has the P loads of all
  // its frequencies of one b in flight at once, and is unrolled to about 32
  // loads in flight where P is smaller (the sums keep their b order).
  {
    constexpr int kBatchUnroll = kP >= 32 ? 1 : 32 / kP;
    const int tr = threadIdx.x % kT, h = blockIdx.x * C::kRows + threadIdx.x / kT;
    float2* s = smem + (threadIdx.x / kT) * kM;
    const float2* part = partials + (size_t)(h < channels ? h : 0) * (kM + 1);
    const size_t stride = (size_t)channels * (kM + 1);
    float2 ya[kP / 2], yb[kP / 2], ym = make_float2(0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kP / 2; ++q) ya[q] = yb[q] = make_float2(0.f, 0.f);
#pragma unroll kBatchUnroll
    for (int b = 0; b < batch; ++b, part += stride) {
#pragma unroll
      for (int q = 0; q < kP / 2; ++q) {
        const int f = tr + kT * q;
        const float2 a = __ldg(part + f), c = __ldg(part + kM - f);
        ya[q] = make_float2(ya[q].x + a.x, ya[q].y + a.y);
        yb[q] = make_float2(yb[q].x + c.x, yb[q].y + c.y);
      }
      if (tr == 0) {
        const float2 a = __ldg(part + kM / 2);
        ym = make_float2(ym.x + a.x, ym.y + a.y);
      }
    }
#pragma unroll
    for (int q = 0; q < kP / 2; ++q) {
      const int f = tr + kT * q;
      float2 za, zb;
      unsplit_pair(ya[q], yb[q], root<C>(tab, f), za, zb);
      s[swz(f)] = make_float2(za.x, -za.y);
      if (f != 0) s[swz(kM - f)] = make_float2(zb.x, -zb.y);
    }
    if (tr == 0) {
      float2 z, unused;
      unsplit_pair(ym, ym, root<C>(tab, kM / 2), z, unused);
      s[swz(kM / 2)] = make_float2(z.x, -z.y);
    }
  }
  __syncthreads();

  // The inverse FFT of the conjugate, stage 0's lines from shared memory.
  const int tr = fresh_tid() % kT;
  float2* s = smem + (fresh_tid() / kT) * kM;
  float2 v[kP];
#pragma unroll
  for (int e = 0; e < kE; ++e)
#pragma unroll
    for (int j = 0; j < kF0; ++j) v[e * kF0 + j] = s[swz(j * kR0 + kE * tr + e)];
#pragma unroll
  for (int e = 0; e < kE; ++e) first_stage_line<C>(v + e * kF0, s, tab, kE * tr + e);
  mid_stages<C>(v, s, tab, tr);
  last_stage<C>(v, s, tr);
  __syncthreads();

  // dk[2n] + i dk[2n+1] = conj(s[n]) / M; E points (16 bytes) a store.
  const int h = blockIdx.x * C::kRows + fresh_tid() / kT;
  if (h >= channels) return;
  float* out = dk + (size_t)h * k_len;
  const bool aligned = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const float scale = 1.f / (float)kM;
#pragma unroll
  for (int q = 0; q < kP / kE; ++q) {
    const int n0 = kE * (tr + kT * q), i = 2 * n0;
    if (i >= k_len) continue;
    float y[2 * kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const float2 z = s[swz(n0 + e)];
      y[2 * e] = z.x * scale;
      y[2 * e + 1] = -z.y * scale;
    }
    if (aligned && i + 2 * kE <= k_len) {
      *reinterpret_cast<float4*>(out + i) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 2 * kE; ++c)
        if (i + c < k_len) out[i + c] = y[c];
    }
  }
}

template <int LOG_M>
cudaError_t launch(const void* partials, void* dk, const void* split_tw, int batch,
                   int channels, int k_len, cudaStream_t stream) {
  using C = CfgF<LOG_M>;
  if constexpr (C::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dk_finish_kernel<LOG_M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (channels + C::kRows - 1) / C::kRows;
  dk_finish_kernel<LOG_M><<<blocks, C::kThreads, C::kSmem, stream>>>(
      (const float2*)partials, (float*)dk, (const float2*)split_tw, batch, channels, k_len);
  return cudaGetLastError();
}

}  // namespace dkf
}  // namespace ffc

// n: the FFT size (16 ... 32768, a power of two); dtype: 0 = float32,
// 1 = bfloat16. pre, post, dpre and dpost are all null (ungated) or all
// set (gated). park is a (batch, channels, M+1) float2 scratch; partials is
// (batch / group, channels, M+1) float2, partials[g] the sum of the rows
// b = g group ... g group + group - 1 in b order; group is 1, 2, 4 or 8 and
// divides batch.
extern "C" int ffc_monarch_conv_bwd(const void* u, const void* pre, const void* post,
                                    const void* dout, const void* k_f, void* du, void* dpre,
                                    void* dpost, void* park, void* partials,
                                    const void* split_tw, int batch, int channels, int length,
                                    int n, int group, int dtype, void* stream) {
  const bool gated = pre != nullptr;
  if (batch < 1 || channels < 1 || length < 1 || length > n ||
      (long long)batch * channels > 0x7fffffffLL || gated != (post != nullptr) ||
      gated != (dpre != nullptr) || gated != (dpost != nullptr) || group < 1 || group > 8 ||
      (group & (group - 1)) || batch % group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FFC_MBWD_CASE(LOG_M)                                                                \
  case 2 << LOG_M:                                                                          \
    return (int)ffc::mbwd::launch<LOG_M>(u, pre, post, dout, k_f, du, dpre, dpost, park,   \
                                         partials, split_tw, batch, channels, length, group, \
                                         dtype, st);
  switch (n) {
    FFC_MBWD_CASE(3)
    FFC_MBWD_CASE(4)
    FFC_MBWD_CASE(5)
    FFC_MBWD_CASE(6)
    FFC_MBWD_CASE(7)
    FFC_MBWD_CASE(8)
    FFC_MBWD_CASE(9)
    FFC_MBWD_CASE(10)
    FFC_MBWD_CASE(11)
    FFC_MBWD_CASE(12)
    FFC_MBWD_CASE(13)
    FFC_MBWD_CASE(14)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFC_MBWD_CASE
}

// partials (batch, channels, M+1) float2 -> dk (channels, k_len) float, the
// partials summed in order (batch: their count). The plan's factors give M;
// of its tables only split_tw (exp(-2 pi i m / N), m = 0 .. M) is read.
extern "C" int ffc_dk_finish(const void* partials, void* dk, const void* tw, const void* split_tw,
                             const void* roots, int batch, int channels, int k_len,
                             int n_stages, int f0, int f1, int f2, int f3, void* stream) {
  const int factors[4] = {f0, f1, f2, f3};
  ffc::Plan p;
  if (!ffc::make_plan(n_stages, factors, &p) || batch < 1 || channels < 1 || k_len < 1 ||
      k_len > 2 * p.m)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FFC_DKF_CASE(LOG_M)                                                                \
  case 2 << LOG_M:                                                                         \
    return (int)ffc::dkf::launch<LOG_M>(partials, dk, split_tw, batch, channels, k_len, st);
  switch (2 * p.m) {
    FFC_DKF_CASE(3)
    FFC_DKF_CASE(4)
    FFC_DKF_CASE(5)
    FFC_DKF_CASE(6)
    FFC_DKF_CASE(7)
    FFC_DKF_CASE(8)
    FFC_DKF_CASE(9)
    FFC_DKF_CASE(10)
    FFC_DKF_CASE(11)
    FFC_DKF_CASE(12)
    FFC_DKF_CASE(13)
    FFC_DKF_CASE(14)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFC_DKF_CASE
}

FFC_EXPORT_ERROR_STRING()
