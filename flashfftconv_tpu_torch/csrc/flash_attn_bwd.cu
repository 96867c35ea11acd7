// flash_attn_bwd_dkv and flash_attn_bwd_dq: the flash-attention backward.
//
// Replace the two backward TPU kernels of JAX's Pallas flash_attention that
// flashfftconv_tpu/ops/attention.py:202 (flash_mha) differentiates through
// (jax/experimental/pallas/ops/tpu/flash_attention.py of jax 0.9.0):
// _flash_attention_bwd_dkv (def at l.941, pallas_call at l.1121, body at
// l.796) and _flash_attention_bwd_dq (def at l.1287, pallas_call at l.1456,
// body at l.1146), which also writes ds, the bias's grad. The contract is
// flash_mha's, as in flash_attn.cu: bias added after the scale, f32 or bf16
// operands at head_dim 64 or 128, any L >= 1.
//
// Both recompute p = exp(s - lse) from the forward's row logsumexp, and take
// delta = rowsum(do * o) (f32 (B, H, L)), which the wrapper computes, as
// JAX's _flash_attention_bwd does in XLA. With dp = do v^T and
// ds = p * (dp - delta):
//   dv = p^T do,   dk = ds^T q * scale,   dq = ds k * scale,   dbias = ds.
//
// flash_attn_bwd_dkv: one block owns (b, h, a tile of 64 keys) and walks the
// query tiles (under causal from the diagonal tile on), with K and V
// row-major and each Q and dO tile transposed in shared memory; it computes
// the transposed score tile s^T and dp^T, writes p^T and ds^T to shared
// memory and accumulates dv and dk in registers.
// flash_attn_bwd_dq: one block owns (b, h, a tile of 64 queries) and walks
// the key tiles (under causal up to the diagonal), with Q and dO row-major
// and each K and V tile transposed; it accumulates dq in registers and, when
// asked, writes ds to a (B, H, L, L) f32 buffer that the wrapper sums to the
// bias's shape. Every output element is written by one thread of one block:
// no atomics, the same bits from run to run.
//
// Bound on the H100 at the GPT-2 training shape (B=16, H=12, L=1024, D=64,
// f32, causal): dkv reads q, k, v, do and the row statistics (203 MB) and
// writes dk, dv (101 MB), 0.09 ms at 3.35 TB/s, against 4 B H L^2 D
// operations for the causal half of q k^T, do v^T, p^T do and ds^T q (51.5
// GFLOP, 0.77 ms at 67 TFLOP/s); dq reads the same and writes dq, 0.08 ms,
// against 3 B H L^2 D (38.7 GFLOP, 0.58 ms): operations, both.

#include "flash_attn_common.cuh"

namespace ffc {
namespace attn {

template <int D>
constexpr size_t bwd_smem_floats() {
  return 2 * kTile * D + 2 * D * kTS + 2 * kTile * kTile;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv, Args a) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // (64, D) keys, row-major
  float* Vs = Ks + kTile * D;                    // (64, D) values, row-major
  float* Qt = Vs + kTile * D;                    // (D, kTS) queries, transposed
  float* dOt = Qt + D * kTS;                     // (D, kTS) output grads, transposed
  float* Pt = dOt + D * kTS;                     // (64 keys, 64 queries) p^T
  float* dSt = Pt + kTile * kTile;               // (64 keys, 64 queries) ds^T
  __shared__ int seg_q[kTile], seg_k[kTile];
  __shared__ float lse_s[kTile], delta_s[kTile];

  const int n_tiles = (a.len + kTile - 1) / kTile;
  const int kt = blockIdx.x;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const size_t base = (size_t)bh * a.len * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = kt * kTile;

  load_rows<D>(Ks, k + base, k0, a.len);
  load_rows<D>(Vs, v + base, k0, a.len);
  load_seg(seg_k, a, b, k0, -2);

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int qt = a.causal ? kt : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's Qt, dOt, Pt and dSt are read
    load_rows_t<D>(Qt, q + base, q0, a.len);
    load_rows_t<D>(dOt, dout + base, q0, a.len);
    load_seg(seg_q, a, b, q0, -1);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < a.len ? lse[(size_t)bh * a.len + r] : INFINITY;
      delta_s[threadIdx.x] = r < a.len ? delta[(size_t)bh * a.len + r] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_abt<D>(s, Ks, Qt, tx, ty);   // s^T[key][query]
    tile_abt<D>(dp, Vs, dOt, tx, ty);  // dp^T[key][query]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = k0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rl = tx + 16 * j;
        const float x = score(a, b, h, q0 + rl, c, s[i][j], seg_q[rl], seg_k[4 * ty + i]);
        const float p = x == -INFINITY ? 0.f : expf(x - lse_s[rl]);
        Pt[(4 * ty + i) * kTile + rl] = p;
        dSt[(4 * ty + i) * kTile + rl] = p * (dp[i][j] - delta_s[rl]);
      }
    }
    __syncthreads();
    tile_pb_t<D>(dv_acc, Pt, dOt, tx, ty);
    tile_pb_t<D>(dk_acc, dSt, Qt, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + 4 * ty + i;
    if (c >= a.len) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const size_t at = base + (size_t)c * D + tx + 16 * j;
      dk[at] = from_f<T>(dk_acc[i][j] * a.scale);
      dv[at] = from_f<T>(dv_acc[i][j]);
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             T* __restrict__ dq, float* __restrict__ ds_out, Args a) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // (64, D) queries, row-major
  float* dOs = Qs + kTile * D;                   // (64, D) output grads, row-major
  float* Kt = dOs + kTile * D;                   // (D, kTS) keys, transposed
  float* Vt = Kt + D * kTS;                      // (D, kTS) values, transposed
  float* dSs = Vt + D * kTS;                     // (64 queries, 64 keys) ds
  __shared__ int seg_q[kTile], seg_k[kTile];
  __shared__ float lse_s[kTile], delta_s[kTile];

  const int n_tiles = (a.len + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const size_t base = (size_t)bh * a.len * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = qt * kTile;

  load_rows<D>(Qs, q + base, q0, a.len);
  load_rows<D>(dOs, dout + base, q0, a.len);
  load_seg(seg_q, a, b, q0, -1);
  if (threadIdx.x < kTile) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < a.len ? lse[(size_t)bh * a.len + r] : INFINITY;
    delta_s[threadIdx.x] = r < a.len ? delta[(size_t)bh * a.len + r] : 0.f;
  }

  float dq_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dq_acc[i][j] = 0.f;

  const int kt_end = a.causal ? qt : n_tiles - 1;
  for (int kt = 0; kt <= kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's Kt, Vt and dSs are read
    load_rows_t<D>(Kt, k + base, k0, a.len);
    load_rows_t<D>(Vt, v + base, k0, a.len);
    load_seg(seg_k, a, b, k0, -2);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_abt<D>(s, Qs, Kt, tx, ty);
    tile_abt<D>(dp, dOs, Vt, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = 4 * ty + i, r = q0 + rl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const float x = score(a, b, h, r, c, s[i][j], seg_q[rl], seg_k[tx + 16 * j]);
        const float p = x == -INFINITY ? 0.f : expf(x - lse_s[rl]);
        const float ds = p * (dp[i][j] - delta_s[rl]);
        dSs[rl * kTile + tx + 16 * j] = ds;
        if (ds_out != nullptr && r < a.len && c < a.len)
          ds_out[((size_t)bh * a.len + r) * a.len + c] = ds;
      }
    }
    __syncthreads();
    tile_pb_t<D>(dq_acc, dSs, Kt, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= a.len) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dq[base + (size_t)r * D + tx + 16 * j] = from_f<T>(dq_acc[i][j] * a.scale);
  }
}

template <int D, typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, const Args& a,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem_floats<D>() * sizeof(float);
  auto kernel = flash_attn_bwd_dkv_kernel<D, T>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.len + kTile - 1) / kTile, a.batch * a.heads);
  kernel<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                           (const T*)dout, (const float*)lse,
                                           (const float*)delta, (T*)dk, (T*)dv, a);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, void* ds, const Args& a,
                      cudaStream_t stream) {
  // one (64, 64) tile of shared memory fewer than the dkv kernel: ds only
  const size_t smem = (bwd_smem_floats<D>() - kTile * kTile) * sizeof(float);
  auto kernel = flash_attn_bwd_dq_kernel<D, T>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.len + kTile - 1) / kTile, a.batch * a.heads);
  kernel<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                           (const T*)dout, (const float*)lse,
                                           (const float*)delta, (T*)dq, (float*)ds, a);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace ffc

extern "C" int ffc_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, const void* bias, const void* seg,
                                      int batch, int heads, int len, int head_dim, int is_bf16,
                                      int causal, int bias_sb, int bias_sh, int bias_sq,
                                      int scale_bits, void* stream) {
  using namespace ffc::attn;
  if (batch < 1 || heads < 1 || len < 1 || batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(batch, heads, len, causal, bias, bias_sb, bias_sh, bias_sq, seg,
                           scale_bits);
  cudaStream_t s = (cudaStream_t)stream;
  if (head_dim == 64)
    return (int)(is_bf16 ? launch_dkv<64, __nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, a, s)
                         : launch_dkv<64, float>(q, k, v, dout, lse, delta, dk, dv, a, s));
  if (head_dim == 128)
    return (int)(is_bf16 ? launch_dkv<128, __nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, a, s)
                         : launch_dkv<128, float>(q, k, v, dout, lse, delta, dk, dv, a, s));
  return (int)cudaErrorInvalidValue;
}

extern "C" int ffc_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, void* ds, const void* bias, const void* seg,
                                     int batch, int heads, int len, int head_dim, int is_bf16,
                                     int causal, int bias_sb, int bias_sh, int bias_sq,
                                     int scale_bits, void* stream) {
  using namespace ffc::attn;
  if (batch < 1 || heads < 1 || len < 1 || batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(batch, heads, len, causal, bias, bias_sb, bias_sh, bias_sq, seg,
                           scale_bits);
  cudaStream_t s = (cudaStream_t)stream;
  if (head_dim == 64)
    return (int)(is_bf16 ? launch_dq<64, __nv_bfloat16>(q, k, v, dout, lse, delta, dq, ds, a, s)
                         : launch_dq<64, float>(q, k, v, dout, lse, delta, dq, ds, a, s));
  if (head_dim == 128)
    return (int)(is_bf16 ? launch_dq<128, __nv_bfloat16>(q, k, v, dout, lse, delta, dq, ds, a, s)
                         : launch_dq<128, float>(q, k, v, dout, lse, delta, dq, ds, a, s));
  return (int)cudaErrorInvalidValue;
}

FFC_EXPORT_ERROR_STRING()
