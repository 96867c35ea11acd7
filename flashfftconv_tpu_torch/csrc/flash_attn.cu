// flash_attn_fwd: the flash-attention forward, softmax(q k^T * scale + bias) v.
//
// Replaces the TPU kernel of JAX's Pallas flash_attention that
// flashfftconv_tpu/ops/attention.py:202 (flash_mha) calls:
// jax/experimental/pallas/ops/tpu/flash_attention.py, _flash_attention_impl
// (def at l.589 of jax 0.9.0, pallas_call at l.758, body _flash_attention_kernel
// at l.331). Its contract here is flash_mha's: the bias is added after the
// scale (the Pallas kernel adds `ab` before it, so flash_mha pre-divides),
// q, k, v f32 or bf16 at head_dim 64 or 128, any L >= 1, causal or not,
// optional segment ids. It writes o in the operands' dtype and the row
// logsumexp m + log(l) (f32, +inf for a row that sees no key) for the
// backward, where the Pallas kernel saves l and m apart.
//
// Design. One block owns (b, h, a tile of 64 queries): the query tile stays
// in shared memory while the block walks the key tiles, each K tile
// transposed and each V tile row-major in shared memory. Scores, the online
// softmax (running max m and sum l a row, rescaling the accumulator by
// exp(m_old - m_new)) and the (64, D) accumulator live in registers, f32
// throughout. Under causal the block stops at the diagonal tile; tiles of the
// last (heaviest) query tiles are launched first. The ragged last tile is
// masked, and a row with no visible key so far keeps m = -inf, p = 0 and
// l = 0, so no NaN arises.
//
// Bound on the H100 at the GPT-2 training shape (B=16, H=12, L=1024, D=64,
// f32, causal): it reads q, k, v (151 MB) and writes o and the logsumexp
// (51 MB), 0.06 ms at 3.35 TB/s, against 2 B H L^2 D f32 operations for the
// causal half of q k^T and p v (25.8 GFLOP, 0.38 ms at the f32 67 TFLOP/s):
// operations. The f32 FMAs run on the CUDA cores; tensor cores are later
// work.

#include "flash_attn_common.cuh"

namespace ffc {
namespace attn {

template <int D>
constexpr size_t fwd_smem_floats() {
  return 2 * kTile * D + D * kTS + kTile * kTile;  // Qs, Vs, Kt, Ps
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                          Args a) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // (64, D) queries, row-major
  float* Vs = Qs + kTile * D;                    // (64, D) values, row-major
  float* Kt = Vs + kTile * D;                    // (D, kTS) keys, transposed
  float* Ps = Kt + D * kTS;                      // (64, 64) probabilities, row-major
  __shared__ int seg_q[kTile], seg_k[kTile];

  const int n_tiles = (a.len + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const size_t base = (size_t)bh * a.len * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = qt * kTile;

  load_rows<D>(Qs, q + base, q0, a.len);
  load_seg(seg_q, a, b, q0, -1);

  float acc[4][D / 16];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  const int kt_end = a.causal ? qt : n_tiles - 1;
  for (int kt = 0; kt <= kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's Kt, Vs and Ps are read
    load_rows_t<D>(Kt, k + base, k0, a.len);
    load_rows<D>(Vs, v + base, k0, a.len);
    load_seg(seg_k, a, b, k0, -2);
    __syncthreads();

    float s[4][4] = {};
    tile_abt<D>(s, Qs, Kt, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = score(a, b, h, r, k0 + tx + 16 * j, s[i][j], seg_q[4 * ty + i],
                        seg_k[tx + 16 * j]);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(4 * ty + i) * kTile + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
    tile_pb<D>(acc, Ps, Vs, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= a.len) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) o[base + (size_t)r * D + tx + 16 * j] = from_f<T>(acc[i][j] * inv);
    if (tx == 0) lse[(size_t)bh * a.len + r] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
}

template <int D, typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                       const Args& a, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats<D>() * sizeof(float);
  auto kernel = flash_attn_fwd_kernel<D, T>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.len + kTile - 1) / kTile, a.batch * a.heads);
  kernel<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o,
                                           (float*)lse, a);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace ffc

extern "C" int ffc_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                  void* lse, const void* bias, const void* seg, int batch,
                                  int heads, int len, int head_dim, int is_bf16, int causal,
                                  int bias_sb, int bias_sh, int bias_sq, int scale_bits,
                                  void* stream) {
  using namespace ffc::attn;
  if (batch < 1 || heads < 1 || len < 1 || batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(batch, heads, len, causal, bias, bias_sb, bias_sh, bias_sq, seg,
                           scale_bits);
  cudaStream_t s = (cudaStream_t)stream;
  if (head_dim == 64)
    return (int)(is_bf16 ? launch_fwd<64, __nv_bfloat16>(q, k, v, o, lse, a, s)
                         : launch_fwd<64, float>(q, k, v, o, lse, a, s));
  if (head_dim == 128)
    return (int)(is_bf16 ? launch_fwd<128, __nv_bfloat16>(q, k, v, o, lse, a, s)
                         : launch_fwd<128, float>(q, k, v, o, lse, a, s));
  return (int)cudaErrorInvalidValue;
}

FFC_EXPORT_ERROR_STRING()
