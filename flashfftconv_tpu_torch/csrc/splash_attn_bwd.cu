// splash_attn_bwd_dkv and splash_attn_bwd_dq: the masked attention backward
// under a sliding window or a block mask, skipping the tiles the mask hides.
//
// Replace the backward TPU kernel the JAX package runs for splash attention
// (flashfftconv_tpu/ops/attention.py:251-265 sets use_fused_bwd_kernel=True):
// jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py
// of jax 0.9.0, _splash_attention_bwd_dkv (def at l.1857, pallas_call at
// l.2196, body _flash_attention_dkv_kernel at l.1669), which writes dk, dv
// and a dq unreduced over the key blocks, (L / 512, ...) times dq's memory,
// summed at l.2232-2234. Here dk and dv come from one kernel and dq from
// another, each output with one writer: no unreduced dq, no atomics, the same
// bits from run to run. The separate dq kernel of that file (l.1635) is not
// reached by the package; splash_attn_bwd_dq computes its function.
//
// Design: the bodies attn_bwd_dkv and attn_bwd_dq (flash_attn_common.cuh)
// under SplashMask, on the tensor cores as in flash_attn_bwd.cu (split-TF32
// mma.sync, p and ds in registers, a cp.async ring). They recompute
// p = exp(s - lse) from the forward's row logsumexp and take
// delta = rowsum(do * o) from the wrapper.
// splash_attn_bwd_dkv: one block owns (b, h, a tile of 64 keys) and walks
// the query tiles that see it (for a window W, t .. (64 t + 62 + W) / 64;
// for a block mask the table's transposed list), accumulating dk and dv.
// splash_attn_bwd_dq: one block owns (b, h, a tile of 64 queries) and walks
// its key tiles, as the forward does, accumulating dq. The scale multiplies
// the f32 scores (JAX scales q in its dtype first). Any B * H.
//
// Bound on the H100 at the windowed GPT training shape (B=8, H=12, L=2048,
// D=64, f32, W=256): each reads q, k, v, do and the row statistics (203 MB)
// and writes dk, dv (101 MB) or dq (50 MB), about 0.09 ms at 3.35 TB/s,
// against 8 B H L W D operations for dK/dV (q k^T, do v^T, p^T do, ds^T q
// over the window's elements, 25.8 GFLOP: 0.38 ms at the f32 67 TFLOP/s,
// 0.16 ms as three TF32 passes at 494.7 TFLOP/s) and 6 B H L W D for dQ
// (q k^T, do v^T, ds k; 0.29 ms in f32, 0.12 ms on the tensor cores):
// operations, both.

#include "flash_attn_common.cuh"

namespace ffc {
namespace attn {

template <int D, typename T>
__global__ void __launch_bounds__(kBwdThreads, 1)
    splash_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               T* __restrict__ dk, T* __restrict__ dv, SplashMask m) {
  attn_bwd_dkv<D, T>(q, k, v, dout, lse, delta, dk, dv, m);
}

template <int D, typename T>
__global__ void __launch_bounds__(kBwdThreads, 1)
    splash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              T* __restrict__ dq, SplashMask m) {
  attn_bwd_dq<D, T>(q, k, v, dout, lse, delta, dq, nullptr, m);
}

}  // namespace attn
}  // namespace ffc

extern "C" int ffc_splash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, const void* table, const void* blocks,
                                       int batch, int heads, int len, int head_dim, int dtype,
                                       int window, int block_size, int n_blocks, int n_entries,
                                       int causal, int scale_bits, void* stream) {
  using namespace ffc::attn;
  if (!splash_args_ok(batch, heads, len, window, table, blocks, block_size, n_blocks) ||
      !aligned16(q, k, v, dout))
    return (int)cudaErrorInvalidValue;
  const SplashMask m = make_splash_mask(batch, heads, len, window, table, blocks, block_size,
                                        n_blocks, n_entries, causal, scale_bits);
  return (int)dispatch(head_dim, dtype, [&](auto dim, auto t) {
    constexpr int D = decltype(dim)::value;
    using T = decltype(t);
    return launch(splash_attn_bwd_dkv_kernel<D, T>, kBwdThreads, bwd_smem_bytes<D>(), len,
                  batch * heads, (cudaStream_t)stream, q, k, v, dout, lse, delta, dk, dv, m);
  });
}

extern "C" int ffc_splash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, const void* table, const void* blocks, int batch,
                                      int heads, int len, int head_dim, int dtype, int window,
                                      int block_size, int n_blocks, int n_entries, int causal,
                                      int scale_bits, void* stream) {
  using namespace ffc::attn;
  if (!splash_args_ok(batch, heads, len, window, table, blocks, block_size, n_blocks) ||
      !aligned16(q, k, v, dout))
    return (int)cudaErrorInvalidValue;
  const SplashMask m = make_splash_mask(batch, heads, len, window, table, blocks, block_size,
                                        n_blocks, n_entries, causal, scale_bits);
  return (int)dispatch(head_dim, dtype, [&](auto dim, auto t) {
    constexpr int D = decltype(dim)::value;
    using T = decltype(t);
    return launch(splash_attn_bwd_dq_kernel<D, T>, kBwdThreads, bwd_smem_bytes<D>(), len,
                  batch * heads, (cudaStream_t)stream, q, k, v, dout, lse, delta, dq, m);
  });
}

FFC_EXPORT_ERROR_STRING()
