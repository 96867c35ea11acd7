// flash_attn_bwd_dkv and flash_attn_bwd_dq: the flash-attention backward.
//
// Replace the two backward TPU kernels of JAX's Pallas flash_attention that
// flashfftconv_tpu/ops/attention.py:202 (flash_mha) differentiates through
// (jax/experimental/pallas/ops/tpu/flash_attention.py of jax 0.9.0):
// _flash_attention_bwd_dkv (def at l.941, pallas_call at l.1121, body at
// l.796) and _flash_attention_bwd_dq (def at l.1287, pallas_call at l.1456,
// body at l.1146), which also writes ds, the bias's grad. The contract is
// flash_mha's, as in flash_attn.cu: bias added after the scale, f32, bf16 or f16
// operands at head_dim 64 or any multiple of 128 (above 128 the wide bodies
// of flash_attn_common.cuh, above 512 in D slices across blocks), any B * H,
// any L >= 1.
//
// Both are the bodies attn_bwd_dkv and attn_bwd_dq (flash_attn_common.cuh)
// under FlashMask: they recompute p = exp(s - lse) from the forward's row
// logsumexp, and take delta = rowsum(do * o) (f32 (B, H, L)), which the
// wrapper computes, as JAX's _flash_attention_bwd does in XLA.
// flash_attn_bwd_dkv: one block of 4 warps owns (b, h, a tile of 64 keys)
// and walks the query tiles (under causal from the diagonal tile on),
// accumulating dk and dv. flash_attn_bwd_dq: one block owns (b, h, a tile of
// 64 queries) and walks the key tiles (under causal up to the diagonal),
// accumulating dq, and when asked writes ds to a (B, H, L, L) f32 buffer
// that the wrapper sums to the bias's shape. Every product runs on the
// tensor cores (mma.sync m16n8k8 TF32), split into three passes for f32
// operands so that it keeps f32 accuracy; p and ds stay in registers; the
// walked tiles arrive by cp.async while the previous one is multiplied.
// Every output element is written by one thread of one block: no atomics,
// the same bits from run to run.
//
// Bound on the H100 at the GPT-2 training shape (B=16, H=12, L=1024, D=64,
// f32, causal): dkv reads q, k, v, do and the row statistics (203 MB) and
// writes dk, dv (101 MB), 0.09 ms at 3.35 TB/s, against 4 B H L^2 D
// operations for the causal half of q k^T, do v^T, p^T do and ds^T q (51.5
// GFLOP): 0.77 ms at the f32 67 TFLOP/s, and 0.31 ms as three TF32 passes at
// the tensor cores' 494.7 TFLOP/s; dq reads the same and writes dq, 0.08 ms,
// against 3 B H L^2 D (38.7 GFLOP, 0.58 ms in f32, 0.23 ms on the tensor
// cores): operations, both.

#include "flash_attn_common.cuh"

namespace ffc {
namespace attn {

template <int D, bool SL, typename T>
__global__ void __launch_bounds__(body_threads<D>(), 1)
    flash_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv, FlashMask m) {
  bwd_dkv<D, SL, T>(q, k, v, dout, lse, delta, dk, dv, m);
}

template <int D, bool SL, typename T>
__global__ void __launch_bounds__(body_threads<D>(), 1)
    flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             T* __restrict__ dq, float* __restrict__ ds_out, FlashMask m) {
  bwd_dq<D, SL, T>(q, k, v, dout, lse, delta, dq, ds_out, m);
}

}  // namespace attn
}  // namespace ffc

extern "C" int ffc_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, const void* bias, const void* seg,
                                      int batch, int heads, int len, int head_dim, int dtype,
                                      int causal, int bias_sb, int bias_sh, int bias_sq,
                                      int scale_bits, void* stream) {
  using namespace ffc::attn;
  if (batch < 1 || heads < 1 || len < 1 || !aligned16(q, k, v, dout))
    return (int)cudaErrorInvalidValue;
  const FlashMask m = make_flash_mask(batch, heads, len, head_dim, causal, bias, bias_sb,
                                      bias_sh, bias_sq, seg, scale_bits);
  return (int)dispatch(head_dim, dtype, [&](auto dim, auto t) {
    constexpr int D = decltype(dim)::value;
    constexpr bool SL = decltype(dim)::sliced;
    using T = decltype(t);
    return launch(flash_attn_bwd_dkv_kernel<D, SL, T>, body_threads<D>(), bwd_smem_bytes<D>(),
                  len, batch * heads, m.n_slices, (cudaStream_t)stream, q, k, v, dout, lse, delta, dk, dv, m);
  });
}

extern "C" int ffc_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, void* ds, const void* bias, const void* seg,
                                     int batch, int heads, int len, int head_dim, int dtype,
                                     int causal, int bias_sb, int bias_sh, int bias_sq,
                                     int scale_bits, void* stream) {
  using namespace ffc::attn;
  if (batch < 1 || heads < 1 || len < 1 || !aligned16(q, k, v, dout))
    return (int)cudaErrorInvalidValue;
  const FlashMask m = make_flash_mask(batch, heads, len, head_dim, causal, bias, bias_sb,
                                      bias_sh, bias_sq, seg, scale_bits);
  return (int)dispatch(head_dim, dtype, [&](auto dim, auto t) {
    constexpr int D = decltype(dim)::value;
    constexpr bool SL = decltype(dim)::sliced;
    using T = decltype(t);
    return launch(flash_attn_bwd_dq_kernel<D, SL, T>, body_threads<D>(), bwd_smem_bytes<D>(),
                  len, batch * heads, m.n_slices, (cudaStream_t)stream, q, k, v, dout, lse, delta, dq, ds, m);
  });
}

FFC_EXPORT_ERROR_STRING()
