// splash_attn_fwd: masked attention forward, softmax(q k^T * scale) v under
// a sliding window or a block mask, skipping the tiles the mask hides.
//
// Replaces the forward TPU kernel of JAX's splash attention, which
// flashfftconv_tpu/ops/attention.py reaches through _splash_call (:268-283)
// from flash_mha(window=W) (:186, _splash_local :286-294, a LocalMask) and
// from blocksparse_mha (:331-340, a NumpyMask):
// jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py
// of jax 0.9.0, _splash_attention_forward (def at l.895, pallas_call at
// l.1137, body flash_attention_kernel at l.696). JAX multiplies q by sm_scale
// in q's dtype before the kernel; here the scale multiplies the f32 scores,
// as in the flash kernels. q, k, v f32, bf16 or f16 at head_dim 64 or any
// multiple of 128, any L >= 1 (splash's L multiple of min(512, L) is a TPU tiling
// limit). It writes o in the operands' dtype and the row logsumexp (f32,
// +inf for a row that sees no key, whose o is 0: the JAX package's plain
// contract; JAX's splash kernel leaves such rows nonzero).
//
// Design: the forward bodies of flash_attn_common.cuh (on the tensor cores,
// as in flash_attn.cu) under SplashMask. One block owns
// (b, h, a tile of 64 queries) and walks only the key tiles that hold a kept
// element: for a window W the range max(0, 64 t - W + 1) / 64 .. t,
// computed; for a block mask the tile list of ops/splash_mask.py (splash's
// MaskInfo for 64 x 64 tiles). A hidden tile is never loaded or computed;
// the element predicate runs only on tiles that are not full. Every head
// shares the mask, as the JAX package gives every head the same one.
//
// Bound on the H100 at the windowed GPT training shape (B=8, H=12, L=2048,
// D=64, f32, W=256): it reads q, k, v (151 MB) and writes o and the
// logsumexp (51 MB), 0.06 ms at 3.35 TB/s, against 4 B H L W D f32
// operations for q k^T and p v over the window's elements (12.9 GFLOP,
// 0.19 ms at 67 TFLOP/s): operations. The 150 tiles it visits a (b, h)
// hold 614,400 scores, 1.25x the 491,648 the window keeps (the diagonal
// tile and the window's lower edge are partial).

#include "flash_attn_common.cuh"

namespace ffc {
namespace attn {

template <int D, bool SL, typename T>
__global__ void __launch_bounds__(fwd_threads<D>(), 1)
    splash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                           SplashMask m) {
  fwd<D, SL, T>(q, k, v, o, lse, m);
}

}  // namespace attn
}  // namespace ffc

extern "C" int ffc_splash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, const void* table, const void* blocks, int batch,
                                   int heads, int len, int head_dim, int dtype, int window,
                                   int block_size, int n_blocks, int n_entries, int causal,
                                   int scale_bits, void* stream) {
  using namespace ffc::attn;
  if (!splash_args_ok(batch, heads, len, window, table, blocks, block_size, n_blocks) ||
      !aligned16(q, k, v, v))
    return (int)cudaErrorInvalidValue;
  const SplashMask m = make_splash_mask(batch, heads, len, head_dim, window, table, blocks,
                                        block_size, n_blocks, n_entries, causal, scale_bits);
  return (int)dispatch(head_dim, dtype, [&](auto dim, auto t) {
    constexpr int D = decltype(dim)::value;
    constexpr bool SL = decltype(dim)::sliced;
    using T = decltype(t);
    return launch(splash_attn_fwd_kernel<D, SL, T>, fwd_threads<D>(), fwd_smem_bytes<D>(),
                  len, batch * heads, m.n_slices, (cudaStream_t)stream, q, k, v, o, lse, m);
  });
}

FFC_EXPORT_ERROR_STRING()
