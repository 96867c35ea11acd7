// flash_attn_fwd: the flash-attention forward, softmax(q k^T * scale + bias) v.
//
// Replaces the TPU kernel of JAX's Pallas flash_attention that
// flashfftconv_tpu/ops/attention.py:202 (flash_mha) calls:
// jax/experimental/pallas/ops/tpu/flash_attention.py, _flash_attention_impl
// (def at l.589 of jax 0.9.0, pallas_call at l.758, body _flash_attention_kernel
// at l.331). Its contract here is flash_mha's: the bias is added after the
// scale (the Pallas kernel adds `ab` before it, so flash_mha pre-divides),
// q, k, v f32, bf16 or f16 at head_dim 64 or any multiple of 128, any B * H,
// any L >= 1, causal or not, optional segment ids. It writes o in the
// operands' dtype and the row logsumexp m + log(l) (f32, +inf for a row
// that sees no key) for the backward, where the Pallas kernel saves l and m
// apart.
//
// Design: every product on the tensor cores, split-TF32 for f32 operands
// (three passes, so that it keeps f32 accuracy). One block, or one cluster
// of blocks, owns (b, h, a tile of 64 queries) and walks the key tiles,
// under causal up to the diagonal tile; the query tiles of the last
// (heaviest) rows are launched first. At D = 64 and 128 the body attn_fwd
// (flash_attn_common.cuh) under FlashMask: 4 warps of 16 queries keep Q, K
// and V come through a two-stage cp.async ring, and s, p and o stay in
// mma.sync C fragments (p is the A fragment of p v in registers). From
// D = 256 to 1024 the body attn_fwd_wg (flash_attn_fwd_wide.cuh): a thread
// block cluster of D / 128 blocks, 128 columns a block, on wgmma; each block
// computes its columns' partial scores against a whole key tile, the
// cluster sums them once (in slice order, over distributed shared memory),
// the block that owns a query row runs its online softmax and hands every
// block the same p, and each block accumulates its own columns of o; K and
// V come by TMA in f32. Above 1024 (a cluster past the portable 8 blocks)
// the D-sliced body attn_fwd_wide (flash_attn_common.cuh): D slices of 256
// columns across blocks, each computing the scores over all of D. The
// ragged last tile is masked, and a row with no visible key so far keeps
// m = -inf, p = 0 and l = 0, so no NaN arises. A refused launch (a cluster
// that fits no set of SMs) returns its error to the wrapper, which raises.
//
// Bound on the H100 at the GPT-2 training shape (B=16, H=12, L=1024, D=64,
// f32, causal): it reads q, k, v (151 MB) and writes o and the logsumexp
// (51 MB), 0.06 ms at 3.35 TB/s, against 2 B H L^2 D f32 operations for the
// causal half of q k^T and p v (25.8 GFLOP, 0.38 ms at the f32 67 TFLOP/s;
// 0.16 ms as three TF32 passes at the tensor cores' 494.7 TFLOP/s):
// operations. At the @640 timing shape (B=4, H=8, L=2048, D=640, f32,
// causal): 171.8 GFLOP, 1.04 ms on the tensor cores, against 0.28 ms of
// bytes: operations.

#include "flash_attn_fwd_wide.cuh"

namespace ffc {
namespace attn {

template <int D, bool SL, typename T>
__global__ void __launch_bounds__(fwd_threads<D>(), 1)
    flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                          FlashMask m) {
  fwd<D, SL, T>(q, k, v, o, lse, m);
}

// From head_dim 256 to 1024: flash_attn_fwd_wide.cuh's clustered body.
template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_attn_fwd_wg_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                             FlashMask m, const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map) {
  attn_fwd_wg<T, FlashMask>(q, k, v, o, lse, m, &k_map, &v_map);
}

}  // namespace attn
}  // namespace ffc

extern "C" int ffc_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                  void* lse, const void* bias, const void* seg, int batch,
                                  int heads, int len, int head_dim, int dtype, int causal,
                                  int bias_sb, int bias_sh, int bias_sq, int scale_bits,
                                  void* stream) {
  using namespace ffc::attn;
  if (batch < 1 || heads < 1 || len < 1 || !aligned16(q, k, v, v))
    return (int)cudaErrorInvalidValue;
  const FlashMask m = make_flash_mask(batch, heads, len, head_dim, causal, bias, bias_sb,
                                      bias_sh, bias_sq, seg, scale_bits);
  if (clustered(head_dim))
    return (int)dispatch_dtype(dtype, 0, [&](auto, auto t) {
      using T = decltype(t);
      CUtensorMap k_map, v_map;
      const cudaError_t err = fwd_maps<T>(k_map, v_map, k, v, batch * heads, len, head_dim);
      if (err != cudaSuccess) return err;
      return launch_clustered(flash_attn_fwd_wg_kernel<T>,
                              wg_fwd_smem_bytes<std::is_same<T, float>::value>(), len,
                              batch * heads, head_dim, (cudaStream_t)stream, q, k, v, o, lse, m,
                              k_map, v_map);
    });
  return (int)dispatch(head_dim, dtype, [&](auto dim, auto t) {
    constexpr int D = decltype(dim)::value;
    constexpr bool SL = decltype(dim)::sliced;
    using T = decltype(t);
    return launch(flash_attn_fwd_kernel<D, SL, T>, fwd_threads<D>(), fwd_smem_bytes<D>(), len,
                  batch * heads, m.n_slices, (cudaStream_t)stream, q, k, v, o, lse, m);
  });
}

FFC_EXPORT_ERROR_STRING()
