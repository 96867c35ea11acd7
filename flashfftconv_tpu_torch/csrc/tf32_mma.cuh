// Warp-level primitives of the attention backward (flash_attn_common.cuh):
// the m16n8k8 TF32 tensor-core product and 16-byte asynchronous copies from
// global to shared memory. sm_80 and later.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ffc {

// d += a b on the tensor cores for one (16 x 8) tile, a (16 x 8) and b
// (8 x 8) in TF32, f32 accumulation. Fragments as the PTX ISA lays them
// out, with g = lane / 4 and t = lane % 4: a = {A[g][t], A[g+8][t],
// A[g][t+4], A[g+8][t+4]}, b = {B[t][g], B[t+4][g]}, d = {D[g][2t],
// D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global memory at src to shared memory at dst without
// passing through registers.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

// Close the group of copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N committed groups are still in flight (the thread's
// own copies; a __syncthreads then makes every thread's visible).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace ffc
