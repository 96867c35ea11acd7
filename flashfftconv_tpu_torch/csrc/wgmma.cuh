// Hopper (sm_90a) primitives of the wide attention bodies
// (flash_attn_bwd_wide.cuh, flash_attn_fwd_wide.cuh): warpgroup TF32
// products (wgmma.mma_async with A in registers and B in shared memory),
// their shared-memory descriptors, tensor-memory-accelerator (TMA) loads
// with their mbarriers, 1-D bulk copies between global and shared memory
// (smem_probe.cu's smem_copy), and the thread block cluster's barrier and
// distributed shared memory.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ffc {
namespace wg {

// The descriptor of a K-major operand in shared memory without swizzle:
// "core matrices" of 8 rows by 16 bytes (4 TF32 values), each 128
// contiguous bytes (row r of it at 16 r), lbo bytes apart along K and sbo
// bytes apart along M or N (the 8-row groups). All three 16-byte aligned.
__device__ __forceinline__ uint64_t smem_desc(const void* base, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(base);
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// Order this warpgroup's register and shared-memory accesses before the
// products issued next.
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Wait until at most N of the groups this warpgroup committed are still
// running.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products (it sees each wgmma as done when issued), and
// from reusing the registers of an A fragment before they are read: after
// the wait.
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void hold(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d (64 x 32, f32) = a b + (acc ? d : 0): a the (64 x 8) TF32 A fragment
// in registers (warp w of the group rows 16 w .., as mma.sync's m16n8k8
// fragment: {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]}), b (32 x 8)
// K-major at desc. d[i]: row 16 w + g + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 t + i % 2.
__device__ __forceinline__ void mma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                        int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// The same for a (64 x 64) d and a (64 x 8) b.
__device__ __forceinline__ void mma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                        int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

template <int N>
__device__ __forceinline__ void mma(float (&d)[N], const uint32_t (&a)[4], uint64_t desc,
                                    int acc) {
  static_assert(N == 16 || N == 32, "m64n32k8 or m64n64k8");
  if constexpr (N == 16)
    mma_n32(d, a, desc, acc);
  else
    mma_n64(d, a, desc, acc);
}

// Make the shared memory this thread sees through the generic proxy (its
// plain stores and cp.async copies, and what other blocks stored into it
// before a barrier or mbarrier it waited on) visible to the async proxy that
// wgmma reads B through; a barrier follows.
__device__ __forceinline__ void fence_smem_for_mma() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// --- TMA loads and mbarriers --------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// An mbarrier that one arrival (with the bytes it expects) completes.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive, expecting `bytes` more of asynchronous copies into this phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// --- 1-D bulk copies between global and shared memory ------------------------
// Addresses 16-byte aligned, sizes multiples of 16 bytes.

// bytes from global src into this block's shared memory at dst, counted on
// bar (after mbar_expect of them).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// bytes of this block's shared memory at src to global dst, in the bulk group
// that the next bulk_commit closes. The writes of src must be fenced to the
// async proxy (fence_smem_for_mma) before a barrier that precedes the copy.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's committed bulk groups still read
// their shared memory (which may then be written again).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// Wait until at most N of this thread's committed bulk groups are still
// running (their writes to global memory done).
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

// The box of a 4-D tensor map at coordinates (c0, c1, c2, c3) into shared
// memory at dst (128-byte aligned), completing on bar.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// The box of a 3-D tensor map at coordinates (c0, c1, c2) into shared memory
// at dst, completing on bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// --- the thread block cluster ------------------------------------------------

// Every thread of every block of the cluster arrives and waits: writes
// before it (to any block's shared memory) are visible after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The shared-memory address of p (a pointer into this block's shared
// memory) in block `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"(rank));
  return r;
}

// v into block `rank`'s shared memory at addr (map_rank), counting its 16
// bytes on that block's mbarrier bar (a shared::cluster address too).
__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// bytes (a multiple of 16) from this block's shared memory at src to block
// `rank`'s at dst (map_rank, 16-byte aligned), counted on that block's
// mbarrier bar (map_rank). The writes of src must be fenced to the async
// proxy (fence_smem_for_mma) before a barrier that precedes the copy.
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst, const void* src, uint32_t bytes,
                                                  uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(dst),
      "r"(smem_addr(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// A plain store into block `rank`'s shared memory at addr (map_rank),
// visible there after a cluster barrier.
__device__ __forceinline__ void st_cluster(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

}  // namespace wg
}  // namespace ffc
