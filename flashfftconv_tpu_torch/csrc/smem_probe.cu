// smem_probe: the card's shared-memory capacity a block, and a copy through
// large shared-memory tiles.
//
// Replaces the two TPU kernels of benchmarks/tpu_vmem_probe.py, which probe
// the TPU's VMEM: `trial` (def at l.42, pallas_call at l.54), a kernel with a
// VMEM scratch of 16-127 MB that writes x*2 to its first and x+1 to its last
// (8, 128) rows and reads both back (x*2 + (x+1) = 4 for ones), and
// `copy_kernel` (pallas_call at l.96), an HBM -> HBM copy times 1.0001
// through large VMEM blocks. On Hopper the scarce fast memory is a block's
// shared memory, at most 227 KB (232,448 bytes) above the 48 KB default and
// only as dynamic shared memory after
// cudaFuncSetAttribute(cudaFuncAttributeMaxDynamicSharedMemorySize).
//
// smem_probe_touch: one block of 256 threads with an `extern __shared__`
// scratch of S bytes writes x*2 to the first 8x128 floats and x+1 to the
// last 8x128, then out = first + last, so the whole allocation is live. A
// size above the card's limit fails at the attribute call
// (cudaErrorInvalidValue) or at the launch (a configuration error that
// cudaGetLastError clears); neither leaves the context in error. It moves
// 8 KB: it measures a capacity, not a rate.
//
// smem_copy: o = x * 1.0001f, through the block's T bytes of dynamic shared
// memory (the `tile`): the first kBarBytes hold S mbarriers and the chunk
// each stage holds, and the rest is a ring of S stages (S = 4 from 32 KB,
// else 2; whole KB each, 4 of 56 KB at the largest tile). A persistent grid
// (as many blocks as the SMs hold at T bytes each) takes chunks of whole KB,
// at most a stage each, from a counter in device memory, each block the
// next one when it has a stage to fill. The copy engine fills and drains
// the stages: thread 0 issues one cp.async.bulk global -> shared a chunk
// (counted on the stage's mbarrier) and, once the stage is multiplied, one
// bulk shared -> global store; every thread waits on the stage's mbarrier
// by parity and multiplies the stage in place in float4s, then fences its
// writes to the async proxy before the barrier after which the store reads
// them. A stage is refilled only after its store has read it
// (cp.async.bulk.wait_group.read): at S = 4 the store of the step before,
// so that the store just issued stays in flight; at S = 2 the store just
// issued. Bound on the H100: bytes (each float read once and written once,
// 8 bytes against 1 multiply). About (S - 1) / S of the tile is in flight
// to or from HBM at any time, so one block of the largest tile keeps more
// bytes in flight a SM than the memory latency needs (~25 KB); a tile that
// the threads load whole, then store whole, leaves one such block's load
// and store phases serial. Chunks taken in the order the blocks ask keep
// the grid's reads near one another in memory: dealt round robin or in
// one segment a block, the blocks drift apart and the copy ran 4-5% slower
// on the H100, whether bulk copies or the threads moved the data. The last
// chunk of x is a shorter copy; n % 4 == 0 and 16-byte alignment keep
// every copy a multiple of 16 bytes.

#include "fft_common.cuh"
#include "wgmma.cuh"

namespace ffc {

constexpr int kProbeRows = 8 * 128;  // one (8, 128) f32 tile
constexpr int kProbeThreads = 256;
constexpr int kCopyThreads = 256;

__global__ void __launch_bounds__(kProbeThreads)
    smem_probe_touch_kernel(const float* __restrict__ x, float* __restrict__ out, int floats) {
  extern __shared__ float scratch[];
  for (int i = threadIdx.x; i < kProbeRows; i += blockDim.x) {
    const float v = x[i];
    scratch[i] = v * 2.0f;
    scratch[floats - kProbeRows + i] = v + 1.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kProbeRows; i += blockDim.x)
    out[i] = scratch[i] + scratch[floats - kProbeRows + i];
}

// The ring's mbarriers (one a stage, at most 4), then the chunk each stage
// holds, before the stages.
constexpr int kBarBytes = 128;
constexpr int kIdsOffset = 64;

// Each step takes the next chunk of chunk4 float4s (the last chunk of x
// shorter) from counter[0], in the stage of the step mod S, until the
// chunks run out; the last block to finish sets both counters back to 0.
template <int S>
__global__ void __launch_bounds__(kCopyThreads)
    smem_copy_kernel(const float4* __restrict__ x, float4* __restrict__ o,
                     unsigned int* __restrict__ counter, long long n4, int chunk4, int stage4,
                     unsigned int chunks) {
  // Stores still reading their stage when one is refilled: the refill at
  // step j takes the stage stored at step j - kLag.
  constexpr int kLag = S > 2 ? 1 : 0;
  extern __shared__ __align__(128) unsigned char smem_copy_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_copy_raw);
  unsigned int* ids = reinterpret_cast<unsigned int*>(smem_copy_raw + kIdsOffset);
  float4* stages = reinterpret_cast<float4*>(smem_copy_raw + kBarBytes);
  const bool leader = threadIdx.x == 0;
  auto count = [&](unsigned int c) {
    const long long left = n4 - (long long)c * chunk4;
    return (int)(left < chunk4 ? left : chunk4);
  };
  // Take the next chunk into stage s; past the last chunk, complete the
  // stage's phase with no bytes, which ends the walk.
  auto fetch = [&](int s) {
    const unsigned int c = atomicAdd(&counter[0], 1u);
    ids[s] = c;
    const uint32_t bytes = c < chunks ? (uint32_t)count(c) * 16u : 0u;
    wg::mbar_expect(&full[s], bytes);
    if (bytes) wg::bulk_load(stages + s * stage4, x + (long long)c * chunk4, bytes, &full[s]);
  };
  if (leader) {
    for (int s = 0; s < S; ++s) wg::mbar_init(&full[s]);
    wg::mbar_init_fence();
    for (int s = 0; s < S; ++s) fetch(s);
  }
  __syncthreads();
  for (int j = 0;; ++j) {
    const int s = j % S;
    wg::mbar_wait(&full[s], (uint32_t)(j / S) & 1u);
    const unsigned int c = ids[s];
    if (c >= chunks) break;
    float4* t = stages + s * stage4;
    const int cnt = count(c);
    for (int i = threadIdx.x; i < cnt; i += kCopyThreads) {
      float4 v = t[i];
      v.x *= 1.0001f;
      v.y *= 1.0001f;
      v.z *= 1.0001f;
      v.w *= 1.0001f;
      t[i] = v;
    }
    wg::fence_smem_for_mma();  // the products, to the store's async proxy
    __syncthreads();
    if (leader) {
      wg::bulk_store(o + (long long)c * chunk4, t, (uint32_t)cnt * 16u);
      wg::bulk_commit();
      if (j >= kLag) {
        wg::bulk_wait_read<kLag>();
        fetch((j - kLag) % S);
      }
    }
  }
  if (leader) {
    wg::bulk_wait<0>();
    __threadfence();
    if (atomicAdd(&counter[1], 1u) == gridDim.x - 1) {  // every block has taken its last
      counter[0] = 0;
      counter[1] = 0;
    }
  }
}

}  // namespace ffc

// out[0..7]: the opt-in shared memory a block, the shared memory an SM, the
// default shared memory a block, the registers a block, the registers an SM,
// the SM count, the registers a thread of smem_probe_touch_kernel and of
// smem_copy_kernel.
extern "C" int ffc_smem_device_attrs(int* out, int device) {
  const cudaDeviceAttr attrs[6] = {
      cudaDevAttrMaxSharedMemoryPerBlockOptin, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrMaxSharedMemoryPerBlock,      cudaDevAttrMaxRegistersPerBlock,
      cudaDevAttrMaxRegistersPerMultiprocessor, cudaDevAttrMultiProcessorCount};
  for (int i = 0; i < 6; ++i) {
    cudaError_t err = cudaDeviceGetAttribute(out + i, attrs[i], device);
    if (err != cudaSuccess) return (int)err;
  }
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, ffc::smem_probe_touch_kernel);
  if (err != cudaSuccess) return (int)err;
  out[6] = fa.numRegs;
  err = cudaFuncGetAttributes(&fa, ffc::smem_copy_kernel<4>);
  if (err != cudaSuccess) return (int)err;
  out[7] = fa.numRegs;
  return (int)cudaSuccess;
}

// Opt smem_probe_touch_kernel in to `bytes` of dynamic shared memory. A
// refused size returns its error, which cudaGetLastError then clears.
extern "C" int ffc_smem_set_limit(int bytes) {
  cudaError_t err = cudaFuncSetAttribute(ffc::smem_probe_touch_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// One block of smem_probe_touch_kernel with `bytes` of dynamic shared memory
// (after ffc_smem_set_limit(bytes)); x and out are 8x128 f32. Returns the
// launch's error, cleared from the context.
extern "C" int ffc_smem_probe_touch(const void* x, void* out, int bytes, void* stream) {
  if (bytes < 2 * ffc::kProbeRows * (int)sizeof(float) || bytes % (int)sizeof(float))
    return (int)cudaErrorInvalidValue;
  ffc::smem_probe_touch_kernel<<<1, ffc::kProbeThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, bytes / (int)sizeof(float));
  return (int)cudaGetLastError();
}

// o = x * 1.0001f over n f32 (n a multiple of 4, x and o 16-byte aligned),
// through tile_bytes of dynamic shared memory a block: the mbarriers, then
// `stages` stages (2 or 4) of stage_bytes (a multiple of 1024) each.
// counter: two unsigned ints, 0 before the launch and 0 again after it; one
// pair a stream. Grid: as many blocks as the SMs hold at tile_bytes; chunks
// of whole KB, at most a stage, sized so that the blocks could take the
// same number each.
extern "C" int ffc_smem_copy(const void* x, void* o, void* counter, int n, int tile_bytes,
                             int stages, int stage_bytes, void* stream) {
  if (n < 0 || n % 4 || (stages != 2 && stages != 4) || stage_bytes < 1024 ||
      stage_bytes % 1024 || ffc::kBarBytes + stages * stage_bytes > tile_bytes)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const auto kernel = stages == 4 ? ffc::smem_copy_kernel<4> : ffc::smem_copy_kernel<2>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tile_bytes);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, ffc::kCopyThreads,
                                                        tile_bytes);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const long long n4 = n / 4, slots = (long long)sms * per_sm, stage4 = stage_bytes / 16;
  const long long rounds = (n4 + slots * stage4 - 1) / (slots * stage4);  // chunks a block
  long long chunk4 = (n4 + slots * rounds - 1) / (slots * rounds);
  chunk4 = (chunk4 + 63) / 64 * 64;  // whole KB, still at most a stage
  const long long chunks = (n4 + chunk4 - 1) / chunk4;
  const int grid = (int)(chunks < slots ? chunks : slots);
  kernel<<<grid, ffc::kCopyThreads, tile_bytes, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)o, (unsigned int*)counter, n4, (int)chunk4, (int)stage4,
      (unsigned int)chunks);
  return (int)cudaGetLastError();
}

FFC_EXPORT_ERROR_STRING()
