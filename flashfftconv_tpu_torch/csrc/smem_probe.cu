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
// smem_copy: o = x * 1.0001f. Each block stages tiles of T bytes through
// dynamic shared memory: 16-byte loads of a tile into shared memory, a
// barrier, 16-byte stores of the product, a barrier; blocks stride over the
// tiles. Bound on the H100: bytes (each float read once and written once,
// 8 bytes against 1 multiply). A tile of 16 KB lets 8 blocks share an SM;
// the largest tile leaves one block an SM with no asynchronous copy, so its
// loads and stores do not overlap another block's.

#include "fft_common.cuh"

namespace ffc {

constexpr int kProbeRows = 8 * 128;  // one (8, 128) f32 tile
constexpr int kProbeThreads = 256;
constexpr int kCopyThreads = 512;

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

__global__ void __launch_bounds__(kCopyThreads)
    smem_copy_kernel(const float4* __restrict__ x, float4* __restrict__ o, long long n4,
                     int tile4) {
  extern __shared__ float4 tile[];
  for (long long t0 = (long long)blockIdx.x * tile4; t0 < n4;
       t0 += (long long)gridDim.x * tile4) {
    const int cnt = (int)(n4 - t0 < tile4 ? n4 - t0 : tile4);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) tile[i] = x[t0 + i];
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      float4 v = tile[i];
      v.x *= 1.0001f;
      v.y *= 1.0001f;
      v.z *= 1.0001f;
      v.w *= 1.0001f;
      o[t0 + i] = v;
    }
    __syncthreads();
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
  err = cudaFuncGetAttributes(&fa, ffc::smem_copy_kernel);
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

// o = x * 1.0001f over n f32 (n a multiple of 4, 16-byte aligned), through
// shared-memory tiles of tile_bytes (a multiple of 16).
extern "C" int ffc_smem_copy(const void* x, void* o, int n, int tile_bytes, void* stream) {
  if (n < 0 || n % 4 || tile_bytes < 16 || tile_bytes % 16) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(ffc::smem_copy_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, tile_bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const long long n4 = n / 4;
  const int tile4 = tile_bytes / 16;
  const long long tiles = (n4 + tile4 - 1) / tile4;
  const int grid = (int)(tiles < 65535 * 16 ? tiles : 65535 * 16);
  ffc::smem_copy_kernel<<<grid, ffc::kCopyThreads, tile_bytes, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)o, n4, tile4);
  return (int)cudaGetLastError();
}

FFC_EXPORT_ERROR_STRING()
