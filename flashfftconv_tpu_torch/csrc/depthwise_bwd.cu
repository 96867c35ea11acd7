// depthwise_bwd: backward of the short K-tap depthwise conv1d (depthwise.cu),
// BHL and BLH layouts, any zero padding.
//
// Replaces the TPU kernel _pallas_depthwise_bwd (flashfftconv_tpu/ops/
// depthwise.py, def at l.360, pallas_call at l.492). With the forward
//   out[l] = bias + sum_t w[t] x[l + t - pad_left],  0 <= l < out_len,
// and x zero outside [0, L):
//   du[i]  = sum_t w[t] dout[i - t + pad_left]   (dout zero outside [0, out_len))
//   dk[t]  = sum_{b,l} x[l + t - pad_left] dout[l]
//   dbias  = sum_{b,l} dout[l]
// The JAX kernel needs pad_left + pad_right == K - 1 (out_len == L); here
// du's tiles run over [0, L) and dk's over [0, out_len), so any padding
// works.
//
// Design on the H100. The TPU kernel accumulates dk and dbias over its
// sequential (batch, L-tile) grid axes in one revisited output block. Here
// blocks run in no order and there are no float atomics: every block stages
// its dout tile (with the halo du needs) and its x tile (with the K-1 halo dk
// needs) in shared memory as f32, writes du for its tile, and writes its
// K+1 sums (dk taps and dbias) as f32 partials, reduced inside the block in a
// fixed order. A second small launch (depthwise_bwd_finish) adds the
// partials of each channel over (batch, tile) in a fixed order, so dk and
// dbias are deterministic. BHL: a block is one (b, d) row by 1024 positions,
// threads on consecutive l. BLH: a block is 32 channels by 64 positions,
// threads on consecutive d.
//
// Bound on the H100: bytes. At B=4, D=2304, L=8192, K=3 in bf16 the kernel
// reads 151 MB each of x and dout and writes 151 MB of du (about 135 us at
// 3.35 TB/s) for 2K+2K+1 f32 operations a position; the partials are
// 1.2 MB.

#include "fft_common.cuh"

namespace ffc {

constexpr int kBhlThreads = 256;
constexpr int kBhlPerThread = 4;
constexpr int kBhlTile = kBhlThreads * kBhlPerThread;
constexpr int kBlhChannels = 32;
constexpr int kBlhRows = 8;
constexpr int kBlhTile = 64;
constexpr int kFinishThreads = 256;

// The lowest dout index a tile starting at l0 reads, relative to l0.
__host__ __device__ __forceinline__ int dout_lo(int k, int pad_left) {
  return pad_left - (k - 1) < 0 ? pad_left - (k - 1) : 0;
}

__host__ __device__ __forceinline__ int dout_span(int tile, int k, int pad_left) {
  return tile + pad_left - dout_lo(k, pad_left);
}

// x (rows, length), dout (rows, out_len), w (D, K), rows = B * D;
// grid (rows, tiles). partials (B * tiles, D, K + 1).
template <typename T>
__global__ void __launch_bounds__(kBhlThreads)
    depthwise_bwd_bhl_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                             const float* __restrict__ w, T* __restrict__ du,
                             float* __restrict__ partials, int channels, int length, int k,
                             int pad_left, int out_len) {
  extern __shared__ float smem[];
  __shared__ float red[kBhlThreads / 32];
  const size_t row = blockIdx.x;
  const int d = (int)(row % channels);
  const int b = (int)(row / channels);
  const int tile = blockIdx.y;
  const int l0 = tile * kBhlTile;
  x += row * length;
  dout += row * out_len;
  du += row * length;
  const int lo = dout_lo(k, pad_left);
  const int d_span = dout_span(kBhlTile, k, pad_left);
  const int x_span = kBhlTile + k - 1;
  float* td = smem;  // td[i] = dout[l0 + lo + i]
  float* tx = smem + d_span;  // tx[i] = x[l0 - pad_left + i]
  for (int i = threadIdx.x; i < d_span; i += blockDim.x) {
    const int src = l0 + lo + i;
    td[i] = (src >= 0 && src < out_len) ? to_f(dout[src]) : 0.f;
  }
  for (int i = threadIdx.x; i < x_span; i += blockDim.x) {
    const int src = l0 - pad_left + i;
    tx[i] = (src >= 0 && src < length) ? to_f(x[src]) : 0.f;
  }
  __syncthreads();
  const float* wd = w + (size_t)d * k;
#pragma unroll
  for (int q = 0; q < kBhlPerThread; ++q) {
    const int j = q * kBhlThreads + threadIdx.x;
    if (l0 + j < length) {
      float acc = 0.f;
      for (int t = 0; t < k; ++t) acc += wd[t] * td[j - t + pad_left - lo];
      du[l0 + j] = from_f<T>(acc);
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* out = partials + (((size_t)b * gridDim.y + tile) * channels + d) * (k + 1);
  for (int t = 0; t <= k; ++t) {
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kBhlPerThread; ++q) {
      const int j = q * kBhlThreads + threadIdx.x;
      if (l0 + j < out_len) v += t < k ? tx[j + t] * td[j - lo] : td[j - lo];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int i = 0; i < kBhlThreads / 32; ++i) s += red[i];
      out[t] = s;
    }
    __syncthreads();
  }
}

// x (B, length, D), dout (B, out_len, D), w (K, D); grid (D tiles, L tiles,
// B). partials (B * tiles, D, K + 1).
template <typename T>
__global__ void __launch_bounds__(kBlhChannels* kBlhRows)
    depthwise_bwd_blh_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                             const float* __restrict__ w, T* __restrict__ du,
                             float* __restrict__ partials, int channels, int length, int k,
                             int pad_left, int out_len) {
  extern __shared__ float smem[];
  __shared__ float red[kBlhRows][kBlhChannels];
  const int c = threadIdx.x;
  const int d = blockIdx.x * kBlhChannels + c;
  const int tile = blockIdx.y;
  const int b = blockIdx.z;
  const int l0 = tile * kBlhTile;
  const bool live = d < channels;
  x += (size_t)b * length * channels;
  dout += (size_t)b * out_len * channels;
  du += (size_t)b * length * channels;
  const int lo = dout_lo(k, pad_left);
  const int d_span = dout_span(kBlhTile, k, pad_left);
  const int x_span = kBlhTile + k - 1;
  float* td = smem;
  float* tx = smem + (size_t)d_span * kBlhChannels;
  for (int i = threadIdx.y; i < d_span; i += blockDim.y) {
    const int src = l0 + lo + i;
    td[i * kBlhChannels + c] =
        (live && src >= 0 && src < out_len) ? to_f(dout[(size_t)src * channels + d]) : 0.f;
  }
  for (int i = threadIdx.y; i < x_span; i += blockDim.y) {
    const int src = l0 - pad_left + i;
    tx[i * kBlhChannels + c] =
        (live && src >= 0 && src < length) ? to_f(x[(size_t)src * channels + d]) : 0.f;
  }
  __syncthreads();
  if (live) {
    for (int j = threadIdx.y; j < kBlhTile && l0 + j < length; j += blockDim.y) {
      float acc = 0.f;
      for (int t = 0; t < k; ++t)
        acc += w[(size_t)t * channels + d] * td[(j - t + pad_left - lo) * kBlhChannels + c];
      du[(size_t)(l0 + j) * channels + d] = from_f<T>(acc);
    }
  }
  float* out = partials + (((size_t)b * gridDim.y + tile) * channels + d) * (k + 1);
  for (int t = 0; t <= k; ++t) {
    float v = 0.f;
    for (int j = threadIdx.y; j < kBlhTile && l0 + j < out_len; j += blockDim.y) {
      const float dj = td[(j - lo) * kBlhChannels + c];
      v += t < k ? tx[(j + t) * kBlhChannels + c] * dj : dj;
    }
    red[threadIdx.y][c] = v;
    __syncthreads();
    if (threadIdx.y == 0 && live) {
      float s = 0.f;
      for (int i = 0; i < kBlhRows; ++i) s += red[i][c];
      out[t] = s;
    }
    __syncthreads();
  }
}

// One thread per (d, t): dk and dbias from the partials, summed over
// (batch, tile) in order. dk is (D, K) for BHL and (K, D) for BLH.
__global__ void __launch_bounds__(kFinishThreads)
    depthwise_bwd_finish_kernel(const float* __restrict__ partials, float* __restrict__ dk,
                                float* __restrict__ dbias, int n_parts, int channels, int k,
                                bool is_bhl) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= channels * (k + 1)) return;
  const int d = idx / (k + 1);
  const int t = idx - d * (k + 1);
  float s = 0.f;
  for (int r = 0; r < n_parts; ++r) s += partials[((size_t)r * channels + d) * (k + 1) + t];
  if (t == k) {
    if (dbias != nullptr) dbias[d] = s;
  } else {
    dk[is_bhl ? (size_t)d * k + t : (size_t)t * channels + d] = s;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dout, const float* w, void* du, float* partials,
                   float* dk, float* dbias, int batch, int channels, int length, int k,
                   int pad_left, int out_len, int tiles, bool is_bhl, cudaStream_t stream) {
  cudaError_t err;
  if (is_bhl) {
    const dim3 grid((unsigned)(batch * channels), tiles);
    const size_t smem =
        (size_t)(dout_span(kBhlTile, k, pad_left) + kBhlTile + k - 1) * sizeof(float);
    auto kernel = depthwise_bwd_bhl_kernel<T>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kBhlThreads, smem, stream>>>((const T*)x, (const T*)dout, w, (T*)du,
                                                partials, channels, length, k, pad_left,
                                                out_len);
  } else {
    const dim3 grid((channels + kBlhChannels - 1) / kBlhChannels, tiles, batch);
    const size_t smem = (size_t)(dout_span(kBlhTile, k, pad_left) + kBlhTile + k - 1) *
                        kBlhChannels * sizeof(float);
    auto kernel = depthwise_bwd_blh_kernel<T>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, dim3(kBlhChannels, kBlhRows), smem, stream>>>(
        (const T*)x, (const T*)dout, w, (T*)du, partials, channels, length, k, pad_left,
        out_len);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = channels * (k + 1);
  depthwise_bwd_finish_kernel<<<(n + kFinishThreads - 1) / kFinishThreads, kFinishThreads, 0,
                                stream>>>(partials, dk, dbias, batch * tiles, channels, k,
                                          is_bhl);
  return cudaGetLastError();
}

}  // namespace ffc

// The number of L tiles of a launch: partials must hold batch * tiles *
// channels * (k + 1) floats.
extern "C" int ffc_depthwise_bwd_tiles(int length, int out_len, int is_bhl) {
  const int span = length > out_len ? length : out_len;
  const int tile = is_bhl ? ffc::kBhlTile : ffc::kBlhTile;
  return (span + tile - 1) / tile;
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, dout and du). w, dk,
// dbias and partials are float32; dbias may be null.
extern "C" int ffc_depthwise_bwd(const void* x, const void* dout, const void* w, void* du,
                                 void* partials, void* dk, void* dbias, int batch, int channels,
                                 int length, int k, int pad_left, int out_len, int is_bhl,
                                 int dtype, void* stream) {
  const int tiles = ffc_depthwise_bwd_tiles(length, out_len, is_bhl);
  if (batch < 1 || channels < 1 || length < 1 || k < 1 || pad_left < 0 || out_len < 1 ||
      tiles > 65535 || (!is_bhl && batch > 65535) || (long long)batch * channels > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float* wf = (const float*)w;
  float* pf = (float*)partials;
  float* kf = (float*)dk;
  float* bf = (float*)dbias;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return (int)ffc::launch<float>(x, dout, wf, du, pf, kf, bf, batch, channels, length, k,
                                     pad_left, out_len, tiles, is_bhl != 0, st);
    case 1:
      return (int)ffc::launch<__nv_bfloat16>(x, dout, wf, du, pf, kf, bf, batch, channels,
                                             length, k, pad_left, out_len, tiles, is_bhl != 0,
                                             st);
    case 2:
      return (int)ffc::launch<__half>(x, dout, wf, du, pf, kf, bf, batch, channels, length, k,
                                      pad_left, out_len, tiles, is_bhl != 0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

FFC_EXPORT_ERROR_STRING()
