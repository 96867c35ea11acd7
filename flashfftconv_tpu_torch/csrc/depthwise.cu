// depthwise: short K-tap depthwise conv1d forward, BHL and BLH layouts.
//
// Replaces the TPU kernel _pallas_depthwise (flashfftconv_tpu/ops/
// depthwise.py, def at l.143, pallas_call at l.303):
//   out[b, d, l] = bias[d] + sum_t w[d, t] * x[b, d, l + t - pad_left]
// with zero padding outside [0, L), output length L + pad_left + pad_right
// - K + 1, multiply-adds in f32 and the output at x's dtype.
//
// Bound on the H100: bytes (2K f32 operations per output against 4 bytes
// moved in bf16). At B=4, D=2304, L=8192 in bf16 it reads 151 MB and writes
// 151 MB, about 90 us at 3.35 TB/s. The TPU kernel got its cross-tile halos
// from a side array that XLA gathered on the host side of the call
// (_build_halos); here every block stages its own tile plus the K-1 halo
// from device memory into shared memory as f32, so each input is read from
// device memory once (the halo a second time, from L2), and takes any D and
// L. BHL: a block is one (b, d) row by 1024 outputs, threads on consecutive
// l. BLH: a block is 32 channels by 64 outputs, threads on consecutive d.
// Weights and bias come in as f32.

#include "fft_common.cuh"

namespace ffc {

constexpr int kBhlThreads = 256;
constexpr int kBhlPerThread = 4;
constexpr int kBhlTile = kBhlThreads * kBhlPerThread;
constexpr int kBlhChannels = 32;
constexpr int kBlhRows = 8;
constexpr int kBlhTile = 64;

// x (rows, length), w (D, K), rows = B * D; grid (rows, L tiles).
template <typename T>
__global__ void __launch_bounds__(kBhlThreads)
    depthwise_bhl_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ bias, T* __restrict__ out, int channels,
                         int length, int k, int pad_left, int out_len) {
  extern __shared__ float tile[];
  const size_t row = blockIdx.x;
  const int d = (int)(row % channels);
  const int l0 = blockIdx.y * kBhlTile;
  x += row * length;
  out += row * out_len;
  const int span = kBhlTile + k - 1;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int src = l0 + i - pad_left;
    tile[i] = (src >= 0 && src < length) ? to_f(x[src]) : 0.f;
  }
  __syncthreads();
  const float* wd = w + (size_t)d * k;
  const float bd = bias != nullptr ? bias[d] : 0.f;
#pragma unroll
  for (int q = 0; q < kBhlPerThread; ++q) {
    const int j = q * kBhlThreads + threadIdx.x;
    if (l0 + j < out_len) {
      float acc = 0.f;
      for (int t = 0; t < k; ++t) acc += tile[j + t] * wd[t];
      out[l0 + j] = from_f<T>(acc + bd);
    }
  }
}

// x (B, length, D), w (K, D); grid (D tiles, L tiles, B).
template <typename T>
__global__ void __launch_bounds__(kBlhChannels* kBlhRows)
    depthwise_blh_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ bias, T* __restrict__ out, int channels,
                         int length, int k, int pad_left, int out_len) {
  extern __shared__ float tile[];
  const int c = threadIdx.x;
  const int d = blockIdx.x * kBlhChannels + c;
  const int l0 = blockIdx.y * kBlhTile;
  x += (size_t)blockIdx.z * length * channels;
  out += (size_t)blockIdx.z * out_len * channels;
  const int span = kBlhTile + k - 1;
  for (int i = threadIdx.y; i < span; i += blockDim.y) {
    const int src = l0 + i - pad_left;
    tile[i * kBlhChannels + c] = (d < channels && src >= 0 && src < length)
                                     ? to_f(x[(size_t)src * channels + d])
                                     : 0.f;
  }
  __syncthreads();
  if (d >= channels) return;
  const float bd = bias != nullptr ? bias[d] : 0.f;
  for (int j = threadIdx.y; j < kBlhTile && l0 + j < out_len; j += blockDim.y) {
    float acc = 0.f;
    for (int t = 0; t < k; ++t) acc += tile[(j + t) * kBlhChannels + c] * w[(size_t)t * channels + d];
    out[(size_t)(l0 + j) * channels + d] = from_f<T>(acc + bd);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* w, const float* bias, void* out, int batch,
                   int channels, int length, int k, int pad_left, int out_len, bool is_bhl,
                   cudaStream_t stream) {
  if (is_bhl) {
    const dim3 grid((unsigned)(batch * channels), (out_len + kBhlTile - 1) / kBhlTile);
    const size_t smem = (kBhlTile + k - 1) * sizeof(float);
    auto kernel = depthwise_bhl_kernel<T>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kBhlThreads, smem, stream>>>((const T*)x, w, bias, (T*)out, channels, length,
                                                k, pad_left, out_len);
  } else {
    const dim3 grid((channels + kBlhChannels - 1) / kBlhChannels,
                    (out_len + kBlhTile - 1) / kBlhTile, batch);
    const size_t smem = (size_t)(kBlhTile + k - 1) * kBlhChannels * sizeof(float);
    auto kernel = depthwise_blh_kernel<T>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, dim3(kBlhChannels, kBlhRows), smem, stream>>>(
        (const T*)x, w, bias, (T*)out, channels, length, k, pad_left, out_len);
  }
  return cudaGetLastError();
}

}  // namespace ffc

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. bias may be null.
extern "C" int ffc_depthwise(const void* x, const void* w, const void* bias, void* out,
                             int batch, int channels, int length, int k, int pad_left,
                             int out_len, int is_bhl, int dtype, void* stream) {
  const long long tiles = is_bhl ? (out_len + ffc::kBhlTile - 1) / ffc::kBhlTile
                                 : (out_len + ffc::kBlhTile - 1) / ffc::kBlhTile;
  if (batch < 1 || channels < 1 || length < 1 || k < 1 || out_len < 1 || tiles > 65535 ||
      (!is_bhl && batch > 65535) || (long long)batch * channels > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float* wf = (const float*)w;
  const float* bf = (const float*)bias;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = ffc::launch<float>(x, wf, bf, out, batch, channels, length, k, pad_left, out_len,
                               is_bhl != 0, st);
      break;
    case 1:
      err = ffc::launch<__nv_bfloat16>(x, wf, bf, out, batch, channels, length, k, pad_left,
                                       out_len, is_bhl != 0, st);
      break;
    case 2:
      err = ffc::launch<__half>(x, wf, bf, out, batch, channels, length, k, pad_left, out_len,
                                is_bhl != 0, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

FFC_EXPORT_ERROR_STRING()
