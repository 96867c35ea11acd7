// depthwise_common.cuh: the lane layout that depthwise.cu and
// depthwise_bwd.cu share.
//
// A lane owns 8 consecutive positions of a row: one 16-byte load of a bf16
// or f16 vector (two of an f32 one) and one 16-byte store. A warp walks a
// run of such vectors, 32 a step, and takes the K-1 halo values around a
// lane's 8 from the lanes beside it by shuffles: the values before lane 0's
// from lane 31 of the step before (`carry`), the values after lane 31's from
// lane 0 of the next step. A lane has the vectors of its next kAhead steps
// in flight while it computes the current one. Only the first and the last
// vector of a run come from memory twice. The window of a lane is win[i],
// i in [0, 8 + 2 kHalo): the element i - kHalo places after the lane's
// first, so that a tap at offset s of output o reads win[kHalo + o + s] for
// |s| <= kHalo.

#pragma once

#include "fft_common.cuh"

namespace dwk {

constexpr int kLane = 8;  // positions a lane
constexpr int kWarps = 8;  // warps a block, each on its own run
constexpr int kBlock = 32 * kWarps;  // threads a block (ffc::kThreads is the FFT kernels')
constexpr int kSteps = 8;  // warp steps a run
constexpr int kAhead = 2;  // steps whose vectors a lane has in flight
constexpr int kRunVecs = 32 * kSteps;  // lane vectors a run (2048 positions)
constexpr unsigned kFull = 0xffffffffu;

// The lane bodies' window half-width: they take K <= kHalo + 1, the K = 3
// of every model (other K run the one-element-a-thread bodies).
constexpr int kHalo = 2;

// 8 consecutive elements as loaded (Raw: 16 bytes of bf16 or f16, 32 of
// f32) and as 8 floats; p on a 16-byte boundary. A run keeps the vectors of
// its next steps raw, which holds a bf16 vector in 4 registers.
template <typename T>
struct Lane8;

template <>
struct Lane8<float> {
  struct Raw {
    float4 a, b;
  };
  static __device__ __forceinline__ Raw load(const float* p) {
    return {__ldg(reinterpret_cast<const float4*>(p)),
            __ldg(reinterpret_cast<const float4*>(p) + 1)};
  }
  static __device__ __forceinline__ Raw none() {
    return {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  }
  static __device__ __forceinline__ float elem(const Raw& r, int i) {
    const float4& h = i < 4 ? r.a : r.b;
    const int q = i & 3;
    return q == 0 ? h.x : q == 1 ? h.y : q == 2 ? h.z : h.w;
  }
  static __device__ __forceinline__ Raw load_n(const float* p, int n) {
    float e[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = i < n ? p[i] : 0.f;
    return {make_float4(e[0], e[1], e[2], e[3]), make_float4(e[4], e[5], e[6], e[7])};
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// bf16 and f16: 8 values in the four 32-bit words of a uint4, element 2i in
// the low half of word i.
template <typename T>
struct Lane8Half {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const T* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Raw none() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ Raw load_n(const T* p, int n) {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (2 * i < n ? h[2 * i] : 0u) | (2 * i + 1 < n ? (unsigned)h[2 * i + 1] << 16 : 0u);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ unsigned word(const Raw& r, int i) {
    return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
  }
};

template <>
struct Lane8<__nv_bfloat16> : Lane8Half<__nv_bfloat16> {
  static __device__ __forceinline__ float elem(const Raw& r, int i) {
    const unsigned w = word(r, i >> 1);  // a bf16 is the high half of an f32
    return __uint_as_float(i & 1 ? w & 0xffff0000u : w << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Lane8<__half> : Lane8Half<__half> {
  static __device__ __forceinline__ float elem(const Raw& r, int i) {
    const unsigned w = word(r, i >> 1);
    return __half2float(__ushort_as_half((unsigned short)(i & 1 ? w >> 16 : w & 0xffffu)));
  }
  static __device__ __forceinline__ void store(__half* p, const float (&v)[8]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __half2 h = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T>
__device__ __forceinline__ void unpack(const typename Lane8<T>::Raw& r, float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < kLane; ++i) v[i] = Lane8<T>::elem(r, i);
}

// The first n < 8 of a vector's values, at p.
template <typename T>
__device__ __forceinline__ void store_n(T* p, const float (&v)[8], int n) {
#pragma unroll
  for (int i = 0; i < kLane; ++i)
    if (i < n) p[i] = ffc::from_f<T>(v[i]);
}

template <int N>
__device__ __forceinline__ void zero(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = 0.f;
}

// The lane's window from its vector `cur`, the lane below's (lane 0:
// `carry`) and the lane above's (lane 31: lane 0's next vector, raw); then
// `carry` becomes lane 31's last kHalo values, for the next step.
template <typename T>
__device__ __forceinline__ void window(const float (&cur)[8], const typename Lane8<T>::Raw& nxt,
                                       float (&carry)[kHalo], int lane,
                                       float (&win)[8 + 2 * kHalo]) {
  static_assert(kHalo <= kLane, "a halo comes from the next lane only");
#pragma unroll
  for (int i = 0; i < kHalo; ++i) {
    const float below = __shfl_up_sync(kFull, cur[kLane - kHalo + i], 1);
    const float above = __shfl_down_sync(kFull, cur[i], 1);
    const float next = __shfl_sync(kFull, Lane8<T>::elem(nxt, i), 0);
    win[i] = lane == 0 ? carry[i] : below;
    win[kHalo + kLane + i] = lane == 31 ? next : above;
    carry[i] = __shfl_sync(kFull, cur[kLane - kHalo + i], 31);
  }
#pragma unroll
  for (int i = 0; i < kLane; ++i) win[kHalo + i] = cur[i];
}

// Any layout, padding and K, one output a thread, in memory order:
//   out[l] = bias + sum_t w[t] in[l + dir (t - pad_left)],  0 <= l < out_len,
// with in zero outside [0, in_len) and bias null for none. dir = 1 is the
// forward conv; dir = -1 with in = dout, in_len = the forward's output
// length and out_len = L is its du. w is (D, K) for BHL, (K, D) for BLH.
template <typename T>
__global__ void __launch_bounds__(kBlock)
    depthwise_any_kernel(const T* __restrict__ in, const float* __restrict__ w,
                         const float* __restrict__ bias, T* __restrict__ out, long long n_out,
                         int channels, int in_len, int k, int pad_left, int out_len, int dir,
                         bool is_bhl) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_out;
       i += (long long)gridDim.x * blockDim.x) {
    const T* row;
    const float* wd;
    int d, l;
    size_t step;  // between in's positions, and w's taps
    if (is_bhl) {
      const long long r = i / out_len;
      l = (int)(i - r * out_len);
      d = (int)(r % channels);
      row = in + (size_t)r * in_len;
      wd = w + (size_t)d * k;
      step = 1;
    } else {
      const long long bl = i / channels;
      d = (int)(i - bl * channels);
      const long long b = bl / out_len;
      l = (int)(bl - b * out_len);
      row = in + (size_t)b * in_len * channels + d;
      wd = w + d;
      step = channels;
    }
    float a = bias != nullptr ? bias[d] : 0.f;
    for (int t = 0; t < k; ++t) {
      const int src = l + dir * (t - pad_left);
      if (src >= 0 && src < in_len) a = fmaf(wd[t * step], ffc::to_f(row[src * step]), a);
    }
    out[i] = ffc::from_f<T>(a);
  }
}

template <typename T>
cudaError_t launch_any(const void* in, const float* w, const float* bias, void* out, int batch,
                       int channels, int in_len, int k, int pad_left, int out_len, int dir,
                       bool is_bhl, cudaStream_t stream) {
  const long long n_out = (long long)batch * channels * out_len;
  const long long blocks = (n_out + kBlock - 1) / kBlock;
  depthwise_any_kernel<T><<<(unsigned)(blocks < (1 << 20) ? blocks : (1 << 20)), kBlock, 0,
                            stream>>>((const T*)in, w, bias, (T*)out, n_out, channels, in_len,
                                      k, pad_left, out_len, dir, is_bhl);
  return cudaGetLastError();
}

}  // namespace dwk
