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
// from a side array that XLA gathered (_build_halos) and held a channel
// strip in VMEM. Here nothing is staged: the same-length BHL conv (every
// main path's: causal (K-1, 0) and "same" padding) walks the tensor as one
// flat run of lane vectors (depthwise_common.cuh), 8 outputs a lane from
// one 16-byte load and one 16-byte store, the K-1 halo values from the lanes
// beside it, the taps and bias in registers. A vector inside one row zeroes
// the window entries beyond the row's ends; a vector that crosses a row end
// (L not a multiple of 8: the serving steps' lengths) takes each element's
// row and taps apart. Each warp walks 2048 positions, with the vectors of
// its next two steps in flight while it computes one, so short rows (L=128:
// 16 lanes a row) waste no lane and long rows need no tile grid.
//
// Every other call (BLH, out_len != L, K > 3, an input or output off a
// 16-byte boundary) runs depthwise_common.cuh's depthwise_any_kernel: one
// output a thread, in memory order, the K taps read through L1.

#include "depthwise_common.cuh"

namespace ffc {

using namespace dwk;

// Same-length BHL conv over the flat (B * D * L) tensor; K <= kHalo + 1.
template <typename T>
__global__ void __launch_bounds__(kBlock)
    depthwise_flat_kernel(const T* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ bias, T* __restrict__ out,
                          long long total, int channels, int length, int k, int pad_left) {
  using Raw = typename Lane8<T>::Raw;
  const int lane = threadIdx.x & 31;
  const long long nvec = (total + kLane - 1) / kLane;
  const long long vs = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRunVecs;
  if (vs >= nvec) return;
  const long long ve = vs + kRunVecs < nvec ? vs + kRunVecs : nvec;
  const int steps = (int)((ve - vs + 31) / 32);
  // The raw vector of step s: vector vs + 32 s + lane of the run, and at
  // s = steps lane 0's the one after the run (lane 31's right halo).
  auto fetch = [&](int s) {
    const long long v = vs + 32LL * s + lane;
    if (v >= nvec || s > steps || (s == steps && lane != 0)) return Lane8<T>::none();
    const long long p = v * kLane;
    return p + kLane <= total ? Lane8<T>::load(x + p)
                              : Lane8<T>::load_n(x + p, (int)(total - p));
  };
  float cur[kLane], carry[kHalo];
  unpack<T>(fetch(0), cur);
  Raw ahead[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) ahead[i] = fetch(1 + i);
  {
    const Raw prev =
        lane == 0 && vs > 0 ? Lane8<T>::load(x + (vs - 1) * kLane) : Lane8<T>::none();
#pragma unroll
    for (int i = 0; i < kHalo; ++i)
      carry[i] = __shfl_sync(kFull, Lane8<T>::elem(prev, kLane - kHalo + i), 0);
  }
  // The lane's vector v, the position l0 of its first element in its row
  // and that row's channel d.
  long long v = vs + lane;
  const long long row0 = v * kLane / length;
  int l0 = (int)(v * kLane - row0 * length);
  int d = (int)(row0 % channels);
  int tap_d = -1;  // the channel whose taps c and bias bd hold
  float c[2 * kHalo + 1], bd = 0.f;
  for (int step = 0; step < steps; ++step) {
    float win[kLane + 2 * kHalo];
    window<T>(cur, ahead[0], carry, lane, win);
    if (v < ve) {
      float y[kLane];
      if (l0 + kLane <= length) {
        if (d != tap_d) {
          tap_d = d;
#pragma unroll
          for (int s = -kHalo; s <= kHalo; ++s) {
            const int t = s + pad_left;
            c[s + kHalo] = t >= 0 && t < k ? w[(size_t)d * k + t] : 0.f;
          }
          bd = bias != nullptr ? bias[d] : 0.f;
        }
        // halo entries beyond the row's ends (rows need not start on a vector)
#pragma unroll
        for (int i = 0; i < kHalo; ++i) {
          if (l0 - kHalo + i < 0) win[i] = 0.f;
          if (l0 + kLane + i >= length) win[kHalo + kLane + i] = 0.f;
        }
#pragma unroll
        for (int o = 0; o < kLane; ++o) {
          float a = bd;
#pragma unroll
          for (int s = -kHalo; s <= kHalo; ++s) a = fmaf(c[s + kHalo], win[kHalo + o + s], a);
          y[o] = a;
        }
      } else {
        // The vector crosses a row end: each element in its own row, with
        // its own channel's taps; window entries outside that row skipped.
#pragma unroll
        for (int o = 0; o < kLane; ++o) {
          int lo = l0 + o, dd = d;
          if (lo >= length) {
            const int q = lo / length;
            lo -= q * length;
            dd = (d + q) % channels;
          }
          float a = bias != nullptr ? bias[dd] : 0.f;
#pragma unroll
          for (int s = -kHalo; s <= kHalo; ++s) {
            const int t = s + pad_left;
            if (t >= 0 && t < k && lo + s >= 0 && lo + s < length)
              a = fmaf(w[(size_t)dd * k + t], win[kHalo + o + s], a);
          }
          y[o] = a;
        }
      }
      const long long p = v * kLane;
      if (p + kLane <= total) {
        Lane8<T>::store(out + p, y);
      } else {
        store_n(out + p, y, (int)(total - p));
      }
    }
    v += 32;
    l0 += 32 * kLane;
    if (l0 >= length) {
      const int q = l0 / length;
      l0 -= q * length;
      d = (d + q) % channels;
    }
    unpack<T>(ahead[0], cur);
#pragma unroll
    for (int i = 0; i + 1 < kAhead; ++i) ahead[i] = ahead[i + 1];
    ahead[kAhead - 1] = fetch(step + 1 + kAhead);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* w, const float* bias, void* out, int batch,
                   int channels, int length, int k, int pad_left, int out_len, bool is_bhl,
                   cudaStream_t stream) {
  const bool aligned = (((uintptr_t)x | (uintptr_t)out) & 15) == 0;
  if (is_bhl && out_len == length && k <= kHalo + 1 && pad_left < k && aligned) {
    const long long total = (long long)batch * channels * length;
    const long long runs = ((total + kLane - 1) / kLane + kRunVecs - 1) / kRunVecs;
    depthwise_flat_kernel<T><<<(unsigned)((runs + kWarps - 1) / kWarps), kBlock, 0, stream>>>(
        (const T*)x, w, bias, (T*)out, total, channels, length, k, pad_left);
    return cudaGetLastError();
  }
  return launch_any<T>(x, w, bias, out, batch, channels, length, k, pad_left, out_len, 1, is_bhl,
                       stream);
}

}  // namespace ffc

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. bias may be null.
extern "C" int ffc_depthwise(const void* x, const void* w, const void* bias, void* out,
                             int batch, int channels, int length, int k, int pad_left,
                             int out_len, int is_bhl, int dtype, void* stream) {
  if (batch < 1 || channels < 1 || length < 1 || k < 1 || pad_left < 0 || out_len < 1)
    return (int)cudaErrorInvalidValue;
  const float* wf = (const float*)w;
  const float* bf = (const float*)bias;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return (int)ffc::launch<float>(x, wf, bf, out, batch, channels, length, k, pad_left,
                                     out_len, is_bhl != 0, st);
    case 1:
      return (int)ffc::launch<__nv_bfloat16>(x, wf, bf, out, batch, channels, length, k,
                                             pad_left, out_len, is_bhl != 0, st);
    case 2:
      return (int)ffc::launch<__half>(x, wf, bf, out, batch, channels, length, k, pad_left,
                                      out_len, is_bhl != 0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

FFC_EXPORT_ERROR_STRING()
