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
// any padding works.
//
// Bound on the H100: bytes. At B=4, D=2304, L=8192, K=3 in bf16 the kernel
// reads 151 MB each of x and dout and writes 151 MB of du (about 135 us at
// 3.35 TB/s) for 2K+2K+1 f32 operations a position.
//
// Design on the H100. The TPU kernel accumulates dk and dbias over its
// sequential (batch, L-tile) grid axes in one revisited output block. Here
// the work of a channel d, its B rows x L positions taken as one run of
// (b, l), is cut into tiles of 2048 positions, and one warp owns one (d,
// tile). The same-length BHL backward (every main path's) walks its tile in
// the lane layout of depthwise_common.cuh: a lane loads 8 positions of x
// and of dout (one 16-byte load each in bf16), takes the K-1 halo values of
// both from the lanes beside it, writes 8 of du with one 16-byte store, and
// keeps its 2 kHalo + 1 window sums of x * dout (the dk taps at every padding
// the window allows) and the dbias sum in registers across the tile. At the
// end the warp reduces them all at once by one xor-shuffle tree and lane 0
// writes the tile's K + 1 partials: no shared memory, no barrier, no
// atomics. depthwise_bwd_finish sums each (d, t) over the tiles with a warp,
// lanes over tiles in a fixed order and a fixed shuffle tree, so dk and
// dbias are the same bits from call to call.
//
// Every other call (BLH, out_len != L, L not a multiple of 8, K > 3, an
// operand off a 16-byte boundary) runs depthwise_common.cuh's
// depthwise_any_kernel for du (the forward's one-output-a-thread body on
// dout with the taps reversed) and depthwise_bwd_dk_any_kernel (a warp a
// (d, tile), one tap at a time, lanes over positions), which writes the
// same partials.

#include "depthwise_common.cuh"

namespace ffc {

using namespace dwk;

constexpr int kTile = kRunVecs * kLane;  // positions of a channel a warp owns
constexpr int kFinishThreads = 256;

template <int N>
__device__ __forceinline__ void warp_sum(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(kFull, v[i], o);
  }
}

// Same-length BHL backward, L a multiple of 8; K <= kHalo + 1. Warp (d, tile)
// for d = unit / tiles. partials (D, tiles, K + 1).
template <typename T>
__global__ void __launch_bounds__(kBlock)
    depthwise_bwd_line_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                              const float* __restrict__ w, T* __restrict__ du,
                              float* __restrict__ partials, int batch, int channels,
                              int length, int k, int pad_left, int tiles) {
  using Raw = typename Lane8<T>::Raw;
  const int lane = threadIdx.x & 31;
  const long long unit = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (unit >= (long long)channels * tiles) return;
  const int d = (int)(unit / tiles);
  const int nvr = length / kLane;  // lane vectors a row
  const long long nv = (long long)batch * nvr;
  const long long vs = (unit - (long long)d * tiles) * kRunVecs;
  const long long ve = vs + kRunVecs < nv ? vs + kRunVecs : nv;
  const int steps = (int)((ve - vs + 31) / 32);
  // Element offset of vector j of batch row b of channel d.
  auto at = [&](int b, int j) {
    return ((size_t)b * channels + d) * length + (size_t)j * kLane;
  };
  // (b, j) of the lane's vector at the current step (b, j) and at the next
  // step to be fetched (fb, fj); fetch(s) reads step s = 0, 1, ... in turn:
  // vector vs + 32 s + lane, and at s = steps lane 0's the one after the
  // tile (lane 31's right halo).
  int b = (int)((vs + lane) / nvr), j = (int)(vs + lane - (long long)b * nvr);
  int fb = b, fj = j;
  auto fetch = [&](int s, Raw& rx, Raw& rd) {
    const long long v = vs + 32LL * s + lane;
    if (v < nv && (s < steps || (s == steps && lane == 0))) {
      rx = Lane8<T>::load(x + at(fb, fj));
      rd = Lane8<T>::load(dout + at(fb, fj));
    } else {
      rx = Lane8<T>::none(), rd = Lane8<T>::none();
    }
    fj += 32;
    if (fj >= nvr) {
      const int q = fj / nvr;
      fj -= q * nvr;
      fb += q;
    }
  };
  float cx[kLane], cd[kLane], carry_x[kHalo], carry_d[kHalo];
  Raw ax[kAhead], ad[kAhead];
  {
    Raw rx, rd;
    fetch(0, rx, rd);
    unpack<T>(rx, cx), unpack<T>(rd, cd);
  }
#pragma unroll
  for (int i = 0; i < kAhead; ++i) fetch(1 + i, ax[i], ad[i]);
  {
    Raw px = Lane8<T>::none(), pd = Lane8<T>::none();
    if (lane == 0 && vs > 0) {
      const int pb = (int)((vs - 1) / nvr), pj = (int)(vs - 1 - (long long)pb * nvr);
      px = Lane8<T>::load(x + at(pb, pj));
      pd = Lane8<T>::load(dout + at(pb, pj));
    }
#pragma unroll
    for (int i = 0; i < kHalo; ++i) {
      carry_x[i] = __shfl_sync(kFull, Lane8<T>::elem(px, kLane - kHalo + i), 0);
      carry_d[i] = __shfl_sync(kFull, Lane8<T>::elem(pd, kLane - kHalo + i), 0);
    }
  }
  // du's taps by offset: du[i] = sum_s cu[s] dout[i + s], s = pad_left - t.
  float cu[2 * kHalo + 1];
#pragma unroll
  for (int s = -kHalo; s <= kHalo; ++s) {
    const int t = pad_left - s;
    cu[s + kHalo] = t >= 0 && t < k ? w[(size_t)d * k + t] : 0.f;
  }
  // acc[s + kHalo] = sum x[l + s] dout[l]: dk[t] is acc at s = t - pad_left;
  // acc[2 kHalo + 1] is dbias.
  float acc[2 * kHalo + 2];
  zero(acc);
  for (int step = 0; step < steps; ++step) {
    float xw[kLane + 2 * kHalo], dw[kLane + 2 * kHalo];
    window<T>(cx, ax[0], carry_x, lane, xw);
    window<T>(cd, ad[0], carry_d, lane, dw);
    // halos from the rows before and after (rows start on a vector)
#pragma unroll
    for (int i = 0; i < kHalo; ++i) {
      if (j == 0) xw[i] = 0.f, dw[i] = 0.f;
      if (j == nvr - 1) xw[kHalo + kLane + i] = 0.f, dw[kHalo + kLane + i] = 0.f;
    }
    if (vs + 32LL * step + lane < ve) {
      float g[kLane];
#pragma unroll
      for (int o = 0; o < kLane; ++o) {
        float a = 0.f;
#pragma unroll
        for (int s = -kHalo; s <= kHalo; ++s) a = fmaf(cu[s + kHalo], dw[kHalo + o + s], a);
        g[o] = a;
      }
      Lane8<T>::store(du + at(b, j), g);
#pragma unroll
      for (int s = -kHalo; s <= kHalo; ++s) {
#pragma unroll
        for (int o = 0; o < kLane; ++o)
          acc[s + kHalo] = fmaf(xw[kHalo + o + s], dw[kHalo + o], acc[s + kHalo]);
      }
#pragma unroll
      for (int o = 0; o < kLane; ++o) acc[2 * kHalo + 1] += dw[kHalo + o];
    }
    j += 32;
    if (j >= nvr) {
      const int q = j / nvr;
      j -= q * nvr;
      b += q;
    }
    unpack<T>(ax[0], cx), unpack<T>(ad[0], cd);
#pragma unroll
    for (int i = 0; i + 1 < kAhead; ++i) ax[i] = ax[i + 1], ad[i] = ad[i + 1];
    fetch(step + 1 + kAhead, ax[kAhead - 1], ad[kAhead - 1]);
  }
  warp_sum(acc);
  if (lane != 0) return;
  float* part = partials + (size_t)unit * (k + 1);
#pragma unroll
  for (int s = -kHalo; s <= kHalo; ++s) {
    const int t = s + pad_left;
    if (t >= 0 && t < k) part[t] = acc[s + kHalo];
  }
  part[k] = acc[2 * kHalo + 1];
}

// Any layout, padding and K: the partials of warp (d, tile), one tap at a
// time (t = K: dbias), lanes over the tile's (b, l), l < out_len.
template <typename T>
__global__ void __launch_bounds__(kBlock)
    depthwise_bwd_dk_any_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                                float* __restrict__ partials, int batch, int channels,
                                int length, int k, int pad_left, int out_len, int tiles,
                                bool is_bhl) {
  const int lane = threadIdx.x & 31;
  const long long unit = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (unit >= (long long)channels * tiles) return;
  const int d = (int)(unit / tiles);
  const long long n = (long long)batch * out_len;
  const long long q0 = (unit - (long long)d * tiles) * kTile;
  const long long q1 = q0 + kTile < n ? q0 + kTile : n;
  for (int t = 0; t <= k; ++t) {
    float s[1] = {0.f};
    for (long long q = q0 + lane; q < q1; q += 32) {
      const int b = (int)(q / out_len), l = (int)(q - (long long)b * out_len);
      const float g = is_bhl ? to_f(dout[((size_t)b * channels + d) * out_len + l])
                             : to_f(dout[((size_t)b * out_len + l) * channels + d]);
      if (t == k) {
        s[0] += g;
      } else {
        const int src = l + t - pad_left;
        if (src >= 0 && src < length) {
          const float xv = is_bhl ? to_f(x[((size_t)b * channels + d) * length + src])
                                  : to_f(x[((size_t)b * length + src) * channels + d]);
          s[0] = fmaf(xv, g, s[0]);
        }
      }
    }
    warp_sum(s);
    if (lane == 0) partials[(size_t)unit * (k + 1) + t] = s[0];
  }
}

// A warp per (d, t): dk and dbias from the partials (D, tiles, K + 1), lanes
// over tiles in order, then one shuffle tree. dk is (D, K) for BHL and
// (K, D) for BLH.
__global__ void __launch_bounds__(kFinishThreads)
    depthwise_bwd_finish_kernel(const float* __restrict__ partials, float* __restrict__ dk,
                                float* __restrict__ dbias, int tiles, int channels, int k,
                                bool is_bhl) {
  const int lane = threadIdx.x & 31;
  const long long wid = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (wid >= (long long)channels * (k + 1)) return;
  const int d = (int)(wid / (k + 1)), t = (int)(wid - (long long)d * (k + 1));
  float s[1] = {0.f};
  for (int c = lane; c < tiles; c += 32) s[0] += partials[((size_t)d * tiles + c) * (k + 1) + t];
  warp_sum(s);
  if (lane != 0) return;
  if (t == k) {
    if (dbias != nullptr) dbias[d] = s[0];
  } else {
    dk[is_bhl ? (size_t)d * k + t : (size_t)t * channels + d] = s[0];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dout, const float* w, void* du, float* partials,
                   float* dk, float* dbias, int batch, int channels, int length, int k,
                   int pad_left, int out_len, int tiles, bool is_bhl, cudaStream_t stream) {
  cudaError_t err;
  const bool aligned = (((uintptr_t)x | (uintptr_t)dout | (uintptr_t)du) & 15) == 0;
  const long long units = (long long)channels * tiles;
  const unsigned unit_blocks = (unsigned)((units + kWarps - 1) / kWarps);
  if (is_bhl && out_len == length && length % kLane == 0 && k <= kHalo + 1 && pad_left < k &&
      aligned) {
    depthwise_bwd_line_kernel<T><<<unit_blocks, kBlock, 0, stream>>>(
        (const T*)x, (const T*)dout, w, (T*)du, partials, batch, channels, length, k, pad_left,
        tiles);
  } else {
    // du is the forward's one-output-a-thread conv of dout with the taps
    // reversed: in = dout (rows of out_len), out = du (rows of L).
    err = launch_any<T>(dout, w, nullptr, du, batch, channels, out_len, k, pad_left, length, -1,
                        is_bhl, stream);
    if (err != cudaSuccess) return err;
    depthwise_bwd_dk_any_kernel<T><<<unit_blocks, kBlock, 0, stream>>>(
        (const T*)x, (const T*)dout, partials, batch, channels, length, k, pad_left, out_len,
        tiles, is_bhl);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long warps = (long long)channels * (k + 1);
  const int per_block = kFinishThreads / 32;
  depthwise_bwd_finish_kernel<<<(unsigned)((warps + per_block - 1) / per_block), kFinishThreads,
                                0, stream>>>(partials, dk, dbias, tiles, channels, k, is_bhl);
  return cudaGetLastError();
}

}  // namespace ffc

// The tiles of 2048 positions that a channel's B x out_len positions are cut
// into: partials must hold channels * tiles * (k + 1) floats.
extern "C" int ffc_depthwise_bwd_tiles(int batch, int out_len) {
  return (int)(((long long)batch * out_len + ffc::kTile - 1) / ffc::kTile);
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, dout and du). w, dk,
// dbias and partials are float32; dbias may be null.
extern "C" int ffc_depthwise_bwd(const void* x, const void* dout, const void* w, void* du,
                                 void* partials, void* dk, void* dbias, int batch, int channels,
                                 int length, int k, int pad_left, int out_len, int is_bhl,
                                 int dtype, void* stream) {
  if (batch < 1 || channels < 1 || length < 1 || k < 1 || pad_left < 0 || out_len < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles = ffc_depthwise_bwd_tiles(batch, out_len);
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
