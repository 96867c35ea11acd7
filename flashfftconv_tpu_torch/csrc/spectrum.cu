// spectrum: half spectrum of the long-conv kernel taps.
//
// Replaces the TPU kernel _spectrum_tiles (flashfftconv_tpu/ops/
// monarch_pallas.py, def at l.558, pallas_call at l.602), which takes real
// taps (H, N1, N2) to a planar Monarch-layout spectrum of all N frequencies.
// Here: real f32 taps (H, k_len <= N), zero-padded to N inside the kernel,
// to the natural-order half spectrum (H, M+1) of complex f32 (interleaved
// re/im, torch.complex64), M = N/2 -- everything a real conv needs.
//
// Bound on the H100: bytes. The kernel reads the taps once and writes M+1
// complex values a row; the FFT in between (about 5 M log2 M f32 operations
// a row) is far below the f32 rate. At H=768, k_len=8192, N=16384 it reads
// 25 MB and writes 50 MB.
//
// Design. One instantiation per FFT size (spectrum_kernel<LOG_M>; the C
// entry dispatches on N) of the in-register row FFT of row_fft.cuh (ptxas
// reports no stack frame and no spills for any instantiation): T = M/P
// threads a row, P points each, up to M = 1024 several rows a 128-thread
// block (M2-BERT's N=256 is 8 rows a block), XOR-swizzled shared memory and
// a table of coarse and fine roots. Here:
//   - stage 0 (two lines of P/2 points a thread, stride 2T) loads straight
//     from device memory into registers, one 16-byte load of 4 taps (2
//     packed points) a step where the row start is 16-byte aligned, scalar
//     loads at a ragged end or an unaligned row; a tap past k_len is a zero
//     that is never loaded, so with k_len <= N/2 (Hyena, H3) half of the row
//     costs no traffic;
//   - one or two shared-memory passes join the register passes (three
//     stages at N=16384, factors 16, 32, 16);
//   - the last stage writes its outputs in natural frequency order, and the
//     split X[f] = A + B (fft_common.cuh split_pair) reads Z[f] and Z[M-f]
//     from there and stores X[f], X[f+1] in order as one 16-byte store.

#include "row_fft.cuh"

namespace ffc {
namespace spec {

using namespace row;

template <int LOG_M>
__global__ void __launch_bounds__(Cfg<LOG_M>::kThreads, Cfg<LOG_M>::kMinBlocks)
    spectrum_kernel(const float* __restrict__ k, float2* __restrict__ out,
                    const float2* __restrict__ split_tw, int channels, int k_len) {
  using C = Cfg<LOG_M>;
  constexpr int kM = C::kM, kT = C::kT, kP = C::kP;
  constexpr int kF0 = C::kF0;
  extern __shared__ float4 smem_raw[];
  float2* smem = reinterpret_cast<float2*>(smem_raw);
  const int tr = threadIdx.x % kT;
  const int row = blockIdx.x * C::kRows + threadIdx.x / kT;
  const bool active = row < channels;
  float2* s = smem + (threadIdx.x / kT) * kM;
  float2* tab = smem + C::kRows * kM;

  // Stage 0's lines r = 2 tr + e, e < 2: v[e * F0 + u] = z[u * R0 + r],
  // the packed points of taps 4 (u T + tr) .. + 3.
  float2 v[kP];
  {
    const float* kr = k + (size_t)(active ? row : 0) * k_len;
    const bool aligned = (reinterpret_cast<uintptr_t>(kr) & 15) == 0;
#pragma unroll
    for (int u = 0; u < kF0; ++u) {
      const int i = 4 * (u * kT + tr);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (active && i < k_len) {
        if (aligned && i + 4 <= k_len) {
          x = __ldg(reinterpret_cast<const float4*>(kr + i));
        } else {
          x.x = kr[i];
          if (i + 1 < k_len) x.y = kr[i + 1];
          if (i + 2 < k_len) x.z = kr[i + 2];
          if (i + 3 < k_len) x.w = kr[i + 3];
        }
      }
      v[u] = make_float2(x.x, x.y);
      v[kF0 + u] = make_float2(x.z, x.w);
    }
  }
  load_table<C>(tab, split_tw);
  __syncthreads();

#pragma unroll
  for (int e = 0; e < 2; ++e) first_stage_line<C>(v + e * kF0, s, tab, 2 * tr + e);

  mid_stages<C>(v, s, tab, tr);

  last_stage<C>(v, s, tr);
  __syncthreads();
  if (!active) return;

  // Split: X[f] from Z[f] and Z[M - f] (Z[M] = Z[0]); pairs X[f], X[f+1]
  // with f + the row's offset even, so each pair is one aligned 16-byte
  // store; the one odd element (X[M] or X[0]) alone.
  float2* o = out + (size_t)row * (kM + 1);
  const int a = (reinterpret_cast<uintptr_t>(o) >> 3) & 1;
#pragma unroll
  for (int i = 0; i < kP / 2; ++i) {
    const int f = a + 2 * (tr + kT * i);
    float2 x[2], unused;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int g = f + c;
      split_pair(s[swz(g & (kM - 1))], s[swz((kM - g) & (kM - 1))], root<C>(tab, g), x[c],
                 unused);
    }
    *reinterpret_cast<float4*>(o + f) = make_float4(x[0].x, x[0].y, x[1].x, x[1].y);
  }
  if (tr == 0) {
    const int g = a ? 0 : kM;
    float2 x, unused;
    split_pair(s[0], s[0], root<C>(tab, g), x, unused);
    o[g] = x;
  }
}

template <int LOG_M>
cudaError_t launch(const float* k, float2* out, const float2* split_tw, int channels, int k_len,
                   cudaStream_t stream) {
  using C = Cfg<LOG_M>;
  if constexpr (C::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spectrum_kernel<LOG_M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (channels + C::kRows - 1) / C::kRows;
  spectrum_kernel<LOG_M><<<blocks, C::kThreads, C::kSmem, stream>>>(k, out, split_tw, channels,
                                                                     k_len);
  return cudaGetLastError();
}

}  // namespace spec
}  // namespace ffc

extern "C" int ffc_spectrum(const void* k, void* out, const void* split_tw, int channels,
                            int k_len, int n, void* stream) {
  if (channels < 1 || k_len < 1 || k_len > n) return (int)cudaErrorInvalidValue;
  const float* kp = (const float*)k;
  float2* op = (float2*)out;
  const float2* tw = (const float2*)split_tw;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 16: return (int)ffc::spec::launch<3>(kp, op, tw, channels, k_len, st);
    case 32: return (int)ffc::spec::launch<4>(kp, op, tw, channels, k_len, st);
    case 64: return (int)ffc::spec::launch<5>(kp, op, tw, channels, k_len, st);
    case 128: return (int)ffc::spec::launch<6>(kp, op, tw, channels, k_len, st);
    case 256: return (int)ffc::spec::launch<7>(kp, op, tw, channels, k_len, st);
    case 512: return (int)ffc::spec::launch<8>(kp, op, tw, channels, k_len, st);
    case 1024: return (int)ffc::spec::launch<9>(kp, op, tw, channels, k_len, st);
    case 2048: return (int)ffc::spec::launch<10>(kp, op, tw, channels, k_len, st);
    case 4096: return (int)ffc::spec::launch<11>(kp, op, tw, channels, k_len, st);
    case 8192: return (int)ffc::spec::launch<12>(kp, op, tw, channels, k_len, st);
    case 16384: return (int)ffc::spec::launch<13>(kp, op, tw, channels, k_len, st);
    case 32768: return (int)ffc::spec::launch<14>(kp, op, tw, channels, k_len, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

FFC_EXPORT_ERROR_STRING()
