// Device code shared by the long-FFT kernels (butterfly.cu,
// long_spectrum.cu), for FFT sizes N from 65536 up, and the in-register line
// transforms (line_fft, line_fft_const) that row_fft.cuh (spectrum.cu,
// monarch_conv.cu, and through long_band.cuh long_conv.cu and
// long_conv_bwd.cu) uses too.
//
// The packed M = N/2 point complex signal is viewed as (F, R): the butterfly
// kernels take the F-point DFT down the columns and multiply by the outer
// twiddle exp(-2 pi i k0 r / M), which leaves F bands of R points in device
// memory, band k0 in row k0. The R-point DFT of band k0 (in shared memory,
// fft_common.cuh) holds the frequencies k = k0 + F*k1.
//
// The split step of the real FFT pairs frequency k with M - k, and
//   M - (k0 + F*k1) = (F - k0) + F*(R - 1 - k1)     for 0 < k0 < F,
//   M - F*k1        = F*((R - k1) mod R) (+ M at k1 = 0) for k0 = 0,
// so the partner of band k0 is band F - k0. One block of long_spectrum's
// band kernel therefore owns the band pair {kp, F - kp}, kp = 0..F/2, in two
// shared-memory rows, which band_fft() transforms stage by stage; bands 0
// and F/2 are their own partners and use one row. for_each_pair() walks the
// frequency pairs of the block's bands. (long_band.cuh holds the band unit
// on the row FFT that the long conv's band kernels run on.)
#pragma once

#include "fft_common.cuh"

namespace ffc {

// Blocks an SM that long_spectrum's band kernel is compiled for; it caps its
// registers at 128. Measured on an H100 at B=1, H=256, N=2^21 with the
// long conv's band kernel of this design (before long_band.cuh): 9.7, 6.7,
// 8.2 ms at 1, 2, 3 blocks.
constexpr int kBandMinBlocks = 2;

// Longest band: two padded rows of float2 must fit one block's shared memory.
constexpr int kMaxBand = 8192;

// float2 slots of one padded shared-memory row of `band` points (slot()).
__host__ __device__ constexpr int band_slots(int band) { return band + (band >> 5); }

inline size_t band_pair_smem_bytes(int band) { return 2 * band_slots(band) * sizeof(float2); }

// x[i] of the (gated) real input, 0 past the end. The pregate product is
// rounded to T, as u * pregate is in the plain version.
template <typename T, bool GATED>
__device__ __forceinline__ float load_real(const T* __restrict__ u, const T* __restrict__ pre,
                                           int i, int length) {
  if (i >= length) return 0.f;
  if (GATED) return to_f(from_f<T>(to_f(u[i]) * to_f(pre[i])));
  return to_f(u[i]);
}

template <typename T, bool GATED>
__device__ __forceinline__ void store_real(T* __restrict__ out, const T* __restrict__ post,
                                           int i, int length, float y) {
  if (i >= length) return;
  if (GATED) y *= to_f(post[i]);
  out[i] = from_f<T>(y);
}

// In-register F-point DFT with every index a constant expression: the
// bit-reversal partner comes from a template, not from a loop the compiler
// has to fold, so v never leaves registers. Same arithmetic, in the same
// order, as line_dft (fft_common.cuh).
template <int I, int BITS> struct BitRev { static constexpr int value = bit_reverse(I, BITS); };

template <int F, int I = 0>
__device__ __forceinline__ void bitrev_swap(float2* v) {
  if constexpr (I < F) {
    constexpr int J = BitRev<I, ilog2(F)>::value;
    if constexpr (J > I) {
      const float2 t = v[I];
      v[I] = v[J];
      v[J] = t;
    }
    bitrev_swap<F, I + 1>(v);
  }
}

template <int F, int LEN, bool INV>
__device__ __forceinline__ void fft_level(float2 (&v)[F], const float2* roots) {
  if constexpr (LEN <= F) {
    constexpr int half = LEN / 2;
#pragma unroll
    for (int i = 0; i < F; i += LEN) {
#pragma unroll
      for (int j = 0; j < half; ++j) {
        float2 w = roots[j * (kMaxFactor / LEN)];
        if (INV) w.y = -w.y;
        const float2 a = v[i + j];
        const float2 b = cmul(v[i + j + half], w);
        v[i + j] = make_float2(a.x + b.x, a.y + b.y);
        v[i + j + half] = make_float2(a.x - b.x, a.y - b.y);
      }
    }
  }
}

template <int F, bool INV>
__device__ __forceinline__ void line_fft(float2 (&v)[F], const float2* roots) {
  bitrev_swap<F>(v);
  fft_level<F, 2, INV>(v, roots);
  fft_level<F, 4, INV>(v, roots);
  fft_level<F, 8, INV>(v, roots);
  fft_level<F, 16, INV>(v, roots);
  fft_level<F, 32, INV>(v, roots);
}

// exp(-2 pi i k / 32) for k < 16, rounded to f32.
__host__ __device__ constexpr float root32_re(int k) {
  constexpr float c[16] = {1.0f, 0.98078525f, 0.9238795f, 0.8314696f, 0.70710677f, 0.55557024f,
                           0.38268343f, 0.19509032f, 0.0f, -0.19509032f, -0.38268343f,
                           -0.55557024f, -0.70710677f, -0.8314696f, -0.9238795f, -0.98078525f};
  return c[k];
}
__host__ __device__ constexpr float root32_im(int k) {
  constexpr float c[16] = {0.0f, -0.19509032f, -0.38268343f, -0.55557024f, -0.70710677f,
                           -0.8314696f, -0.9238795f, -0.98078525f, -1.0f, -0.98078525f,
                           -0.9238795f, -0.8314696f, -0.70710677f, -0.55557024f, -0.38268343f,
                           -0.19509032f};
  return c[k];
}

// b * exp(-2 pi i K / 32), K < 16: 1 and -i cost no multiply.
template <int K>
__device__ __forceinline__ float2 mul_root(float2 b) {
  if constexpr (K == 0) {
    return b;
  } else if constexpr (K == 8) {
    return make_float2(b.y, -b.x);
  } else {
    constexpr float wr = root32_re(K), wi = root32_im(K);
    return make_float2(b.x * wr - b.y * wi, b.x * wi + b.y * wr);
  }
}

// fft_level with the root of column J a compile-time constant.
template <int F, int LEN, int J = 0>
__device__ __forceinline__ void fft_level_const(float2* v) {
  if constexpr (J < LEN / 2) {
#pragma unroll
    for (int i = 0; i < F; i += LEN) {
      const float2 a = v[i + J];
      const float2 b = mul_root<J * (kMaxFactor / LEN)>(v[i + J + LEN / 2]);
      v[i + J] = make_float2(a.x + b.x, a.y + b.y);
      v[i + J + LEN / 2] = make_float2(a.x - b.x, a.y - b.y);
    }
    fft_level_const<F, LEN, J + 1>(v);
  }
}

// Forward line_fft of the F points at v with the 32nd roots as literals in
// place of a roots table (row_fft.cuh, whose lines are slices of a longer
// register array).
template <int F, int LEN = 2>
__device__ __forceinline__ void line_fft_const(float2* v) {
  if constexpr (LEN == 2) bitrev_swap<F>(v);
  if constexpr (LEN <= F) {
    fft_level_const<F, LEN>(v);
    line_fft_const<F, 2 * LEN>(v);
  }
}

// stage_lines (fft_common.cuh) over line_fft: one Monarch stage of a band in
// shared memory.
template <int F, bool INV>
__device__ __forceinline__ void band_lines(float2* s, int m, int stride,
                                           const float2* __restrict__ tw, const float2* roots) {
  const int lines = m / F;
  for (int line = threadIdx.x; line < lines; line += blockDim.x) {
    const int r = line & (stride - 1);
    const int base = (line - r) * F + r;
    float2 v[F];
#pragma unroll
    for (int t = 0; t < F; ++t) v[t] = s[slot(base + t * stride)];
    if (INV && tw != nullptr) {
#pragma unroll
      for (int t = 0; t < F; ++t) v[t] = cmul_conj(v[t], __ldg(tw + t * stride + r));
    }
    line_fft<F, INV>(v, roots);
    if (!INV && tw != nullptr) {
#pragma unroll
      for (int t = 0; t < F; ++t) v[t] = cmul(v[t], __ldg(tw + t * stride + r));
    }
#pragma unroll
    for (int t = 0; t < F; ++t) s[slot(base + t * stride)] = v[t];
  }
}

template <bool INV>
__device__ __noinline__ void band_stage(float2* s, int m, int f, int stride,
                                        const float2* __restrict__ tw, const float2* roots) {
  switch (f) {
    case 2: band_lines<2, INV>(s, m, stride, tw, roots); break;
    case 4: band_lines<4, INV>(s, m, stride, tw, roots); break;
    case 8: band_lines<8, INV>(s, m, stride, tw, roots); break;
    case 16: band_lines<16, INV>(s, m, stride, tw, roots); break;
    default: band_lines<32, INV>(s, m, stride, tw, roots); break;
  }
}

__device__ __forceinline__ void load_band(float2* s, const float2* __restrict__ z, int band) {
  for (int n = threadIdx.x; n < band; n += blockDim.x) s[slot(n)] = z[n];
}

// The R-point transforms of the block's one or two bands, stage by stage.
template <bool INV>
__device__ __forceinline__ void band_fft(float2* sa, float2* sb, bool two, const Plan& p,
                                         const float2* __restrict__ tw, const float2* roots) {
  for (int i = 0; i < p.n_stages; ++i) {
    const int j = INV ? p.n_stages - 1 - i : i;
    const float2* twj = j < p.n_stages - 1 ? tw + p.tw_off[j] : nullptr;
    band_stage<INV>(sa, p.m, p.f[j], p.stride[j], twj, roots);
    if (two) band_stage<INV>(sb, p.m, p.f[j], p.stride[j], twj, roots);
    __syncthreads();
  }
}

// Calls fn(k, zk, zm, first) for every frequency pair (k, M - k) of the
// block's bands after their forward FFTs: zk and zm point at Z[k] and
// Z[M - k] in shared memory; first marks k = 0, whose partner Z[M] is Z[0]
// itself (zk == zm).
template <typename Fn>
__device__ __forceinline__ void for_each_pair(int kp, int outer, float2* sa, float2* sb,
                                              const Plan& p, Fn fn) {
  const int band = p.m;
  if (kp == 0) {
    for (int j = threadIdx.x; j <= band / 2; j += blockDim.x)
      fn(outer * j, sa + freq_slot(j, p), sa + freq_slot((band - j) & (band - 1), p), j == 0);
  } else if (2 * kp == outer) {
    for (int j = threadIdx.x; j < band / 2; j += blockDim.x)
      fn(kp + outer * j, sa + freq_slot(j, p), sa + freq_slot(band - 1 - j, p), false);
  } else {
    for (int j = threadIdx.x; j < band; j += blockDim.x)
      fn(kp + outer * j, sa + freq_slot(j, p), sb + freq_slot(band - 1 - j, p), false);
  }
}

}  // namespace ffc
