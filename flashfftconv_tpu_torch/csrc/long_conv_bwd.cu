// long_conv_bwd: the band stage of the backward of the FFT convolution for
// N >= 65536, and long_dk_finish, the band stage of the way from the dk
// spectrum back to dk.
//
// long_conv_bwd replaces the TPU kernel _long_bwd_tiles (flashfftconv_tpu/
// ops/monarch_pallas.py, def at l.2843, pallas_call at l.2921, body
// _long_bwd_kernel at l.2529): per (b, h) row, with U = DFT(u * pre) and
// G = DFT(dout * post),
//   du_inner = iDFT(G conj(K)),  y_inner = iDFT(U K) (only when gated),
//   P[b, h]  = G conj(U)         (the row's share of dk's spectrum).
// long_dk_finish replaces _inv_dft_tiles (def at l.740, pallas_call at l.840)
// as _finish_dk (l.2953) drives it: the inverse DFT of the summed spectrum.
// The TPU kernels hold a whole row in VMEM; here, as in the forward
// (long_conv.cu), the outer F-point stage is the butterfly kernel and these
// kernels work between two butterfly passes on complex64 bands (rows, F, R)
// in device memory: the forward butterfly of u * pre and of dout * post
// before, the inverse butterfly of du, y and dk after.
//
// Design of long_conv_bwd. The split of the real FFT pairs frequency k with
// M - k, which lies in band F - k0 (long_common.cuh), and the three products
// need U and G at the same frequency. One block therefore owns the band pair
// {kp, F - kp} of both signals of one (b, h) row: four shared-memory rows,
// 4 x 33 KB = 132 KB at R = 4096, so one block an SM; it runs 512 threads to
// keep as many warps in flight as the forward's two blocks of 256. R = 8192
// (264 KB) does not fit and is refused; the default plans all have R = 4096,
// and a custom plan with R = 8192 runs its backward under the default plan
// of its size (ops/monarch_cuda.bwd_plan).
// The block runs the R-point FFTs of all four rows, then one pass over the
// frequency pairs: split U and G, store P[k] = G conj(U) and P[M - k], unsplit
// G conj(K) into G's rows and, when y is wanted, U K into U's rows; then the
// inverse FFTs, and the bands go out scaled by 1/R. du may be zg's buffer and
// y zu's: a block reads and writes only its own bands.
//
// The dk reduction over the batch. The TPU kernel accumulates dk_f across its
// sequential batch grid axis. Blocks here run in no order, and float atomics
// would make dk differ from run to run, so every row writes its own P[b, h]
// (8 (M+1) bytes a row: 2.1 GB a batch row at H = 256, M = 2^20) and
// long_dk_finish adds the B partials of a frequency in a fixed order. At
// B = 1 the partials are the spectrum and cost nothing extra.
//
// long_dk_finish: one block owns the band pair {kp, F - kp} of one channel in
// two shared-memory rows, as the forward does: sums P over b, unsplits, runs
// the inverse R-point FFTs and writes the bands (H, F, R) scaled by 1/R; the
// inverse butterfly (f32 out, cut to k_len) finishes dk.
//
// Bounds on the H100 at B=1, H=256, N=2^21 (M=2^20). long_conv_bwd ungated
// reads 4.3 GB of bands and 2.1 GB of k_f and writes 2.1 GB of du bands and
// 2.1 GB of P: 10.7 GB, 3.2 ms at 3.35 TB/s, against three R-point FFTs a
// band in f32 (about 67 GFLOP, 1.0 ms at 67 TFLOP/s): bytes. long_dk_finish
// reads 2.1 GB and writes 2.1 GB, 1.3 ms, against one FFT a band: bytes.

#include "long_common.cuh"

namespace ffc {

constexpr int kBwdThreads = 512;
// Longest band of the backward: four padded rows must fit one block.
constexpr int kBwdMaxBand = 4096;

template <bool NEED_Y>
__global__ void __launch_bounds__(kBwdThreads, 1)
    long_conv_bwd_kernel(const float2* zu, const float2* zg, float2* du, float2* y,
                         float2* __restrict__ partials, const float2* __restrict__ k_f,
                         const float2* __restrict__ tw, const float2* __restrict__ split_tw,
                         const float2* __restrict__ roots_g, int batch, int channels, int outer,
                         Plan p) {
  extern __shared__ float2 s[];
  __shared__ float2 roots[kMaxFactor];
  const int band = p.m;
  const int m = outer * band;
  const int pairs = outer / 2 + 1;
  const int kp = blockIdx.x % pairs;
  const int bh = blockIdx.x / pairs;
  const int h = bh / batch;
  const int b = bh - h * batch;
  const size_t row = ((size_t)b * channels + h) * (size_t)m;
  const size_t lo = row + (size_t)kp * band;
  const size_t hi = row + (size_t)(outer - kp) * band;
  const bool two = kp != 0 && 2 * kp != outer;
  // U's rows first, G's rows at the same offsets plus goff.
  const int goff = 2 * band_slots(band);
  float2* ua = s;
  float2* ub = s + band_slots(band);
  k_f += (size_t)h * (m + 1);
  float2* part = partials + ((size_t)b * channels + h) * (size_t)(m + 1);
  load_roots(roots, roots_g);
  load_band(ua, zu + lo, band);
  load_band(ua + goff, zg + lo, band);
  if (two) {
    load_band(ub, zu + hi, band);
    load_band(ub + goff, zg + hi, band);
  }
  __syncthreads();
  band_fft<false>(ua, ub, two, p, tw, roots);
  band_fft<false>(ua + goff, ub + goff, two, p, tw, roots);

  for_each_pair(kp, outer, ua, ub, p, [&](int k, float2* pk, float2* pm, bool first) {
    const float2 w = __ldg(split_tw + k);
    const float2 kk = __ldg(k_f + k);
    const float2 km = __ldg(k_f + m - k);
    float2* qk = pk + goff;
    float2* qm = pm + goff;
    float2 uk, um, gk, gm, zk, zm;
    split_pair(*pk, *pm, w, uk, um);
    split_pair(*qk, *qm, w, gk, gm);
    part[k] = cmul_conj(gk, uk);
    part[m - k] = cmul_conj(gm, um);
    unsplit_pair(cmul_conj(gk, kk), cmul_conj(gm, km), w, zk, zm);
    *qk = zk;
    if (!first) *qm = zm;
    if (NEED_Y) {
      unsplit_pair(cmul(uk, kk), cmul(um, km), w, zk, zm);
      *pk = zk;
      if (!first) *pm = zm;
    }
  });
  __syncthreads();
  band_fft<true>(ua + goff, ub + goff, two, p, tw, roots);
  if (NEED_Y) band_fft<true>(ua, ub, two, p, tw, roots);

  const float scale = 1.f / (float)band;
  for (int n = threadIdx.x; n < band; n += blockDim.x) {
    const int at = slot(n);
    const float2 a = ua[goff + at];
    du[lo + n] = make_float2(a.x * scale, a.y * scale);
    if (two) {
      const float2 c = ub[goff + at];
      du[hi + n] = make_float2(c.x * scale, c.y * scale);
    }
    if (NEED_Y) {
      const float2 e = ua[at];
      y[lo + n] = make_float2(e.x * scale, e.y * scale);
      if (two) {
        const float2 f = ub[at];
        y[hi + n] = make_float2(f.x * scale, f.y * scale);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBandMinBlocks)
    long_dk_finish_kernel(const float2* __restrict__ partials, float2* __restrict__ out,
                          const float2* __restrict__ tw, const float2* __restrict__ split_tw,
                          const float2* __restrict__ roots_g, int batch, int channels, int outer,
                          Plan p) {
  extern __shared__ float2 s[];
  __shared__ float2 roots[kMaxFactor];
  const int band = p.m;
  const int m = outer * band;
  const int pairs = outer / 2 + 1;
  const int kp = blockIdx.x % pairs;
  const size_t h = blockIdx.x / pairs;
  const bool two = kp != 0 && 2 * kp != outer;
  float2* sa = s;
  float2* sb = s + band_slots(band);
  const size_t row_stride = (size_t)channels * (size_t)(m + 1);
  const float2* part = partials + h * (size_t)(m + 1);
  out += h * (size_t)m;
  load_roots(roots, roots_g);
  for_each_pair(kp, outer, sa, sb, p, [&](int k, float2* pk, float2* pm, bool first) {
    float2 yk = make_float2(0.f, 0.f), ym = make_float2(0.f, 0.f);
    for (int b = 0; b < batch; ++b) {
      const float2 a = part[b * row_stride + k];
      const float2 c = part[b * row_stride + m - k];
      yk = make_float2(yk.x + a.x, yk.y + a.y);
      ym = make_float2(ym.x + c.x, ym.y + c.y);
    }
    float2 zk, zm;
    unsplit_pair(yk, ym, __ldg(split_tw + k), zk, zm);
    *pk = zk;
    if (!first) *pm = zm;
  });
  __syncthreads();
  band_fft<true>(sa, sb, two, p, tw, roots);
  const float scale = 1.f / (float)band;
  float2* oa = out + (size_t)kp * band;
  float2* ob = out + (size_t)(outer - kp) * band;
  for (int n = threadIdx.x; n < band; n += blockDim.x) {
    const float2 a = sa[slot(n)];
    oa[n] = make_float2(a.x * scale, a.y * scale);
    if (two) {
      const float2 c = sb[slot(n)];
      ob[n] = make_float2(c.x * scale, c.y * scale);
    }
  }
}

template <bool NEED_Y>
cudaError_t launch_long_bwd(const void* zu, const void* zg, void* du, void* y, void* partials,
                            const void* k_f, const void* tw, const void* split_tw,
                            const void* roots, int batch, int channels, int outer, const Plan& p,
                            cudaStream_t stream) {
  const size_t smem = 2 * band_pair_smem_bytes(p.m);
  auto kernel = long_conv_bwd_kernel<NEED_Y>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((long long)batch * channels * (outer / 2 + 1));
  kernel<<<blocks, kBwdThreads, smem, stream>>>(
      (const float2*)zu, (const float2*)zg, (float2*)du, (float2*)y, (float2*)partials,
      (const float2*)k_f, (const float2*)tw, (const float2*)split_tw, (const float2*)roots,
      batch, channels, outer, p);
  return cudaGetLastError();
}

inline bool check_bands(const Plan& p, int max_band, long long rows, int outer) {
  return p.m <= max_band && rows >= 1 && outer >= 2 && !(outer & (outer - 1)) &&
         (long long)outer * p.m <= (1LL << 21) && rows * (outer / 2 + 1) <= 0x7fffffffLL;
}

}  // namespace ffc

// zu, zg, du and y: (batch, channels, outer, band) complex64; du may be zg's
// buffer and y zu's; y is null when the forward's output is not wanted.
// partials: (batch, channels, outer * band + 1) complex64; k_f: (channels,
// outer * band + 1) complex64. The factors are the band's.
extern "C" int ffc_long_conv_bwd(const void* zu, const void* zg, void* du, void* y,
                                 void* partials, const void* k_f, const void* tw,
                                 const void* split_tw, const void* roots, int batch,
                                 int channels, int outer, int n_stages, int f0, int f1, int f2,
                                 int f3, void* stream) {
  const int factors[4] = {f0, f1, f2, f3};
  ffc::Plan p;
  if (!ffc::make_plan(n_stages, factors, &p) || batch < 1 || channels < 1 ||
      !ffc::check_bands(p, ffc::kBwdMaxBand, (long long)batch * channels, outer))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (y != nullptr)
    return (int)ffc::launch_long_bwd<true>(zu, zg, du, y, partials, k_f, tw, split_tw, roots,
                                           batch, channels, outer, p, st);
  return (int)ffc::launch_long_bwd<false>(zu, zg, du, y, partials, k_f, tw, split_tw, roots,
                                          batch, channels, outer, p, st);
}

// partials: (batch, channels, outer * band + 1) complex64; out: (channels,
// outer, band) complex64 for the inverse butterfly.
extern "C" int ffc_long_dk_finish(const void* partials, void* out, const void* tw,
                                  const void* split_tw, const void* roots, int batch,
                                  int channels, int outer, int n_stages, int f0, int f1, int f2,
                                  int f3, void* stream) {
  const int factors[4] = {f0, f1, f2, f3};
  ffc::Plan p;
  if (!ffc::make_plan(n_stages, factors, &p) || batch < 1 ||
      !ffc::check_bands(p, ffc::kMaxBand, channels, outer))
    return (int)cudaErrorInvalidValue;
  const size_t smem = ffc::band_pair_smem_bytes(p.m);
  cudaError_t err = cudaFuncSetAttribute(ffc::long_dk_finish_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((long long)channels * (outer / 2 + 1));
  ffc::long_dk_finish_kernel<<<blocks, ffc::kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)partials, (float2*)out, (const float2*)tw, (const float2*)split_tw,
      (const float2*)roots, batch, channels, outer, p);
  return (int)cudaGetLastError();
}

FFC_EXPORT_ERROR_STRING()
