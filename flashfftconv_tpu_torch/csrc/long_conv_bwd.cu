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
// Design of long_conv_bwd (one instance per band R = 128 ... 4096 and
// NEED_Y; the C entry dispatches on R), on the band unit of long_band.cuh.
// The three products need U and G at the same frequency, so a unit holds two
// rows of R complex points (U's and G's, 64 KB at R = 4096), and one block
// holds both units of a pair (128 KB at R = 4096, one block an SM, up to 255
// registers: no stack frame). A thread block cluster of two CTAs, one unit
// each (64 KB, three CTAs an SM at 168 registers, the partner's rows through
// distributed shared memory) ran 9.83 ms against this layout's 8.08 on an
// H100 (PERF.md), and its gated instance spilled. The parent design (four
// padded rows of 512 threads, band FFTs stage by stage through shared memory
// with device-memory twiddles, the split twiddle gathered at stride F) ran
// 14.24 ms.
// A unit runs the R-point FFTs of its U band, then its G band. The pair pass
// splits U and G, stores P[k] = G conj(U) and P[M - k] (natural order, as
// long_dk_finish and the plain version take them), and writes the
// conjugates of the unsplit G conj(K) over G's slots and, when y is wanted,
// of U K over U's. Then each unit takes the inverse FFTs and stores du's band
// and y's. Blocks are channel-major (row h B + b), so the B rows of a
// channel read k_f[h] from L2 after the first. Every output has one writer:
// two calls give the same bits. du may be zg's buffer and y zu's. R = 8192
// (256 KB a pair) is refused; the default plans all have R = 4096, and a
// custom plan with R = 8192 runs its backward under the default plan of its
// size (ops/monarch_cuda.bwd_plan). Each band's FFTs are one loop copy in
// the code (#pragma unroll 1 over U and G): written out four times, the
// gated kernel ran 2.5x slower. The natural-order k_f and partials, read
// and written F points apart, are 36% of the kernel's time (PERF.md).
//
// The dk reduction over the batch. The TPU kernel accumulates dk_f across its
// sequential batch grid axis. Blocks here run in no order, and float atomics
// would make dk differ from run to run, so every row writes its own P[b, h]
// (8 (M+1) bytes a row: 2.1 GB a batch row at H = 256, M = 2^20) and
// long_dk_finish adds the B partials of a frequency in a fixed order. At
// B = 1 the partials are the spectrum and cost nothing extra.

// long_dk_finish (one instance per band R = 128 ... 8192: the backward runs
// the finish under the forward's plan), on the same band unit with one row a
// unit and the block of long_conv.cu. Its pair pass comes first and reads no
// shared memory: the unit of band k0 sums the B partials of k and of M - k
// in the order b = 0 .. B - 1, unsplits, and writes the conjugates into the
// two rows; then each unit runs the inverse FFT of its band and stores it
// scaled by 1/R into the (H, F, R) bands, which the inverse butterfly (f32
// out, cut to k_len) takes to dk.
//
// Bounds on the H100 at B=1, H=256, N=2^21 (M=2^20). long_conv_bwd ungated
// reads 4.3 GB of bands and 2.1 GB of k_f and writes 2.1 GB of du bands and
// 2.1 GB of P: 10.7 GB, 3.2 ms at 3.35 TB/s, against three R-point FFTs a
// band in f32 (about 67 GFLOP, 1.0 ms at 67 TFLOP/s): bytes. long_dk_finish
// reads 2.1 GB and writes 2.1 GB, 1.3 ms, against one FFT a band: bytes.

#include "long_band.cuh"

namespace ffc {

namespace lbwd {

using namespace lband;

// Longest band of the backward: a unit's two rows must fit a third of an SM.
constexpr int kMaxBwdLogBand = 12;

// Block c = 0 .. F/2 - 1 of row bh holds the units (rank 0 and 1, T threads
// each) of bands 0 and F/2 (c = 0; each its own partner) or c and F - c.
template <int LOG_R, bool NEED_Y>
__global__ void __launch_bounds__(CfgB<LOG_R>::kT * 2, 1)
    long_conv_bwd_kernel(const float2* zu, const float2* zg, float2* du, float2* y,
                         float2* __restrict__ partials, const float2* __restrict__ k_f,
                         const float2* __restrict__ split_tw, const float2* __restrict__ band_tw,
                         int batch, int channels, int outer) {
  using C = CfgB<LOG_R>;
  constexpr int kR = C::kM, kT = C::kT;
  extern __shared__ float4 smem_raw[];
  float2* smem = reinterpret_cast<float2*>(smem_raw);
  float2* tab = smem + 4 * kR;
  const int rank = threadIdx.x / kT;
  const int tr = threadIdx.x % kT;
  const int pair = blockIdx.x;
  const int half = outer / 2;
  const int c = pair % half;
  const int bh = pair / half;
  const int h = bh / batch, b = bh - h * batch;
  const int k0 = unit_band(c, rank, outer);
  const int m = outer * kR;
  const size_t row = ((size_t)b * channels + h) * (size_t)m;
  const size_t own = row + (size_t)k0 * kR;
  float2* su = smem + 2 * rank * kR;
  float2* sg = su + kR;
  load_band_table<C>(tab, band_tw);
  __syncthreads();
  // One copy of each FFT in the code, run once a row (U's, then G's): the
  // body written out twice runs far slower and takes more registers.
#pragma unroll 1
  for (int i = 0; i < 2; ++i) band_forward<C>((i ? zg : zu) + own, i ? sg : su, tab, tr);
  __syncthreads();

  // The pair pass.
  {
    float2* pu = c == 0 ? su : smem + 2 * (rank ^ 1) * kR;
    float2* pg = pu + kR;
    const float2* kh = k_f + (size_t)h * (m + 1);
    float2* part = partials + ((size_t)b * channels + h) * (size_t)(m + 1);
    const float2 w0 = split_tw[k0];
    const int n = pass_slots(k0, kR);
#pragma unroll 4
    for (int j = tr; j < n; j += kT) {
      const int k = k0 + outer * j;
      const int jm = partner_slot(k0, j, kR);
      const bool first = k0 == 0 && j == 0;
      const float2 w = cmul(w0, root<C>(tab, j));
      const float2 kk = __ldg(kh + k);
      const float2 km = __ldg(kh + m - k);
      float2* pk = su + swz(j);
      float2* pm = pu + swz(jm);
      float2* qk = sg + swz(j);
      float2* qm = pg + swz(jm);
      float2 uk, um, gk, gm, zk, zm;
      split_pair(*pk, *pm, w, uk, um);
      split_pair(*qk, *qm, w, gk, gm);
      part[k] = cmul_conj(gk, uk);
      part[m - k] = cmul_conj(gm, um);
      unsplit_pair(cmul_conj(gk, kk), cmul_conj(gm, km), w, zk, zm);
      *qk = make_float2(zk.x, -zk.y);
      if (!first) *qm = make_float2(zm.x, -zm.y);
      if (NEED_Y) {
        unsplit_pair(cmul(uk, kk), cmul(um, km), w, zk, zm);
        *pk = make_float2(zk.x, -zk.y);
        if (!first) *pm = make_float2(zm.x, -zm.y);
      }
    }
  }
  __syncthreads();

  // The inverse FFTs and the stores: G's (du), then U's (y) when wanted.
#pragma unroll 1
  for (int i = 0; i < (NEED_Y ? 2 : 1); ++i)
    band_inverse_store<C>(i ? su : sg, (i ? y : du) + own, tab, fresh_tid() % kT);
}

template <int LOG_R, bool NEED_Y>
cudaError_t launch_one(const void* zu, const void* zg, void* du, void* y, void* partials,
                       const void* k_f, const void* split_tw, const void* band_tw, int batch,
                       int channels, int outer, cudaStream_t stream) {
  using C = CfgB<LOG_R>;
  auto kernel = long_conv_bwd_kernel<LOG_R, NEED_Y>;
  const size_t smem = (size_t(4) * C::kM + C::kLo + C::kHi) * sizeof(float2);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((long long)batch * channels * (outer / 2)), C::kT * 2, smem, stream>>>(
      (const float2*)zu, (const float2*)zg, (float2*)du, (float2*)y, (float2*)partials,
      (const float2*)k_f, (const float2*)split_tw, (const float2*)band_tw, batch, channels,
      outer);
  return cudaGetLastError();
}

template <int LOG_R>
cudaError_t launch(const void* zu, const void* zg, void* du, void* y, void* partials,
                   const void* k_f, const void* split_tw, const void* band_tw, int batch,
                   int channels, int outer, cudaStream_t st) {
  return y != nullptr ? launch_one<LOG_R, true>(zu, zg, du, y, partials, k_f, split_tw, band_tw,
                                                batch, channels, outer, st)
                      : launch_one<LOG_R, false>(zu, zg, du, y, partials, k_f, split_tw,
                                                 band_tw, batch, channels, outer, st);
}

}  // namespace lbwd

namespace ldk {

using namespace lband;

// Block c = 0 .. F/2 - 1 of channel h holds the units rank = 0, 1 of bands
// unit_band(c, rank, F).
template <int LOG_R>
__global__ void __launch_bounds__(PairBlock<LOG_R>::kThreads, PairBlock<LOG_R>::kMinBlocks)
    long_dk_finish_kernel(const float2* __restrict__ partials, float2* __restrict__ out,
                          const float2* __restrict__ split_tw, const float2* __restrict__ band_tw,
                          int batch, int channels, int outer) {
  using C = CfgB<LOG_R>;
  constexpr int kR = C::kM, kT = C::kT;
  extern __shared__ float4 smem_raw[];
  float2* smem = reinterpret_cast<float2*>(smem_raw);
  float2* tab = smem + 2 * kR;
  load_band_table<C>(tab, band_tw);
  __syncthreads();

  // The pair pass: P summed over b = 0 .. B - 1 at k and M - k, unsplit.
  {
    const int rank = threadIdx.x / kT, tr = threadIdx.x % kT;
    const int c = blockIdx.x % (outer / 2);
    const int h = blockIdx.x / (outer / 2);
    const int k0 = unit_band(c, rank, outer);
    const int m = outer * kR;
    float2* s = smem + rank * kR;
    float2* ps = c == 0 ? s : smem + (rank ^ 1) * kR;
    const size_t row_stride = (size_t)channels * (size_t)(m + 1);
    const float2* part = partials + (size_t)h * (m + 1);
    const float2 w0 = split_tw[k0];
    const int n = pass_slots(k0, kR);
    for (int j = tr; j < n; j += kT) {
      const int k = k0 + outer * j;
      const bool first = k0 == 0 && j == 0;
      float2 yk = make_float2(0.f, 0.f), ym = make_float2(0.f, 0.f);
      for (int b = 0; b < batch; ++b) {
        const float2 a = __ldg(part + b * row_stride + k);
        const float2 e = __ldg(part + b * row_stride + m - k);
        yk = make_float2(yk.x + a.x, yk.y + a.y);
        ym = make_float2(ym.x + e.x, ym.y + e.y);
      }
      float2 zk, zm;
      unsplit_pair(yk, ym, cmul(w0, root<C>(tab, j)), zk, zm);
      s[swz(j)] = make_float2(zk.x, -zk.y);
      if (!first) ps[swz(partner_slot(k0, j, kR))] = make_float2(zm.x, -zm.y);
    }
  }
  __syncthreads();
  {
    const int tid = fresh_tid();
    band_inverse_store<C>(smem + tid / kT * kR, out + unit_offset<C>(tid / kT, 1, channels, outer),
                          tab, tid % kT);
  }
}

template <int LOG_R>
cudaError_t launch(const void* partials, void* out, const void* split_tw, const void* band_tw,
                   int batch, int channels, int outer, cudaStream_t stream) {
  using PB = PairBlock<LOG_R>;
  auto kernel = long_dk_finish_kernel<LOG_R>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PB::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((long long)channels * (outer / 2)), PB::kThreads, PB::kSmem, stream>>>(
      (const float2*)partials, (float2*)out, (const float2*)split_tw, (const float2*)band_tw,
      batch, channels, outer);
  return cudaGetLastError();
}

}  // namespace ldk

}  // namespace ffc

// zu, zg, du and y: (batch, channels, outer, band) complex64 on 16-byte
// boundaries; du may be zg's buffer and y zu's; y is null when the
// forward's output is not wanted. partials: (batch, channels, outer * band +
// 1) complex64; k_f: (channels, outer * band + 1) complex64. split_tw is the
// plan's (exp(-2 pi i m / N), m = 0 .. M), band_tw the band plan's
// (exp(-2 pi i j / 2R), j = 0 .. R).
extern "C" int ffc_long_conv_bwd(const void* zu, const void* zg, void* du, void* y,
                                 void* partials, const void* k_f, const void* split_tw,
                                 const void* band_tw, int batch, int channels, int outer,
                                 int band, void* stream) {
  auto pow2 = [](int v) { return v >= 1 && (v & (v - 1)) == 0; };
  if (batch < 1 || channels < 1 || !pow2(outer) || outer < 2 || !pow2(band) || band < 128 ||
      band > (1 << ffc::lbwd::kMaxBwdLogBand) || (long long)outer * band > (1LL << 21) ||
      (long long)batch * channels * outer > 0x7fffffffLL ||
      ((reinterpret_cast<uintptr_t>(zu) | reinterpret_cast<uintptr_t>(zg) |
        reinterpret_cast<uintptr_t>(du) | reinterpret_cast<uintptr_t>(y)) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FFC_BWD_CASE(LOG_R)                                                                   \
  case 1 << LOG_R:                                                                            \
    return (int)ffc::lbwd::launch<LOG_R>(zu, zg, du, y, partials, k_f, split_tw, band_tw,     \
                                         batch, channels, outer, st);
  switch (band) {
    FFC_BWD_CASE(7)
    FFC_BWD_CASE(8)
    FFC_BWD_CASE(9)
    FFC_BWD_CASE(10)
    FFC_BWD_CASE(11)
    FFC_BWD_CASE(12)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFC_BWD_CASE
}

// partials: (batch, channels, outer * band + 1) complex64; out: (channels,
// outer, band) complex64 on a 16-byte boundary, for the inverse butterfly.
// split_tw and band_tw as for ffc_long_conv_bwd.
extern "C" int ffc_long_dk_finish(const void* partials, void* out, const void* split_tw,
                                  const void* band_tw, int batch, int channels, int outer,
                                  int band, void* stream) {
  if (batch < 1 || channels < 1 || !ffc::lband::bands_ok(channels, outer, band) ||
      !ffc::lband::aligned16(out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FFC_DK_CASE(LOG_R)                                                                    \
  case 1 << LOG_R:                                                                            \
    return (int)ffc::ldk::launch<LOG_R>(partials, out, split_tw, band_tw, batch, channels,    \
                                        outer, st);
  switch (band) {
    FFC_DK_CASE(7)
    FFC_DK_CASE(8)
    FFC_DK_CASE(9)
    FFC_DK_CASE(10)
    FFC_DK_CASE(11)
    FFC_DK_CASE(12)
    FFC_DK_CASE(13)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFC_DK_CASE
}

FFC_EXPORT_ERROR_STRING()
