// Batched 1D FFT kernels: fft_fused, rfft_fused and irfft_fused.
//
// Replaces (src/repro/kernels/fft_radix2.py):
//   fft_fused   (:279, pallas_call at :299)  complex (B, N) -> (B, N)
//   rfft_fused  (:319, pallas_call at :340)  real (B, N) -> (B, N/2+1)
//   irfft_fused (:358, pallas_call at :379)  (B, N/2+1) -> real (B, N)
//
// Bound on an H100: HBM bytes. Each kernel reads its input once and writes
// its output once (fft_fused: 16 bytes per complex element; the real pair
// half that), while the arithmetic is 5 N log2 N flops per complex row, far
// below the card's float32 rate per byte moved.
//
// Design: one block per tile of rows (the host census picks the tile, see
// repro_torch/kernels/fft_radix2.py), so the transform costs one HBM round
// trip, as the Pallas kernel's one VMEM residency did. The grid takes any
// batch: the last block masks the rows past the batch. The real kernels
// read the N reals of a row as N/2 packed complex values (the even/odd pack
// is a reinterpretation, not a copy).
//
// Radix 4: the register-pass panel of stockham_regs.cuh. Each pass holds 16
// values a thread and does two radix-4 layers in registers per exchange
// through shared memory; the first pass loads straight from HBM and the last
// stores straight to HBM. A 2048-point row is three passes, two exchanges
// and three barriers. rfft_fused's last pass pairs each bin with its mirror
// in registers and recombines there where its radix is at most 8 (half rows
// of 2^9, 2^10, 2^11 and 2^13: its 1024-point half row also takes three
// passes, two exchanges and three barriers); on other half rows the last
// pass writes the half spectrum to shared memory and the recombination reads
// it back. irfft_fused untangles in its first pass's reads (Y[k] and its
// mirror Y[m-k] straight from HBM) and stores conj(z) / m from its last: its
// half row of 1024 is the same three passes, two exchanges and three
// barriers. One instance per line length, so that every stride, shift and
// pass is a compile-time constant; blocks of up to 256 threads (every row of
// up to 4096 values in the census's tiles) may use more than the 64
// registers a thread of a 1024-thread block has.
//
// Radix 2: the same passes, each doing its four (or fewer) radix-2
// Stockham stages in registers (regs::r2_layers): the butterflies and
// twiddles of the stage-at-a-time panel, a 2048-point row in three passes,
// two exchanges and three barriers where the stage panel took eleven stages
// and 22 barriers. rfft_fused recombines as at radix 4, its W_{2m}^k by
// sincospif; irfft_fused untangles in its first pass's reads as at radix 4
// (its twiddles by sincospif there too), its 1024-point half row three
// passes where the stage panel took ten stages.
#include <cuda_runtime.h>

#include <utility>

#include "fft_common.cuh"
#include "stockham_regs.cuh"

namespace repro {
namespace {

// Threads a register-pass block may have on lines of 2^log_n values: the
// census's tiles hold at most 4096 values (256 threads) unless one line is
// longer. The three row kernels also name one block an SM as their
// minimum: without it ptxas held several instances to 64 registers and
// spilled.
__host__ __device__ constexpr int regs_max_threads(int log_n) {
  return log_n > 12 ? (1 << log_n) / regs::kValues : 256;
}

// fft_fused on the register-pass panel, rows of n = 2^LOG_N, HBM ->
// registers -> HBM, its passes' layers of radix RADIX (regs::pass).
// out = conj_out(panel(conj_in(x))) * scale.
template <int LOG_N, int RADIX>
__global__ void __launch_bounds__(regs_max_threads(LOG_N), 1)
fft_regs_kernel(const float2* __restrict__ x,
    float2* __restrict__ y,
    int batch,
    int log_rows,
    int conj,
    float scale) {
  extern __shared__ float2 smem[];
  const int P = 1 << (LOG_N + log_rows);
  float2* rom = smem + regs::padded(P);
  regs::build_rom(rom, 1 << (LOG_N - 1));
  const regs::HbmRows<LOG_N> rows{x, y, static_cast<long long>(blockIdx.x) << log_rows, batch,
                                  conj, scale};
  regs::panel<LOG_N, LOG_N - 1, RADIX>(smem, P, rom, rows, rows);
}

// True where rfft_fused's last pass pairs mirror groups in registers: a
// last pass of radix R <= 8 (two or more groups a thread) over a span l of
// 256 or more (m = 2^9, 2^10, 2^11, 2^13).
__host__ __device__ constexpr bool rfft_pairs_in_registers(int log_m) {
  return regs::pass_count(log_m) >= 3 && regs::last_log_radix(log_m) <= 3;
}

// Input j of group p times W_{R l}^{j p} = rom_twiddle(j e1), of group
// l - p times W_R^j conj(W_{R l}^{j p}), of group l/2 (p0) times W_{2R}^j.
template <int R, int J = 1>
__device__ __forceinline__ void twiddle_pair(float2* va, float2* vb, const float2* rom, int e1,
                                             int half, bool p0) {
  if constexpr (J < R) {
    const float2 wa = regs::rom_twiddle(rom, J * e1, half);
    va[J] = cmul(va[J], wa);
    const float2 wb = p0 ? regs::w16<(8 / R) * J>() : regs::mul_w16<(16 / R) * J>(cconj(wa));
    vb[J] = cmul(vb[J], wb);
    twiddle_pair<R, J + 1>(va, vb, rom, e1, half, p0);
  }
}

// rfft_fused's last pass and recombination in registers. Bin k = t + c l of
// the half spectrum comes out of group t's output c, and its mirror
// m - k = (l - t) + (R-1-c) l out of group l - t's output R-1-c. So each
// thread takes the group pair (p, l - p), p < l/2, and recombines both
// bins of each pair without a further exchange: Y[k] = Xe + w Xo and
// Y[m-k] = conj(Xe - w Xo), w = W_{2m}^k. The pair p = 0 holds the groups
// 0 and l/2, each its own mirror, and also writes Y[m]. The lines are
// plain here (after a middle pass), so group p's inputs t + j l and group
// l - p's, 16 consecutive values descending across a half-warp, each fall
// in 16 bank pairs (lane p = 0's l/2 + j l in the one the others leave).
// Radix 4: twiddles W_{R l}^{j p} from the ROM; group l - p's are W_R^j
// conj of those, group l/2's the constants W_{2R}^j; w from the ROM.
// Radix 2: each group runs regs::r2_layers on its own k (its twiddles from
// the ROM), and w comes from sincospif (regs::w_2m).
template <int LOG_M, int RADIX>
__device__ __forceinline__ void rfft_last_pass_paired(const float2* buf, const float2* rom,
                                                      float2* __restrict__ y, long long row0,
                                                      int batch) {
  using namespace regs;
  constexpr int NP = pass_count(LOG_M);
  constexpr int LR = last_log_radix(LOG_M);
  constexpr int R = 1 << LR;
  constexpr int LOG_L = 4 * (NP - 1);
  constexpr int l = 1 << LOG_L;
  constexpr int m = 1 << LOG_M;
  constexpr int kShift = LOG_M + 1 - LR - LOG_L;  // ROM: W_{2m}^j, j < m
#pragma unroll
  for (int i = 0; i < kValues / (2 * R); ++i) {
    const int pp = threadIdx.x + i * blockDim.x;
    const int line = pp >> (LOG_L - 1);
    const int p = pp & (l / 2 - 1);
    const float2* in_a = buf + (line << LOG_M) + p;
    const float2* in_b = buf + (line << LOG_M) + (p == 0 ? l / 2 : l - p);
    float2 va[R], vb[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      va[j] = in_a[j * l];
      vb[j] = in_b[j * l];
    }
    if constexpr (RADIX == 2) {
      r2_layers<LR>(va, p, LOG_L, LOG_M, rom);
      r2_layers<LR>(vb, p == 0 ? l / 2 : l - p, LOG_L, LOG_M, rom);
    } else {
      twiddle_pair<R>(va, vb, rom, p << kShift, m, p == 0);
      dft<R>(va);
      dft<R>(vb);
    }
    if (row0 + line < batch) {
      float2* out = y + (row0 + line) * (m + 1);
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const float2 za = va[out_reg<R>(c)];
        const float2 zm = p == 0 ? va[out_reg<R>((R - c) % R)] : vb[out_reg<R>(R - 1 - c)];
        const float2 w = RADIX == 2 ? w_2m(p + c * l, m) : rom[slot(p) + c * padded(l)];
        const float2 xe = make_float2(0.5f * (za.x + zm.x), 0.5f * (za.y - zm.y));
        const float2 xo = make_float2(0.5f * (za.y + zm.y), -0.5f * (za.x - zm.x));
        const float2 tw = cmul(w, xo);
        out[p + c * l] = cadd(xe, tw);
        if (p != 0) {
          out[m - p - c * l] = cconj(csub(xe, tw));
        } else {
          const float2 zb = vb[out_reg<R>(c)];
          out[l / 2 + c * l] = recombine(
              zb, cconj(vb[out_reg<R>(R - 1 - c)]),
              RADIX == 2 ? w_2m(l / 2 + c * l, m) : rom[slot(l / 2 + c * l)]);
        }
      }
      if (p == 0) out[m] = recombine(va[0], cconj(va[0]), make_float2(-1.f, 0.f));
    }
  }
}

// rfft_fused on the register-pass panel, its layers of radix RADIX. x: (B,
// 2m) reals read as (B, m) packed complex, m = 2^LOG_M; y: (B, m+1),
// Y[k] = Xe + W_{2m}^k Xo from z[k] and conj z[m-k]. Where
// rfft_pairs_in_registers the last pass recombines in registers; elsewhere
// it leaves the half spectrum z in shared memory and the recombination
// reads it back. W_{2m}^k from the ROM at radix 4, by sincospif at radix 2.
template <int LOG_M, int RADIX>
__global__ void __launch_bounds__(regs_max_threads(LOG_M), 1)
rfft_regs_kernel(const float2* __restrict__ x,
    float2* __restrict__ y,
    int batch,
    int log_rows) {
  extern __shared__ float2 smem[];
  using regs::slot;
  constexpr int m = 1 << LOG_M;
  const int P = m << log_rows;
  float2* buf = smem;
  float2* rom = smem + regs::padded(P);  // W_{2m}^j, j < m
  regs::build_rom(rom, m);
  const long long row0 = static_cast<long long>(blockIdx.x) << log_rows;
  const regs::HbmRows<LOG_M> rows{x, nullptr, row0, batch, 0, 1.f};
  if constexpr (rfft_pairs_in_registers(LOG_M)) {
    regs::panel_head<LOG_M, LOG_M, RADIX>(buf, P, rom, rows);
    rfft_last_pass_paired<LOG_M, RADIX>(buf, rom, y, row0, batch);
    return;
  }
  // The half spectrum in shared memory: plain after two or more passes,
  // padded after a single one. Bin k of each line (k < m) from z[k] and
  // z[(m - k) mod m]; the thread of k = 0 also writes Y[m]. That thread's
  // mirror is its own z[0]: it reads z[m-1] with its neighbour (one
  // address) rather than wrap round to z[0], so the mirrored reads of a
  // half-warp stay consecutive.
  using Lines = regs::SmemLines<LOG_M, regs::pass_count(LOG_M) == 1>;
  regs::panel<LOG_M, LOG_M, RADIX>(buf, P, rom, rows, Lines{buf});
  __syncthreads();
  for (int it = threadIdx.x; it < P; it += blockDim.x) {
    const int line = it >> LOG_M;
    const int k = it & (m - 1);
    const float2 zk = buf[Lines::at(it)];
    const float2 zr = buf[Lines::at((line << LOG_M) + m - max(k, 1))];
    const float2 zm = cconj(k == 0 ? zk : zr);
    if (row0 + line < batch) {
      float2* out = y + (row0 + line) * (m + 1);
      const float2 w = RADIX == 2 ? regs::w_2m(k, m) : rom[slot(k)];
      out[k] = regs::recombine(zk, zm, w);
      if (k == 0) out[m] = regs::recombine(zk, zm, make_float2(-w.x, -w.y));
    }
  }
}

using FftRegsKernel = void (*)(const float2*, float2*, int, int, int, float);
using RfftRegsKernel = void (*)(const float2*, float2*, int, int);

// One instance per line length and radix: fft_fused on 2 ... 2^14,
// rfft_fused and irfft_fused on half rows of 1 ... 2^13 (the one-block rows
// of the census).
constexpr int kRegsMaxLog = 14;

template <int RADIX, int... I>
FftRegsKernel fft_regs_kernel_for(int log_n, std::integer_sequence<int, I...>) {
  FftRegsKernel kernel = nullptr;
  ((log_n == I + 1 ? (kernel = fft_regs_kernel<I + 1, RADIX>, 0) : 0), ...);
  return kernel;
}

template <int RADIX, int... I>
RfftRegsKernel rfft_regs_kernel_for(int log_m, std::integer_sequence<int, I...>) {
  RfftRegsKernel kernel = nullptr;
  ((log_m == I ? (kernel = rfft_regs_kernel<I, RADIX>, 0) : 0), ...);
  return kernel;
}

// The first pass of irfft_fused reads the half spectra straight from HBM
// (rows of m + 1 bins) and untangles on its way in: element k of a line
// becomes regs::untangle(Y[k], Y[m-k], W_{2m}^k), the inverse's input to the
// forward panel. At k = 0 the mirror is Y[m], the Nyquist bin, so nothing
// wraps; both lose their imaginary parts, as numpy drops them. Each j is
// untangled as soon as its two loads are in (16 values live, not 32). The
// pass runs before the first barrier, so W_{2m}^k comes from sincospif, not
// the ROM: W_{2m}^t once a group, times a constant (untangle_twiddle). Rows
// past the batch read row batch - 1 (those lines are never stored), so every
// load is unpredicated; a group's Y[k] and Y[m-k] runs are one address each.
template <int LOG_M>
struct UntangledHalfRows {
  static constexpr bool kShared = false;
  const float2* x;
  long long row0;
  int batch;

  template <int R>
  __device__ __forceinline__ void read(int line, int t, int s, float2* v, bool) const {
    constexpr int m = 1 << LOG_M;
    const long long row = min(row0 + line, static_cast<long long>(batch) - 1);
    const float2* yk = x + row * (m + 1) + t;
    const float2* ym = x + row * (m + 1) + (m - t);
    const float2 wt = regs::w_2m(t, m);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float2 a = yk[j * s], b = ym[-j * s];
      if (j == 0 && t == 0) a.y = b.y = 0.f;  // DC and Nyquist
      v[j] = regs::untangle(a, b, regs::untangle_twiddle<R>(wt, j));
    }
  }
};

// irfft_fused on the register-pass panel, its layers of radix RADIX. x: (B,
// m+1) half spectra, m = 2^LOG_M; y: (B, 2m) reals written as (B, m) packed
// complex. The first pass untangles (UntangledHalfRows), the panel runs the
// half-size inverse on the forward passes by conjugation, and the last pass
// stores conj / m straight to HBM. ROM: W_m^j, j < m/2, padded (the panel's
// own).
template <int LOG_M, int RADIX>
__global__ void __launch_bounds__(regs_max_threads(LOG_M), 1)
irfft_regs_kernel(const float2* __restrict__ x,
    float2* __restrict__ y,
    int batch,
    int log_rows) {
  extern __shared__ float2 smem[];
  constexpr int m = 1 << LOG_M;
  const int P = m << log_rows;
  float2* rom = smem + regs::padded(P);
  regs::build_rom(rom, m / 2);
  const long long row0 = static_cast<long long>(blockIdx.x) << log_rows;
  regs::panel<LOG_M, LOG_M - 1, RADIX>(
      smem, P, rom, UntangledHalfRows<LOG_M>{x, row0, batch},
      regs::HbmRows<LOG_M>{nullptr, y, row0, batch, 1, 1.f / m});
}

template <int RADIX, int... I>
RfftRegsKernel irfft_regs_kernel_for(int log_m, std::integer_sequence<int, I...>) {
  RfftRegsKernel kernel = nullptr;
  ((log_m == I ? (kernel = irfft_regs_kernel<I, RADIX>, 0) : 0), ...);
  return kernel;
}

}  // namespace
}  // namespace repro

using repro::host_log2;
using repro::is_pow2;

extern "C" int repro_fft_fused(const void* x, void* y, int batch, int n, int radix, int rows,
                               int threads, int smem, int conj, float scale, int device,
                               void* stream) {
  if (batch < 1 || n < 2 || !is_pow2(n) || !is_pow2(rows) || (radix != 2 && radix != 4))
    return cudaErrorInvalidValue;
  const int grid = (batch + rows - 1) / rows;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const float2*>(x);
  auto* out = static_cast<float2*>(y);
  if (n > (1 << repro::kRegsMaxLog)) return cudaErrorInvalidValue;
  if (!repro::regs::geometry_ok(n * rows, threads, smem, n / 2))
    return cudaErrorInvalidConfiguration;
  constexpr auto lengths = std::make_integer_sequence<int, repro::kRegsMaxLog>{};
  const auto kernel = radix == 4 ? repro::fft_regs_kernel_for<4>(host_log2(n), lengths)
                                 : repro::fft_regs_kernel_for<2>(host_log2(n), lengths);
  cudaError_t err = repro::prepare(kernel, device, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(in, out, batch, host_log2(rows), conj, scale);
  return cudaGetLastError();
}

extern "C" int repro_rfft_fused(const void* x, void* y, int batch, int n, int radix, int rows,
                                int threads, int smem, int device, void* stream) {
  if (batch < 1 || n < 2 || !is_pow2(n) || !is_pow2(rows) || (radix != 2 && radix != 4))
    return cudaErrorInvalidValue;
  const int m = n / 2;
  const int grid = (batch + rows - 1) / rows;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const float2*>(x);
  auto* out = static_cast<float2*>(y);
  if (m >= (1 << repro::kRegsMaxLog)) return cudaErrorInvalidValue;
  if (!repro::regs::geometry_ok(m * rows, threads, smem, m)) return cudaErrorInvalidConfiguration;
  constexpr auto lengths = std::make_integer_sequence<int, repro::kRegsMaxLog>{};
  const auto kernel = radix == 4 ? repro::rfft_regs_kernel_for<4>(host_log2(m), lengths)
                                 : repro::rfft_regs_kernel_for<2>(host_log2(m), lengths);
  cudaError_t err = repro::prepare(kernel, device, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(in, out, batch, host_log2(rows));
  return cudaGetLastError();
}

extern "C" int repro_irfft_fused(const void* x, void* y, int batch, int n, int radix, int rows,
                                 int threads, int smem, int device, void* stream) {
  if (batch < 1 || n < 2 || !is_pow2(n) || !is_pow2(rows) || (radix != 2 && radix != 4))
    return cudaErrorInvalidValue;
  const int m = n / 2;
  const int grid = (batch + rows - 1) / rows;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const float2*>(x);
  auto* out = static_cast<float2*>(y);
  if (m >= (1 << repro::kRegsMaxLog)) return cudaErrorInvalidValue;
  if (!repro::regs::geometry_ok(m * rows, threads, smem, m / 2))
    return cudaErrorInvalidConfiguration;
  constexpr auto lengths = std::make_integer_sequence<int, repro::kRegsMaxLog>{};
  const auto kernel = radix == 4 ? repro::irfft_regs_kernel_for<4>(host_log2(m), lengths)
                                 : repro::irfft_regs_kernel_for<2>(host_log2(m), lengths);
  cudaError_t err = repro::prepare(kernel, device, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(in, out, batch, host_log2(rows));
  return cudaGetLastError();
}
