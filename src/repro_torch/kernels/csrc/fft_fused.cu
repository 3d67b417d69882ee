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
// repro_torch/kernels/fft_radix2.py). The block loads its rows with
// neighbouring threads on neighbouring addresses, runs every Stockham stage
// in shared memory (stockham.cuh), and stores once, so the transform costs
// one HBM round trip, as the Pallas kernel's one VMEM residency did. The
// grid takes any batch: the last block masks the rows past the batch. The
// real kernels read the N reals of a row as N/2 packed complex values (the
// even/odd pack is a reinterpretation, not a copy) and recombine straight
// from shared memory into the output row.
#include <cuda_runtime.h>

#include "stockham.cuh"

namespace repro {
namespace {

// out = conj_out(panel(conj_in(x))) * scale, rows of length n = 2^log_n.
template <int RADIX>
__global__ void __launch_bounds__(kMaxThreads)
fft_fused_kernel(const float2* __restrict__ x,
    float2* __restrict__ y,
    int batch,
    int log_n,
    int log_rows,
    int conj,
    float scale) {
  extern __shared__ float2 smem[];
  const int n = 1 << log_n;
  const int P = n << log_rows;
  float2* buf = smem;
  float2* rom = smem + P;
  build_rom(rom, n >> 1, n);
  const long long base = static_cast<long long>(blockIdx.x) * P;
  const long long total = static_cast<long long>(batch) * n;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const long long g = base + i;
    float2 v = g < total ? x[g] : make_float2(0.f, 0.f);
    buf[i] = conj ? cconj(v) : v;
  }
  __syncthreads();
  const Lines lines{buf, log_n, log_rows, n, 1, false};
  stockham_panel<RADIX>(lines, rom, log_n);
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const long long g = base + i;
    if (g < total) {
      const float2 v = buf[i];
      y[g] = make_float2(v.x * scale, (conj ? -v.y : v.y) * scale);
    }
  }
}

// x: (B, 2m) reals read as (B, m) packed complex; y: (B, m+1) complex.
template <int RADIX>
__global__ void __launch_bounds__(kMaxThreads)
rfft_fused_kernel(const float2* __restrict__ x,
    float2* __restrict__ y,
    int batch,
    int log_m,
    int log_rows) {
  extern __shared__ float2 smem[];
  const int m = 1 << log_m;
  const int P = m << log_rows;
  float2* buf = smem;
  float2* rom = smem + P;  // W_{2m}^j, j <= m: the panel's and the recombination's
  build_rom(rom, m + 1, 2 * m);
  const long long base = static_cast<long long>(blockIdx.x) * P;
  const long long total = static_cast<long long>(batch) * m;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const long long g = base + i;
    buf[i] = g < total ? x[g] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  const Lines lines{buf, log_m, log_rows, m, 1, false};
  stockham_panel<RADIX>(lines, rom, log_m + 1);
  const int out_w = m + 1;
  const long long row0 = static_cast<long long>(blockIdx.x) << log_rows;
  for (int i = threadIdx.x; i < (out_w << log_rows); i += blockDim.x) {
    const int line = i / out_w;
    const int k = i - line * out_w;
    if (row0 + line < batch) {
      y[(row0 + line) * out_w + k] = rfft_recombine(buf + line * m, m, k, rom[k]);
    }
  }
}

// x: (B, m+1) complex half spectra; y: (B, 2m) reals written as (B, m)
// packed complex. The inverse half-size transform runs on the forward
// panel by conjugation and is scaled by 1/m.
template <int RADIX>
__global__ void __launch_bounds__(kMaxThreads)
irfft_fused_kernel(const float2* __restrict__ x,
    float2* __restrict__ y,
    int batch,
    int log_m,
    int log_rows) {
  extern __shared__ float2 smem[];
  const int m = 1 << log_m;
  const int P = m << log_rows;
  float2* buf = smem;
  float2* rom = smem + P;  // W_{2m}^j, j < m
  build_rom(rom, m, 2 * m);
  __syncthreads();
  const long long row0 = static_cast<long long>(blockIdx.x) << log_rows;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const int line = i >> log_m;
    const int k = i & (m - 1);
    float2 v = make_float2(0.f, 0.f);
    if (row0 + line < batch) {
      const float2* half = x + (row0 + line) * (m + 1);
      float2 yk = half[k];
      float2 ym = half[m - k];
      if (k == 0) {  // DC and Nyquist bins of a Hermitian spectrum are real
        yk.y = 0.f;
        ym.y = 0.f;
      }
      v = cconj(irfft_untangle(yk, cconj(ym), cconj(rom[k])));
    }
    buf[i] = v;
  }
  __syncthreads();
  const Lines lines{buf, log_m, log_rows, m, 1, false};
  stockham_panel<RADIX>(lines, rom, log_m + 1);
  const float inv = 1.0f / static_cast<float>(m);
  const long long base = row0 * m;
  const long long total = static_cast<long long>(batch) * m;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    if (base + i < total) {
      const float2 v = buf[i];
      y[base + i] = make_float2(v.x * inv, -v.y * inv);
    }
  }
}

}  // namespace
}  // namespace repro

using repro::geometry_ok;
using repro::host_log2;
using repro::is_pow2;

extern "C" int repro_fft_fused(const void* x, void* y, int batch, int n, int radix, int rows,
                               int threads, int smem, int conj, float scale, int device,
                               void* stream) {
  if (batch < 1 || n < 2 || !is_pow2(n) || !is_pow2(rows) || (radix != 2 && radix != 4))
    return cudaErrorInvalidValue;
  if (!geometry_ok(n * rows, threads, smem, n / 2)) return cudaErrorInvalidConfiguration;
  auto kernel = radix == 4 ? repro::fft_fused_kernel<4> : repro::fft_fused_kernel<2>;
  cudaError_t err = repro::prepare(kernel, device, smem);
  if (err != cudaSuccess) return err;
  const int grid = (batch + rows - 1) / rows;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), batch, host_log2(n),
      host_log2(rows), conj, scale);
  return cudaGetLastError();
}

extern "C" int repro_rfft_fused(const void* x, void* y, int batch, int n, int radix, int rows,
                                int threads, int smem, int device, void* stream) {
  if (batch < 1 || n < 2 || !is_pow2(n) || !is_pow2(rows) || (radix != 2 && radix != 4))
    return cudaErrorInvalidValue;
  const int m = n / 2;
  if (!geometry_ok(m * rows, threads, smem, m + 1)) return cudaErrorInvalidConfiguration;
  auto kernel = radix == 4 ? repro::rfft_fused_kernel<4> : repro::rfft_fused_kernel<2>;
  cudaError_t err = repro::prepare(kernel, device, smem);
  if (err != cudaSuccess) return err;
  const int grid = (batch + rows - 1) / rows;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), batch, host_log2(m),
      host_log2(rows));
  return cudaGetLastError();
}

extern "C" int repro_irfft_fused(const void* x, void* y, int batch, int n, int radix, int rows,
                                 int threads, int smem, int device, void* stream) {
  if (batch < 1 || n < 2 || !is_pow2(n) || !is_pow2(rows) || (radix != 2 && radix != 4))
    return cudaErrorInvalidValue;
  const int m = n / 2;
  if (!geometry_ok(m * rows, threads, smem, m)) return cudaErrorInvalidConfiguration;
  auto kernel = radix == 4 ? repro::irfft_fused_kernel<4> : repro::irfft_fused_kernel<2>;
  cudaError_t err = repro::prepare(kernel, device, smem);
  if (err != cudaSuccess) return err;
  const int grid = (batch + rows - 1) / rows;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), batch, host_log2(m),
      host_log2(rows));
  return cudaGetLastError();
}
