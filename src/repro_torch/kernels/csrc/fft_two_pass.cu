// Two-pass (four-step) FFT kernels: fft_fused, rfft_fused and irfft_fused
// at radix 2 on rows longer than one block holds (2^14 < N <= 2^18): the
// radix-2 `fused` engine's route, which the planner also takes where the
// card holds no cluster of fft_cluster.cu, the radix-4 route of the same
// rows.
//
// Replaces, over the rows one block cannot hold
// (src/repro/kernels/fft_radix2.py):
//   fft_fused   (:279, pallas_call at :299)  complex (B, N) -> (B, N)
//   rfft_fused  (:319, pallas_call at :340)  real (B, N) -> (B, N/2+1)
//   irfft_fused (:358, pallas_call at :379)  (B, N/2+1) -> real (B, N)
// The Pallas kernels hold a whole row of up to 2^18 values in VMEM. A
// Hopper block holds at most 227 KB: 2^14 complex values and their ROM,
// the rows fft_fused.cu serves.
//
// Bound on an H100: HBM bytes, as for fft_fused.cu. The reference reads
// and writes each row once. This design moves a complex row twice (x ->
// scratch -> out) and a real row three times (an elementwise recombination
// or untangling pass on top), so its floor is two or three times the
// one-trip bound. fft_cluster.cu keeps the row on chip across both steps
// (thread-block clusters with distributed shared memory): one trip.
//
// Design: a row of N = n1 * n2 values is an (n1, n2) matrix x[j1, j2], and
//   X[k1 + n1 k2] = sum_j2 W_n2^(j2 k2) W_N^(j2 k1) sum_j1 W_n1^(j1 k1) x[j1, j2].
// Column pass: a block takes `cols` neighbouring columns of one row and
// loads them as runs of `cols` float2 (coalesced), runs the Stockham panel
// down the columns (the column mode of fft2_fused.cu: line stride 1,
// element stride cols), multiplies element (k1, j2) by W_N^(j2 k1) and
// stores it to the scratch in the same layout. The exponent p = j2 k1 < N
// is an exact integer and -2p/N is exact in float32 (p < 2^24), so
// sincospif gives each twiddle to the last bit, with nothing carried from
// one element to the next.
// Row pass: a block takes `rows` neighbouring rows k1 of the scratch (one
// contiguous run), runs the panel along each, and writes out[k2 n1 + k1]:
// the `rows` values of one k2 are neighbours in the output, so the
// transposed store coalesces. Each line is padded by one value in shared
// memory, so that the transposed read has no bank conflicts.
// An inverse conjugates on the way into the column pass and on the way out
// of the row pass, scaling by 1/N: no extra pass over HBM.
// The real kinds run both passes at m = N/2 on the packed row (the N reals
// read as N/2 complex values, as fft_fused.cu does), with an elementwise
// recombination after them (rfft) or an untangling before them (irfft).
#include <climits>

#include <cuda_runtime.h>

#include "stockham.cuh"

namespace repro {
namespace {

constexpr int kElementwiseThreads = 256;

// x, y: (B, n1, n2). y[k1, j2] = W_N^(j2 k1) sum_j1 W_n1^(j1 k1) conj_in(x)[j1, j2].
template <int RADIX>
__global__ void __launch_bounds__(kMaxThreads)
two_pass_columns_kernel(const float2* __restrict__ x,
    float2* __restrict__ y,
    int log_n1,
    int log_n2,
    int log_cols,
    int conj) {
  extern __shared__ float2 smem[];
  const int cols = 1 << log_cols;
  const int P = 1 << (log_n1 + log_cols);
  float2* buf = smem;  // buf[j1 * cols + t]: column c0 + t
  float2* rom = smem + P;  // W_n1^j, j < n1/2
  build_rom(rom, 1 << (log_n1 - 1), 1 << log_n1);
  const int log_tiles = log_n2 - log_cols;
  const long long row = blockIdx.x >> log_tiles;
  const int c0 = static_cast<int>(blockIdx.x & ((1u << log_tiles) - 1)) << log_cols;
  const long long offset = (row << (log_n1 + log_n2)) + c0;
  const float2* src = x + offset;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const float2 v = src[(static_cast<long long>(i >> log_cols) << log_n2) + (i & (cols - 1))];
    buf[i] = conj ? cconj(v) : v;
  }
  __syncthreads();
  const Lines lines{buf, log_n1, log_cols, 1, cols, true};
  stockham_panel<RADIX>(lines, rom, log_n1);
  const float inv_half_n = 1.0f / static_cast<float>(1 << (log_n1 + log_n2 - 1));
  float2* dst = y + offset;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const int k1 = i >> log_cols;
    const int t = i & (cols - 1);
    float s, c;
    sincospif(-static_cast<float>((c0 + t) * k1) * inv_half_n, &s, &c);
    dst[(static_cast<long long>(k1) << log_n2) + t] = cmul(buf[i], make_float2(c, s));
  }
}

// x: (B, n1, n2) from the column pass; y: (B, N) with
// y[k2 n1 + k1] = conj_out(sum_j2 W_n2^(j2 k2) x[k1, j2]) * scale.
template <int RADIX>
__global__ void __launch_bounds__(kMaxThreads)
two_pass_rows_kernel(const float2* __restrict__ x,
    float2* __restrict__ y,
    int log_n1,
    int log_n2,
    int log_rows,
    int conj,
    float scale) {
  extern __shared__ float2 smem[];
  const int n2 = 1 << log_n2;
  const int rows = 1 << log_rows;
  const int stride = n2 + 1;
  const int P = rows << log_n2;
  float2* buf = smem;  // buf[r * stride + j2]: row k0 + r
  float2* rom = smem + rows * stride;  // W_n2^j, j < n2/2
  build_rom(rom, n2 >> 1, n2);
  const int log_tiles = log_n1 - log_rows;
  const long long row = blockIdx.x >> log_tiles;
  const int k0 = static_cast<int>(blockIdx.x & ((1u << log_tiles) - 1)) << log_rows;
  const long long base = row << (log_n1 + log_n2);
  const float2* src = x + base + (static_cast<long long>(k0) << log_n2);
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    buf[(i >> log_n2) * stride + (i & (n2 - 1))] = src[i];
  }
  __syncthreads();
  const Lines lines{buf, log_n2, log_rows, stride, 1, false};
  stockham_panel<RADIX>(lines, rom, log_n2);
  float2* dst = y + base + k0;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const int r = i & (rows - 1);
    const int k2 = i >> log_rows;
    const float2 v = buf[r * stride + k2];
    dst[(static_cast<long long>(k2) << log_n1) + r] =
        make_float2(v.x * scale, (conj ? -v.y : v.y) * scale);
  }
}

// rfft: y (B, m+1) from z (B, m), the half-size spectra of the packed rows.
// The twiddle W_2m^k is the one build_rom gives fft_fused.cu's rfft.
__global__ void __launch_bounds__(kElementwiseThreads)
two_pass_recombine_kernel(const float2* __restrict__ z,
    float2* __restrict__ y,
    int log_m,
    int blocks_per_row) {
  const int m = 1 << log_m;
  const long long row = blockIdx.x / blocks_per_row;
  const int k = static_cast<int>(blockIdx.x - row * blocks_per_row) * blockDim.x + threadIdx.x;
  if (k > m) return;
  float s, c;
  sincospif(-static_cast<float>(k) / static_cast<float>(m), &s, &c);
  y[row * (m + 1) + k] = rfft_recombine(z + (row << log_m), m, k, make_float2(c, s));
}

// irfft: z (B, m), the packed half-size rows whose inverse transform scaled
// by 1/m is the real output, from the half spectra x (B, m+1). The
// imaginary parts at DC and Nyquist are dropped, as fft_fused.cu does.
__global__ void __launch_bounds__(kElementwiseThreads)
two_pass_untangle_kernel(const float2* __restrict__ x,
    float2* __restrict__ z,
    int log_m,
    int blocks_per_row) {
  const int m = 1 << log_m;
  const long long row = blockIdx.x / blocks_per_row;
  const int k = static_cast<int>(blockIdx.x - row * blocks_per_row) * blockDim.x + threadIdx.x;
  if (k >= m) return;
  const float2* half = x + row * (m + 1);
  float2 yk = half[k];
  float2 ym = half[m - k];
  if (k == 0) {
    yk.y = 0.f;
    ym.y = 0.f;
  }
  float s, c;
  sincospif(-static_cast<float>(k) / static_cast<float>(m), &s, &c);
  z[(row << log_m) + k] = irfft_untangle(yk, cconj(ym), make_float2(c, -s));
}

// The two passes' common checks: power-of-two sides, N < 2^24 (exact
// twiddle exponents), and a grid of at most INT_MAX blocks.
bool two_pass_ok(int batch, int n1, int n2, int lines, int side, int radix, long long* blocks) {
  if (batch < 1 || n1 < 2 || n2 < 2 || !is_pow2(n1) || !is_pow2(n2) || !is_pow2(lines) ||
      lines > side || (radix != 2 && radix != 4) ||
      static_cast<long long>(n1) * n2 >= (1LL << 24))
    return false;
  *blocks = static_cast<long long>(batch) * (side / lines);
  return *blocks <= INT_MAX;
}

}  // namespace
}  // namespace repro

using repro::geometry_ok;
using repro::host_log2;
using repro::is_pow2;

extern "C" int repro_two_pass_columns(const void* x, void* y, int batch, int n1, int n2,
                                      int radix, int cols, int threads, int smem, int conj,
                                      int device, void* stream) {
  long long blocks = 0;
  if (!repro::two_pass_ok(batch, n1, n2, cols, n2, radix, &blocks)) return cudaErrorInvalidValue;
  if (!geometry_ok(n1 * cols, threads, smem, n1 / 2)) return cudaErrorInvalidConfiguration;
  auto kernel =
      radix == 4 ? repro::two_pass_columns_kernel<4> : repro::two_pass_columns_kernel<2>;
  cudaError_t err = repro::prepare(kernel, device, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), host_log2(n1), host_log2(n2),
      host_log2(cols), conj);
  return cudaGetLastError();
}

extern "C" int repro_two_pass_rows(const void* x, void* y, int batch, int n1, int n2, int radix,
                                   int rows, int threads, int smem, int conj, float scale,
                                   int device, void* stream) {
  long long blocks = 0;
  if (!repro::two_pass_ok(batch, n1, n2, rows, n1, radix, &blocks)) return cudaErrorInvalidValue;
  // The padding (one value per line) counts with the ROM.
  if (!geometry_ok(rows * n2, threads, smem, n2 / 2 + rows)) return cudaErrorInvalidConfiguration;
  auto kernel = radix == 4 ? repro::two_pass_rows_kernel<4> : repro::two_pass_rows_kernel<2>;
  cudaError_t err = repro::prepare(kernel, device, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), host_log2(n1), host_log2(n2),
      host_log2(rows), conj, scale);
  return cudaGetLastError();
}

namespace {

// Launch an elementwise pass over `per_row` values of each of `batch` rows.
template <typename Kernel>
int launch_elementwise(Kernel kernel, const void* x, void* y, int batch, int m, int per_row,
                       int device, void* stream) {
  if (batch < 1 || m < 1 || !is_pow2(m) || m >= (1 << 24)) return cudaErrorInvalidValue;
  const int blocks_per_row = (per_row + repro::kElementwiseThreads - 1) /
                             repro::kElementwiseThreads;
  const long long blocks = static_cast<long long>(batch) * blocks_per_row;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), repro::kElementwiseThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(static_cast<const float2*>(x),
                                                static_cast<float2*>(y), host_log2(m),
                                                blocks_per_row);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_two_pass_recombine(const void* z, void* y, int batch, int m, int device,
                                        void* stream) {
  return launch_elementwise(repro::two_pass_recombine_kernel, z, y, batch, m, m + 1, device,
                            stream);
}

extern "C" int repro_two_pass_untangle(const void* x, void* z, int batch, int m, int device,
                                       void* stream) {
  return launch_elementwise(repro::two_pass_untangle_kernel, x, z, batch, m, m, device, stream);
}
