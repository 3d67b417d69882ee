// Two-pass (four-step) FFT kernels: fft_fused, rfft_fused and irfft_fused
// at radix 2 on rows longer than one block holds (2^14 < N <= 2^24): the
// radix-2 `fused` engine's route, which the planner also takes where the
// card holds no cluster of fft_cluster.cu, the radix-4 route of rows up to
// 2^18; past 2^18 the route of both engines.
//
// Replaces, over the rows one block cannot hold
// (src/repro/kernels/fft_radix2.py):
//   fft_fused   (:279, pallas_call at :299)  complex (B, N) -> (B, N)
//   rfft_fused  (:319, pallas_call at :340)  real (B, N) -> (B, N/2+1)
//   irfft_fused (:358, pallas_call at :379)  (B, N/2+1) -> real (B, N)
// The Pallas kernels hold a whole row of up to 2^18 values in VMEM; the
// reference plans its jnp schedules for longer rows. A Hopper block holds
// at most 227 KB: 2^14 complex values and their ROM, the rows fft_fused.cu
// serves.
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
// Both passes run the register passes of stockham_regs.cuh with radix-2
// layers (r2_layers: four Stockham stages in registers per exchange through
// shared memory, 16 values a thread), as the radix-2 fft_fused does.
// Column pass: a block takes a panel of C neighbouring columns of one row's
// view, as fft2_columns.cu takes a panel of a frame (frame_panel<true>,
// consecutive threads on consecutive columns): the first pass loads runs of
// C values (row stride n2; C = 16 or more up to n1 = 1024, 128 bytes or
// more, then 8 and 4, whole 32-byte sectors, at 16384 values and 1024
// threads a block) from HBM straight into registers, the middle
// passes exchange through the padded frame layout, and the last multiplies
// element (k1, j2) by W_N^(j2 k1) in registers and stores it straight to the
// scratch in the same layout. The exponent p = j2 k1 < N is an exact
// integer and -2p/N is exact in float32 (p <= (n1 - 1)(n2 - 1) < 2^24 for
// N <= 2^24, and p over a power of two), so sincospif gives each twiddle to
// the last bit, with nothing carried from one element to the next.
// Row pass: the scratch's rows k1 hold n2 contiguous values, but the output
// is out[k2 n1 + k1], so the corner turn is addressing, as in the paper's
// RAM controller. A block takes a tile of T neighbouring rows k1 (one
// contiguous run; T sized as C is). Its first pass loads them coalesced,
// consecutive threads on consecutive groups of a row; every later pass puts
// consecutive threads on consecutive rows (Lanes<true> over the tile's
// rows), so that the last stores from registers runs of T consecutive k1
// (HbmFrameOut<true> with row stride n1). The tile's rows sit S slots
// apart, each padded inside (value i at slot(i)): the first pass's
// stride-16 writes spread as in the one-block kernels. A later pass's
// half-warp takes min(16, T) consecutive rows at 16/T consecutive groups:
// with S = padded(n2) + 1 (T >= 16) 16 rows fall on 16 bank pairs because
// S is odd; with S = padded(n2) + 16/T (T = 8, 4 at n2 = 2048, 4096, where
// padded(n2) is a multiple of 16) row r and group t fall on bank pair
// r 16/T + t. A row of 128 values holds 8 groups, so the first pass's
// half-warp takes rows q and q + 8, whose slots differ by 8 S = 8 (mod 16)
// bank pairs (tests/test_torch_two_pass_regpass.py holds a numpy model of
// every access of every instance).
// An inverse conjugates on the way into the column pass and on the way out
// of the row pass, scaling by 1/N: no extra pass over HBM.
// The real kinds run both passes at m = N/2 on the packed row (the N reals
// read as N/2 complex values, as fft_fused.cu does), with an elementwise
// recombination after them (rfft) or an untangling before them (irfft).
// One instance of each pass a line length the census launches (n1, n2 =
// 128 ... 4096 and their panel and tile widths), so every stride but the
// other side's is compile-time. Offsets inside a row (below 2^24) are
// 32-bit, unsigned where shifted (good to 2^32); row bases are long long,
// so a batch may hold more than 2^31 values.
#include <climits>

#include <cuda_runtime.h>

#include "fft_common.cuh"
#include "stockham_regs.cuh"

namespace repro {
namespace {

constexpr int kElementwiseThreads = 256;

// The column pass's scratch, written by its last pass: element k1 = pos +
// c l of panel column `line` (j2 = c0 + line) times W_N^(j2 k1), at
// y[k1 n2 + j2] (y points at the row's scratch). 32-bit offsets: a row
// holds at most 2^24 values, and the shifts are unsigned.
struct TwiddledColumns {
  static constexpr bool kShared = false;
  float2* y;
  int log_n2;
  int c0;
  float inv_half_n;  // 2/N

  template <int R>
  __device__ __forceinline__ void write(int line, int pos, int l, const float2* v, bool ok) const {
    if (!ok) return;
    const int j2 = c0 + line;
    float2* p = y + ((static_cast<unsigned>(pos) << log_n2) + j2);
#pragma unroll
    for (int c = 0; c < R; ++c) {
      float s, co;
      sincospif(-static_cast<float>(j2 * (pos + c * l)) * inv_half_n, &s, &co);
      p[static_cast<unsigned>(c * l) << log_n2] = cmul(v[regs::out_reg<R>(c)], make_float2(co, s));
    }
  }
};

// x, y: (B, n1, n2). y[k1, j2] = W_N^(j2 k1) sum_j1 W_n1^(j1 k1) conj_in(x)[j1, j2].
// Shared memory: the padded panel of C = 2^LOG_C columns of n1 = 2^LOG_N1,
// then the padded ROM of n1/2 twiddles W_n1^j.
template <int LOG_N1, int LOG_C>
__global__ void __launch_bounds__(kMaxThreads)
two_pass_columns_kernel(const float2* __restrict__ x,
    float2* __restrict__ y,
    int log_n2,
    int conj) {
  extern __shared__ float2 smem[];
  constexpr int P = 1 << (LOG_N1 + LOG_C);
  constexpr int kLogHalf = LOG_N1 - 1;
  float2* rom = smem + regs::padded(P);
  regs::build_rom(rom, 1 << kLogHalf);
  const int log_tiles = log_n2 - LOG_C;
  const long long row = blockIdx.x >> log_tiles;
  const int c0 = static_cast<int>(blockIdx.x & ((1u << log_tiles) - 1)) << LOG_C;
  const long long base = row << (LOG_N1 + log_n2);
  const float inv_half_n = 1.0f / static_cast<float>(1 << (LOG_N1 + log_n2 - 1));
  regs::frame_panel<true, 2>(
      smem, P, LOG_C, LOG_N1, kLogHalf, rom,
      regs::HbmColumns{x + base, nullptr, 1 << log_n2, c0, conj ? -1.f : 1.f, 1.f, 1.f},
      TwiddledColumns{y + base, log_n2, c0, inv_half_n});
}

// The row tile in shared memory: element i of tile row `line` at
// line S + slot(i) (S: two_pass_stride below). Every run a pass reads or
// writes has stride 1 inside an aligned group of 16 (a first pass's
// writes) or a multiple of 16 (every later access of a row of more than 16
// values), so its slots are uniform.
struct SmemTile {
  static constexpr bool kShared = true;
  float2* buf;
  int stride;  // S

  template <int R, class F>
  __device__ __forceinline__ void run(int line, int i, int step, F f) const {
    float2* p = buf + line * stride + regs::slot(i);
    const int ps = step == 1 ? 1 : regs::padded(step);
#pragma unroll
    for (int j = 0; j < R; ++j) f(j, p + j * ps);
  }

  template <int R>
  __device__ __forceinline__ void read(int line, int t, int s, float2* v, bool ok) const {
    if (!ok) line = t = 0;
    run<R>(line, t, s, [&](int j, const float2* p) { v[j] = *p; });
  }

  template <int R>
  __device__ __forceinline__ void write(int line, int pos, int l, const float2* v, bool ok) const {
    if (!ok) return;
    run<R>(line, pos, l, [&](int c, float2* p) { *p = v[regs::out_reg<R>(c)]; });
  }
};

// The row pass's first pass: consecutive threads on consecutive groups t of
// a tile row (Lanes<false>: coalesced loads). Where a row holds 8 groups
// (n2 = 128) a half-warp covers two rows, and takes q and q + 8 (bits 0 and
// 3 of the row swapped): their slots differ by 8 S, so the two halves'
// writes fall on the two halves of the bank pairs.
struct FirstRowLanes {
  __device__ __forceinline__ void split(int g, int log_s, int& line, int& t) const {
    t = g & ((1 << log_s) - 1);
    const int q = g >> log_s;
    line = log_s == 3 ? (q & ~9) | ((q & 1) << 3) | ((q >> 3) & 1) : q;
  }
};

// Slots between neighbouring rows of a tile of 2^log_t rows of n2 values
// (two_pass_row_stride in repro_torch/kernels/fft_radix2.py): the padded row
// and one more from 16 rows on, else the padded row and 16/T more.
__host__ __device__ constexpr int two_pass_stride(int n2, int log_t) {
  return regs::padded(n2) + (log_t >= 4 ? 1 : 16 >> log_t);
}

// x: (B, n1, n2) from the column pass; y: (B, N) with
// y[k2 n1 + k1] = conj_out(sum_j2 W_n2^(j2 k2) x[k1, j2]) * scale.
// A tile of T = 2^LOG_T rows of n2 = 2^LOG_N2; shared memory: the tile (T
// S slots), then the padded ROM of n2/2 twiddles W_n2^j.
template <int LOG_N2, int LOG_T>
__global__ void __launch_bounds__(kMaxThreads)
two_pass_rows_kernel(const float2* __restrict__ x,
    float2* __restrict__ y,
    int log_n1,
    int conj,
    float scale) {
  static_assert(LOG_N2 > 4, "rows of two passes or more");
  static_assert(LOG_T >= 4 || LOG_N2 >= 8, "a tile under 16 rows needs S - 1 a multiple of 16");
  extern __shared__ float2 smem[];
  constexpr int P = 1 << (LOG_T + LOG_N2);
  constexpr int kStride = two_pass_stride(1 << LOG_N2, LOG_T);
  constexpr int kLogHalf = LOG_N2 - 1;
  constexpr int NP = regs::pass_count(LOG_N2);
  float2* rom = smem + (kStride << LOG_T);
  regs::build_rom(rom, 1 << kLogHalf);
  const int log_tiles = log_n1 - LOG_T;
  const long long row = blockIdx.x >> log_tiles;
  const int k0 = static_cast<int>(blockIdx.x & ((1u << log_tiles) - 1)) << LOG_T;
  const long long base = row << (log_n1 + LOG_N2);
  const SmemTile tile{smem, kStride};
  regs::pass<4, 2>(P, LOG_N2, 0, kLogHalf, FirstRowLanes{}, rom,
                   regs::HbmFrameRows{x + base + (static_cast<long long>(k0) << LOG_N2), LOG_N2,
                                      1.f},
                   tile);
  __syncthreads();
  const regs::Lanes<true> rows{LOG_T};
#pragma unroll
  for (int p = 1; p < NP - 1; ++p) {
    regs::pass<4, 2>(P, LOG_N2, 4 * p, kLogHalf, rows, rom, tile, tile);
    __syncthreads();
  }
  regs::pass<regs::last_log_radix(LOG_N2), 2>(
      P, LOG_N2, 4 * (NP - 1), kLogHalf, rows, rom, tile,
      regs::HbmFrameOut<true>{y + base + k0, log_n1, scale, conj ? -scale : scale});
}

using ColumnsKernel = void (*)(const float2*, float2*, int, int);
using RowsKernel = void (*)(const float2*, float2*, int, int, float);

// The instances of the census (two_pass_geometry in
// repro_torch/kernels/fft_radix2.py): C = 32 columns of 128, 16 of 256 to
// 1024, 8 of 2048 and 4 of 4096; T rows of n2 the same. Null off the census.
ColumnsKernel columns_instance(int log_n1, int log_c) {
  if (log_n1 == 7 && log_c == 5) return two_pass_columns_kernel<7, 5>;
  if (log_n1 == 8 && log_c == 4) return two_pass_columns_kernel<8, 4>;
  if (log_n1 == 9 && log_c == 4) return two_pass_columns_kernel<9, 4>;
  if (log_n1 == 10 && log_c == 4) return two_pass_columns_kernel<10, 4>;
  if (log_n1 == 11 && log_c == 3) return two_pass_columns_kernel<11, 3>;
  if (log_n1 == 12 && log_c == 2) return two_pass_columns_kernel<12, 2>;
  return nullptr;
}

RowsKernel rows_instance(int log_n2, int log_t) {
  if (log_n2 == 7 && log_t == 5) return two_pass_rows_kernel<7, 5>;
  if (log_n2 == 8 && log_t == 4) return two_pass_rows_kernel<8, 4>;
  if (log_n2 == 9 && log_t == 4) return two_pass_rows_kernel<9, 4>;
  if (log_n2 == 10 && log_t == 4) return two_pass_rows_kernel<10, 4>;
  if (log_n2 == 11 && log_t == 3) return two_pass_rows_kernel<11, 3>;
  if (log_n2 == 12 && log_t == 2) return two_pass_rows_kernel<12, 2>;
  return nullptr;
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

// The two passes' common checks: power-of-two sides, N <= 2^24 (exact
// twiddle exponents: p <= (n1 - 1)(n2 - 1) < 2^24, and -2p/N is p over a
// power of two), and a grid of at most INT_MAX blocks.
bool two_pass_ok(int batch, int n1, int n2, int lines, int side, long long* blocks) {
  if (batch < 1 || n1 < 2 || n2 < 2 || !is_pow2(n1) || !is_pow2(n2) || !is_pow2(lines) ||
      lines > side || static_cast<long long>(n1) * n2 > (1LL << 24))
    return false;
  *blocks = static_cast<long long>(batch) * (side / lines);
  return *blocks <= INT_MAX;
}

}  // namespace
}  // namespace repro

using repro::host_log2;
using repro::is_pow2;

extern "C" int repro_two_pass_columns(const void* x, void* y, int batch, int n1, int n2, int cols,
                                      int threads, int smem, int conj, int device, void* stream) {
  long long blocks = 0;
  if (!repro::two_pass_ok(batch, n1, n2, cols, n2, &blocks)) return cudaErrorInvalidValue;
  const auto kernel = repro::columns_instance(host_log2(n1), host_log2(cols));
  if (kernel == nullptr) return cudaErrorInvalidValue;
  if (!repro::regs::geometry_ok(n1 * cols, threads, smem, n1 / 2))
    return cudaErrorInvalidConfiguration;
  cudaError_t err = repro::prepare(kernel, device, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), host_log2(n2), conj);
  return cudaGetLastError();
}

extern "C" int repro_two_pass_rows(const void* x, void* y, int batch, int n1, int n2, int rows,
                                   int threads, int smem, int conj, float scale, int device,
                                   void* stream) {
  long long blocks = 0;
  if (!repro::two_pass_ok(batch, n1, n2, rows, n1, &blocks)) return cudaErrorInvalidValue;
  const auto kernel = repro::rows_instance(host_log2(n2), host_log2(rows));
  if (kernel == nullptr) return cudaErrorInvalidValue;
  // The tile's rows S slots apart, then the padded ROM.
  const int need = (rows * repro::two_pass_stride(n2, host_log2(rows)) +
                    repro::regs::padded(n2 / 2)) *
                   static_cast<int>(sizeof(float2));
  if (smem < need || !repro::geometry_ok(rows * n2, threads, need, 0))
    return cudaErrorInvalidConfiguration;
  cudaError_t err = repro::prepare(kernel, device, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), host_log2(n1), conj, scale);
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
