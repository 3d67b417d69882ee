// Whole-frame real 2D FFT kernels: rfft2_fused and irfft2_fused.
//
// Replaces (src/repro/kernels/fft_radix2.py):
//   rfft2_fused  (:452, pallas_call at :461)  real (F, H, W) -> (F, H, W/2+1)
//   irfft2_fused (:486, pallas_call at :496)  (F, H, W/2+1) -> real (F, H, W)
//
// Bound on an H100: HBM bytes, 4 per real sample and 8 per spectrum bin,
// each read or written once; the arithmetic is about half that of the
// complex frame, far below the float32 rate per byte.
//
// Design: one block per frame, held in dynamic shared memory as H rows of
// m = W/2 packed complex values (the even/odd pack of each real row is a
// reinterpretation of the input, not a copy): at most 16384 values, so a
// 128x256 real frame. The half spectrum has m+1 columns, one more than the
// block holds; the two real-valued columns, DC and Nyquist, therefore
// share slot 0 of each row as DC + i Nyquist. With that the column panel
// runs on m columns, a power of two, and a two-for-one split of column 0
// (forward) or a Hermitian pre-pack of columns 0 and m (inverse) recovers
// both. Frames that do not fit take the row / HBM turn / column composition
// (repro_torch/kernels/ops.py).
//
// rfft2_fused: the register passes of stockham_regs.cuh (frame_panel), as
// fft2_fused.cu runs them, two radix-4 layers (RADIX 4) or four radix-2
// Stockham stages (RADIX 2, r2_layers) in registers per exchange. The row
// panel loads the packed rows straight from HBM into registers and leaves
// each row's half-size spectrum Z in shared memory. The column panel's
// first pass recombines on its way in: column c (consecutive threads take consecutive columns) reads
// Z[r][c] and the mirror Z[r][m-c], descending runs as free of bank
// conflicts as the ascending ones, and makes Y[r][c] = Xe + W_W^c Xo, slot 0
// DC + i Nyquist; so the recombination costs one more read per value and no
// exchange or barrier of its own. The last column pass stores straight from
// registers to HBM (rows of m+1 bins: consecutive columns of a row are one
// run), column 0 still packed. Column 0 needs rows r and H-r together,
// which the last pass leaves in two threads: after one barrier, one thread
// per row pair reads both back from the output (L2, H values a frame) and
// writes the DC and Nyquist columns over it. A 128x128 frame: rows 16·4,
// columns 16·8, three exchanges and six barriers, where the stage-at-a-time
// panel and its in-place recombination took about twelve round trips. At
// most 64 registers a thread, so two blocks of 512 threads (a 128x128
// frame, 69 KiB) share an SM. One instance a radix serves every frame of
// the census with a runtime geometry; the 128x128 frame that chip_smoke
// times also has an instance of its own at each radix. The recombination
// takes its twiddles from sincospif (regs::w_2m) at either radix, and the
// column-0 split takes none.
//
// irfft2_fused: the same passes in the reverse order, at either radix. The
// column panel's first pass loads the half spectrum straight from HBM,
// conjugated, its column-0 lanes packing the Hermitian parts of the DC and
// Nyquist columns as A + iB (four independent loads a row, no barrier); its
// last pass leaves the frame in shared memory. The row panel's first pass
// untangles on its way in (Y[k] and its mirror Y[m-k] from the frame, slot 0
// DC + i Nyquist), so the untangle costs one more read per value and no
// exchange or barrier of its own, and its last pass stores the packed reals
// straight to HBM, conjugated and scaled by 1/(H m). A 128x128 frame:
// columns 16·8, rows 16·4, three exchanges and five barriers. Neither the
// pack nor the untangle takes a twiddle from the radix (the untangle's are
// sincospif's, regs::w_2m), so the radix-2 kernel differs from the radix-4
// one only in its passes' layers.
#include <cuda_runtime.h>

#include <utility>

#include "stockham_regs.cuh"

namespace repro {
namespace {

// The first column pass of rfft2_fused reads the row panel's
// half spectra Z (m columns) and recombines on the way in: column c of row r
// becomes Y[r][c] = Xe + W_W^c Xo from Z[r][c] and conj Z[r][m-c] (W = 2m),
// column 0 Y[r][0] + i Y[r][m] = (Re + Im) + i (Re - Im) of Z[r][0]. Column
// 0's mirror read goes to column m-1, as column 1's does (one address).
// W_W^c = W_{2m}^c by regs::w_2m, the ROM's entry c max(H, W)/W bit for
// bit, without its bank conflicts on thin frames.
struct RecombinedCols {
  static constexpr bool kShared = true;
  regs::SmemFrame<true> z;

  template <int R>
  __device__ __forceinline__ void read(int c, int t, int s, float2* v, bool ok) const {
    if (!ok) c = t = 0;
    const int m = 1 << z.log_w;
    const float2 w = regs::w_2m(c, m);
    const bool dc = c == 0;
    z.run<R>(c, t, s, [&](int j, const float2* p) { v[j] = *p; });
    z.run<R>(m - max(c, 1), t, s, [&](int j, const float2* p) {
      const float2 a = v[j];
      const float2 y = regs::recombine(a, cconj(*p), w);
      v[j] = dc ? make_float2(a.x + a.y, a.x - a.y) : y;
    });
  }
};

// The last column pass's output: column c of row r at y[r (m+1) + c], column
// 0 still packed (Z = A + iB) until the split.
struct RfftCols {
  static constexpr bool kShared = false;
  float2* y;
  int stride;  // m + 1

  template <int R>
  __device__ __forceinline__ void write(int c, int pos, int l, const float2* v, bool ok) const {
    if (!ok) return;
    float2* p = y + static_cast<unsigned>(pos * stride + c);
#pragma unroll
    for (int k = 0; k < R; ++k) p[static_cast<unsigned>(k * l * stride)] = v[regs::out_reg<R>(k)];
  }
};

// rfft2_fused on the register passes, their layers of radix RADIX. x: (F,
// H, 2m) reals read as (F, H, m) packed complex; y: (F, H, m+1). ROM: W_n^j,
// j < n/2, at n = max(H, W), padded, after the padded frame: both panels'
// twiddles (the rows' radix-2 stages read it at log_half past log2 m, as
// fft2_fused's do on a frame wider than tall). <0, 0> takes the frame's
// geometry at run time; an instance with LOG_H, LOG_M fixed serves that
// frame with every stride compile-time.
template <int LOG_H, int LOG_M, int RADIX>
__global__ void __launch_bounds__(kMaxThreads)
rfft2_regs_kernel(const float2* __restrict__ x,
    float2* __restrict__ y,
    int log_h_arg,
    int log_m_arg) {
  const int log_h = LOG_H ? LOG_H : log_h_arg;
  const int log_m = LOG_M ? LOG_M : log_m_arg;
  extern __shared__ float2 smem[];
  const int h = 1 << log_h;
  const int m = 1 << log_m;
  const int P = h << log_m;
  const int log_n = log_h > log_m + 1 ? log_h : log_m + 1;
  float2* rom = smem + regs::padded(P);
  regs::build_rom(rom, 1 << (log_n - 1));
  const long long frame = blockIdx.x;
  float2* out = y + frame * h * (m + 1);
  const bool rows_padded = regs::pass_count(log_m) == 1;
  regs::frame_panel<false, RADIX>(smem, P, log_m, log_m, log_n - 1, rom,
                                  regs::HbmFrameRows{x + frame * P, log_m, 1.f},
                                  regs::SmemFrame<false>{smem, log_m, rows_padded});
  __syncthreads();
  regs::frame_panel<true, RADIX>(smem, P, log_m, log_h, log_n - 1, rom,
                                 RecombinedCols{{smem, log_m, rows_padded}},
                                 RfftCols{out, m + 1});
  __syncthreads();

  // Column 0 of the output holds Z = A + iB, A and B the (Hermitian)
  // transforms of the DC and Nyquist columns: A[r] = (Z[r] + conj Z[-r]) / 2
  // goes to column 0, B[r] = -i (Z[r] - conj Z[-r]) / 2 to column m, and
  // A[-r] = conj A[r], B[-r] = conj B[r]. After the barrier, which makes the
  // last pass's stores visible to the block, thread r (r <= H/2) reads rows
  // r and -r back (from L2: H values a frame, one round trip a thread) and
  // writes both rows' DC and Nyquist bins.
  for (int r = threadIdx.x; 2 * r <= h; r += blockDim.x) {
    const int rm = (h - r) & (h - 1);
    float2* o = out + r * (m + 1);
    float2* om = out + rm * (m + 1);
    const float2 z = o[0];
    const float2 zm = cconj(om[0]);
    const float2 d = csub(z, zm);
    const float2 a = make_float2(0.5f * (z.x + zm.x), 0.5f * (z.y + zm.y));
    const float2 b = make_float2(0.5f * d.y, -0.5f * d.x);
    o[0] = a;
    o[m] = b;
    if (rm != r) {
      om[0] = cconj(a);
      om[m] = cconj(b);
    }
  }
}

// The first column pass of irfft2_fused reads the half spectrum
// straight from HBM, conjugated: column c < m of row r at x[r (m+1) + c],
// consecutive threads on consecutive columns (Lanes<true>). Slot 0 packs the
// DC column a and the Nyquist column b as A + iB, A = (a[r] + conj a[-r]) / 2
// and likewise B, their Hermitian parts: the inverse column transform of
// A + iB is Re(ifft a) + i Re(ifft b), which is what the row inverse keeps of
// those two bins. Rows r and -r belong to other groups, so column 0's lane
// (one in m) issues the three more loads each of its rows needs, a[-r], b[r]
// and b[-r], all independent (no walk, no barrier; L2 hits within the
// frame). 32-bit offsets and unpredicated loads, as HbmFrameRows; a group
// past the frame's values (frames under 16 values) reads row 0.
struct HalfSpectrumCols {
  static constexpr bool kShared = false;
  const float2* x;
  int log_h;
  int log_m;

  template <int R>
  __device__ __forceinline__ void read(int c, int t, int s, float2* v, bool ok) const {
    if (!ok) c = t = 0;
    const int m = 1 << log_m;
    const unsigned w = m + 1;
    const float2* p = x + (static_cast<unsigned>(t) * w + c);
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = p[static_cast<unsigned>(j * s) * w];
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = t + j * s;
        const float2* row = x + static_cast<unsigned>(r) * w;
        const float2* mirror = x + static_cast<unsigned>(-r & ((1 << log_h) - 1)) * w;
        const float2 a = v[j], am = mirror[0], b = row[m], bm = mirror[m];
        const float2 A = make_float2(0.5f * (a.x + am.x), 0.5f * (a.y - am.y));
        const float2 B = make_float2(0.5f * (b.x + bm.x), 0.5f * (b.y - bm.y));
        v[j] = make_float2(A.x - B.y, A.y + B.x);
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = cconj(v[j]);
  }
};

// The first row pass of irfft2_fused reads the column panel's
// output C = conj(H ifft over the columns) and untangles on its way in:
// element k of row r becomes regs::untangle(Y[k], Y[m-k], W_W^k), Y = conj C,
// and at k = 0 the packed slot gives Y[0] = Re C[0] (DC) and Y[m] = -Im C[0]
// (Nyquist), both real, as numpy drops their imaginary parts. The mirrors
// m - k of lane t's elements k = t + j s are those of group s - t in reverse
// (R-1-j), read as one run after the lane's own, each untangled as it
// arrives (16 values live). Lane 0's mirrors are its own elements
// (R - j) mod R; it reads group 0 in reverse, whose element R-1-j is the
// mirror of its next j, carried one step. So every lane's mirror reads fall
// on the slots of a forward read where a half-warp spans several rows
// (s < 16: free of bank conflicts in the padded layout), and on 16
// consecutive values one off the aligned 16 where it takes 16 groups of one
// row (free of conflicts in the plain layout); the kernel picks C's layout
// so. W_W^k = W_{2m}^k as in UntangledHalfRows (fft_fused.cu).
struct UntangledRows {
  static constexpr bool kShared = true;
  regs::SmemFrame<false> z;

  template <int R>
  __device__ __forceinline__ void read(int r, int t, int s, float2* v, bool ok) const {
    if (!ok) r = t = 0;
    z.run<R>(r, t, s, [&](int j, const float2* p) { v[j] = *p; });
    const float2 wt = regs::w_2m(t, 1 << z.log_w);
    float2 carry = v[0];
    z.run<R>(r, ((s - t) & (s - 1)) + (R - 1) * s, -s, [&](int j, const float2* p) {
      const float2 c = v[j], cm = *p;
      const float2 mirror = t == 0 ? carry : cm;
      carry = cm;
      if (j == 0) {  // lane 0: k = 0, the packed DC + i Nyquist
        v[0] = regs::untangle(t == 0 ? make_float2(c.x, 0.f) : cconj(c),
                              t == 0 ? make_float2(-c.y, 0.f) : cconj(cm), wt);
      } else {
        v[j] = regs::untangle(cconj(c), cconj(mirror), regs::untangle_twiddle<R>(wt, j));
      }
    });
  }
};

// irfft2_fused on the register passes, their layers of radix RADIX,
// rfft2_regs_kernel's order reversed. x: (F, H, m+1) half spectra; y: (F,
// H, 2m) reals written as (F, H, m) packed complex. The column panel
// (conjugated in: the inverse on the forward passes) leaves C in shared
// memory; the row panel untangles in its first pass and stores conj /
// (H m). ROM: W_n^j, j < n/2, n = max(H, W), padded, after the padded
// frame; the rows' radix-2 layers read it at log_half past log2 m, as
// rfft2_regs_kernel's do. <0, 0> takes the frame's geometry at run time;
// an instance with LOG_H fixed serves the frame (LOG_H, LOG_M) with every
// stride compile-time (LOG_M may be 0). The radix-2 <0, 0> is held to 512
// threads, where it has the registers it needs (irfft2_regs_instance).
template <int LOG_H, int LOG_M, int RADIX>
__global__ void __launch_bounds__(LOG_H || RADIX == 4 ? kMaxThreads : kMaxThreads / 2)
irfft2_regs_kernel(const float2* __restrict__ x,
    float2* __restrict__ y,
    int log_h_arg,
    int log_m_arg) {
  const int log_h = LOG_H ? LOG_H : log_h_arg;
  const int log_m = LOG_H ? LOG_M : log_m_arg;
  extern __shared__ float2 smem[];
  const int h = 1 << log_h;
  const int m = 1 << log_m;
  const int P = h << log_m;
  const int log_n = log_h > log_m + 1 ? log_h : log_m + 1;
  float2* rom = smem + regs::padded(P);
  regs::build_rom(rom, 1 << (log_n - 1));
  const long long frame = blockIdx.x;
  // C's layout: padded where a half-warp of the first row pass spans several
  // rows (m/16 groups a row, under 16), plain where it takes 16 consecutive
  // groups of one row, whose mirror runs are not aligned to 16.
  const bool padded = log_m < 8;
  regs::frame_panel<true, RADIX>(smem, P, log_m, log_h, log_n - 1, rom,
                                 HalfSpectrumCols{x + frame * h * (m + 1), log_h, log_m},
                                 regs::SmemFrame<true>{smem, log_m, padded});
  __syncthreads();
  const float scale = 1.f / static_cast<float>(P);
  regs::frame_panel<false, RADIX>(smem, P, log_m, log_m, log_n - 1, rom,
                                  UntangledRows{{smem, log_m, padded}},
                                  regs::HbmFrameOut<false>{y + frame * P, log_m, scale, -scale});
}

// The 128x128 frame runs an instance of its own at each radix (rfft2 r4: 54
// registers, not 64, and about 7% faster on an H100; irfft2 r4: no spills,
// where <0, 0> spills 24 bytes; PERF.md); every other frame runs <0, 0>,
// but for the radix-2 irfft2's frames of 16384 values below.
using Rfft2RegsKernel = void (*)(const float2*, float2*, int, int);

template <int RADIX>
Rfft2RegsKernel rfft2_regs_instance(int log_h, int log_m) {
  if (log_h == 7 && log_m == 6) return rfft2_regs_kernel<7, 6, RADIX>;
  return rfft2_regs_kernel<0, 0, RADIX>;
}

// The radix-2 irfft2 frames of 16384 values (1024 threads: 64 registers a
// thread) each run an instance of their own, log2 H = 1 ... 14: with its
// geometry at run time the kernel needs a few more, and ptxas spilled 4-28
// bytes under 64 however the pack or the layout was written (PERF.md).
// <0, 0> serves the frames of 512 threads or fewer with the registers it
// needs (106: one block of 512 an SM where 64 would let two), but for
// the 128x128 frame, which has an instance of its own.
template <int... A>
Rfft2RegsKernel irfft2_r2_full_frame(int log_h, std::integer_sequence<int, A...>) {
  Rfft2RegsKernel kernel = nullptr;
  ((log_h == A + 1 ? (kernel = irfft2_regs_kernel<A + 1, 13 - A, 2>, 0) : 0), ...);
  return kernel;
}

template <int RADIX>
Rfft2RegsKernel irfft2_regs_instance(int log_h, int log_m) {
  if (log_h == 7 && log_m == 6) return irfft2_regs_kernel<7, 6, RADIX>;
  if constexpr (RADIX == 2) {
    if (log_h + log_m == 14)
      return irfft2_r2_full_frame(log_h, std::make_integer_sequence<int, 14>{});
  }
  return irfft2_regs_kernel<0, 0, RADIX>;
}

// Both entries: a power-of-two frame of at least 2x2 and radix 2 or 4.
bool frame_ok(int frames, int h, int w, int radix) {
  return frames >= 1 && h >= 2 && w >= 2 && is_pow2(h) && is_pow2(w) &&
         (radix == 2 || radix == 4);
}

// The geometry of a block holding H*W/2 values and the ROM, each padded,
// then the launch.
cudaError_t launch(Rfft2RegsKernel kernel, const void* x, void* y, int frames, int h, int w,
                   int threads, int smem, int device, void* stream) {
  if (!regs::geometry_ok(h * (w / 2), threads, smem, (h > w ? h : w) / 2))
    return cudaErrorInvalidConfiguration;
  const cudaError_t err = prepare(kernel, device, smem);
  if (err != cudaSuccess) return err;
  kernel<<<frames, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), host_log2(h), host_log2(w / 2));
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

extern "C" int repro_rfft2_fused(const void* x, void* y, int frames, int h, int w, int radix,
                                 int threads, int smem, int device, void* stream) {
  using namespace repro;
  if (!frame_ok(frames, h, w, radix)) return cudaErrorInvalidValue;
  const int log_h = host_log2(h), log_m = host_log2(w / 2);
  const auto kernel = radix == 4 ? rfft2_regs_instance<4>(log_h, log_m)
                                 : rfft2_regs_instance<2>(log_h, log_m);
  return launch(kernel, x, y, frames, h, w, threads, smem, device, stream);
}

extern "C" int repro_irfft2_fused(const void* x, void* y, int frames, int h, int w, int radix,
                                  int threads, int smem, int device, void* stream) {
  using namespace repro;
  if (!frame_ok(frames, h, w, radix)) return cudaErrorInvalidValue;
  const int log_h = host_log2(h), log_m = host_log2(w / 2);
  const auto kernel = radix == 4 ? irfft2_regs_instance<4>(log_h, log_m)
                                 : irfft2_regs_instance<2>(log_h, log_m);
  return launch(kernel, x, y, frames, h, w, threads, smem, device, stream);
}
