// Column pass of the composed 2D route: fft2_columns.
//
// Replaces the column pass of the composed route of
// src/repro/kernels/ops.py and the HBM corner turns around it: fft2_kernel
// (:177, the row pass's output swapped, _fft_rows down the columns at
// :193-195, swapped back at :196-197), rfft2_kernel's column fft_impl and
// its swapaxes (:247-248) and irfft2_kernel's column ifft_impl and its
// swapaxes (:270-271). Those run on frames over one block; frames that fit
// one take fft2_fused / rfft2_fused / irfft2_fused (fft2_fused.cu,
// rfft2_fused.cu).
//
// What it computes: for a batch of F frames of H rows of Wc complex values
// in HBM (the row pass's output: Wc = W, or W/2+1 for a half spectrum), the
// length-H FFT down each of the Wc columns, written back to the same
// positions: in place (x == y) after the rows of fft2 and rfft2, or into a
// new buffer before the rows of irfft2. The inverse conjugates on the way
// in and out and scales by 1/H (the row pass scales by 1/W).
//
// Bound on an H100: HBM bytes, 16 per complex value (one read and one
// write of the F H Wc values); the 5 H log2(H) flops a column are far below
// the float32 rate per byte. The turn route it replaces moved every value
// four times (row pass, turn, column pass, turn back); the route now moves
// it twice (row pass, this pass).
//
// Design: the corner turn is addressing, as in the paper's RAM controller
// and in the whole-frame kernel's column panel. One block takes a panel of
// C neighbouring columns x all H rows of one frame. It reads them as runs
// of C consecutive values of a row (C >= 16 where H <= 1024: whole 128-byte
// lines; C = 8 and 4 at H = 2048 and 4096: whole 32-byte sectors), runs the
// FFT down each column in registers and shared memory, and stores the
// result to the addresses it read: each block owns its columns, and every
// value is read before the first barrier and written after the last, so in
// place is safe. C H <= 16384 values, 16 a thread (the census:
// fft2_columns_geometry in repro_torch/kernels/fft_radix2.py). The last
// panel of a width that is not a multiple of C masks its missing columns.
//
// The register passes of stockham_regs.cuh over the panel as a frame of C
// columns (frame_panel<true>: consecutive threads on consecutive columns),
// two radix-4 layers (RADIX 4) or four radix-2 Stockham stages (RADIX 2,
// r2_layers; the `fused` engine's route) in registers per exchange; the
// first pass loads from HBM straight into registers and the last stores
// from registers straight to HBM (HbmColumns). A column of at most 16
// values is one pass, which goes through shared memory once so that all
// its reads precede its writes. H and C are runtime values, so a pass's
// twiddle addresses take runtime shifts at either radix.
#include <climits>

#include <cuda_runtime.h>

#include "stockham_regs.cuh"

namespace repro {
namespace {

// The frame and first column of this block's panel: blocks run frame by
// frame, `tiles` panels a frame.
struct PanelOf {
  long long base;  // offset of the frame
  int c0;

  __device__ PanelOf(int h, int stride, int log_c, int tiles) {
    const int frame = static_cast<int>(blockIdx.x) / tiles;
    c0 = (static_cast<int>(blockIdx.x) - frame * tiles) << log_c;
    base = static_cast<long long>(frame) * h * stride;
  }
};

// Shared memory: the padded panel, then the padded ROM of H/2 twiddles
// W_H^j. RADIX: the passes' layers (regs::pass).
template <int RADIX>
__global__ void __launch_bounds__(kMaxThreads)
fft2_columns_regs_kernel(const float2* x,
    float2* y,
    int log_h,
    int log_c,
    int stride,
    int tiles,
    int conj,
    float scale) {
  extern __shared__ float2 smem[];
  const int P = 1 << (log_h + log_c);
  const int log_half = log_h - 1;
  float2* rom = smem + regs::padded(P);
  regs::build_rom(rom, 1 << log_half);
  const PanelOf at(1 << log_h, stride, log_c, tiles);
  const regs::HbmColumns panel{x + at.base, y + at.base, stride, at.c0,
                               conj ? -1.f : 1.f, scale, conj ? -scale : scale};
  if (regs::pass_count(log_h) > 1) {
    regs::frame_panel<true, RADIX>(smem, P, log_c, log_h, log_half, rom, panel, panel);
    return;
  }
  // One pass (H <= 16): HBM -> registers -> shared memory, a barrier, then
  // shared memory -> HBM (a pass of radix 1 is a copy through the scaling).
  const regs::Lanes<true> lanes{log_c};
  const regs::SmemFrame<true> buf{smem, log_c, false};
  regs::pass_r<RADIX>(log_h, P, log_h, 0, log_half, lanes, rom, panel, buf);
  __syncthreads();
  regs::pass<0, RADIX>(P, log_h, 0, log_half, lanes, rom, buf, panel);
}

}  // namespace
}  // namespace repro

extern "C" int repro_fft2_columns(const void* x, void* y, int frames, int h, int stride,
                                  int radix, int cols, int threads, int smem, int conj,
                                  float scale, int device, void* stream) {
  using repro::is_pow2;
  if (frames < 1 || h < 2 || !is_pow2(h) || stride < 1 || cols < 1 || !is_pow2(cols) ||
      (radix != 2 && radix != 4) || static_cast<long long>(h) * stride >= (1LL << 31))
    return cudaErrorInvalidValue;
  const int tiles = (stride + cols - 1) / cols;
  const long long blocks = static_cast<long long>(frames) * tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const int P = h * cols;
  if (!repro::regs::geometry_ok(P, threads, smem, h / 2)) return cudaErrorInvalidConfiguration;
  const auto kernel = radix == 4 ? repro::fft2_columns_regs_kernel<4>
                                 : repro::fft2_columns_regs_kernel<2>;
  cudaError_t err = repro::prepare(kernel, device, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), repro::host_log2(h),
      repro::host_log2(cols), stride, tiles, conj, scale);
  return cudaGetLastError();
}
