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
// Radix 4: the register passes of stockham_regs.cuh over the panel as a
// frame of C columns (frame_panel<true>: consecutive threads on consecutive
// columns); the first pass loads from HBM straight into registers and the
// last stores from registers straight to HBM (HbmColumns). A column of at
// most 16 values is one pass, which goes through shared memory once so
// that all its reads precede its writes.
// Radix 2 (the `fused` engine's route): the panel is loaded into shared
// memory and the Stockham stages of stockham.cuh run down its columns
// (line stride 1, element stride C), with the row stride a runtime value.
#include <climits>

#include <cuda_runtime.h>

#include "stockham.cuh"
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

// Radix 4. Shared memory: the padded panel, then the padded ROM of H/2
// twiddles W_H^j.
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
    regs::frame_panel<true>(smem, P, log_c, log_h, log_half, rom, panel, panel);
    return;
  }
  // One pass (H <= 16): HBM -> registers -> shared memory, a barrier, then
  // shared memory -> HBM (a pass of radix 1 is a copy through the scaling).
  const regs::Lanes<true> lanes{log_c};
  const regs::SmemFrame<true> buf{smem, log_c, false};
  regs::pass_r(log_h, P, log_h, 0, log_half, lanes, rom, panel, buf);
  __syncthreads();
  regs::pass<0>(P, log_h, 0, log_half, lanes, rom, buf, panel);
}

// Radix 2. Shared memory: the panel (buf[i C + t]: element i of column
// c0 + t), then the ROM of H/2 twiddles W_H^j.
__global__ void __launch_bounds__(kMaxThreads)
fft2_columns_kernel(const float2* x,
    float2* y,
    int log_h,
    int log_c,
    int stride,
    int tiles,
    int conj,
    float scale) {
  extern __shared__ float2 smem[];
  const int cols = 1 << log_c;
  const int P = 1 << (log_h + log_c);
  float2* buf = smem;
  float2* rom = smem + P;
  build_rom(rom, 1 << (log_h - 1), 1 << log_h);
  const PanelOf at(1 << log_h, stride, log_c, tiles);
  const float2* src = x + at.base + at.c0;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const int t = i & (cols - 1);
    float2 v = make_float2(0.f, 0.f);
    if (at.c0 + t < stride) v = src[static_cast<unsigned>((i >> log_c) * stride + t)];
    buf[i] = conj ? cconj(v) : v;
  }
  __syncthreads();
  const Lines lines{buf, log_h, log_c, 1, cols, true};
  stockham_panel(lines, rom, log_h);
  float2* dst = y + at.base + at.c0;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const int t = i & (cols - 1);
    if (at.c0 + t >= stride) continue;
    const float2 v = buf[i];
    dst[static_cast<unsigned>((i >> log_c) * stride + t)] =
        make_float2(v.x * scale, (conj ? -v.y : v.y) * scale);
  }
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
  const bool ok = radix == 4 ? repro::regs::geometry_ok(P, threads, smem, h / 2)
                             : repro::geometry_ok(P, threads, smem, h / 2);
  if (!ok) return cudaErrorInvalidConfiguration;
  const auto kernel = radix == 4 ? repro::fft2_columns_regs_kernel : repro::fft2_columns_kernel;
  cudaError_t err = repro::prepare(kernel, device, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), repro::host_log2(h),
      repro::host_log2(cols), stride, tiles, conj, scale);
  return cudaGetLastError();
}
