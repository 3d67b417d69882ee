// Whole-frame 2D FFT kernel: fft2_fused.
//
// Replaces src/repro/kernels/fft_radix2.py fft2_fused (:411, pallas_call at
// :427): for each (H, W) frame a row panel, a corner turn, a column panel
// and a turn back, on one residency.
//
// Bound on an H100: HBM bytes, 16 per complex element (one read, one
// write); the 5 HW log2(HW) flops per frame are far below the float32 rate
// per byte.
//
// Design: one block per frame, the whole frame in dynamic shared memory (at
// most 16384 complex values, a 128x128 frame: 136 KiB padded, so one block
// an SM). Frames that do not fit take the row / HBM transpose / column
// composition on fft_fused (repro_torch/kernels/ops.py).
//
// The register passes of stockham_regs.cuh (frame_panel), 16 values a
// thread, two radix-4 layers (RADIX 4) or four radix-2 Stockham stages
// (RADIX 2, r2_layers) in registers per exchange through shared memory. The
// row panel's first pass loads straight from HBM into registers
// (coalesced: consecutive threads take consecutive groups of a row), its
// later passes run in shared memory; the column panel maps consecutive
// threads to consecutive columns, so the corner turn is that mapping and
// each of its accesses covers consecutive slots; its last pass stores
// straight from registers to HBM, whole rows of consecutive columns,
// conjugated and scaled for the inverse. A 128x128 frame is 16·8 on each
// side: four passes, three exchanges and five barriers, where the
// stage-at-a-time panel took about ten round trips through shared memory
// at radix 4 and fourteen at radix 2. One instance a radix serves every
// frame of the census with the line lengths and strides as runtime values
// and the radix of each pass a compile-time one; the 128x128 frame that
// chip_smoke times also has an instance of its own at each radix.
#include <cuda_runtime.h>

#include "fft_common.cuh"
#include "stockham_regs.cuh"

namespace repro {
namespace {

// Rows, then columns, on the register passes; HBM -> registers -> shared
// memory -> ... -> registers -> HBM. ROM: W_n^j, j < n/2, at the longer
// side n, padded, after the padded frame. <0, 0> takes the frame's geometry
// at run time; an instance with LOG_H, LOG_W fixed serves that frame with
// every stride compile-time (fft2_regs_instance).
template <int LOG_H, int LOG_W, int RADIX>
__global__ void __launch_bounds__(kMaxThreads)
fft2_regs_kernel(const float2* __restrict__ x,
    float2* __restrict__ y,
    int log_h_arg,
    int log_w_arg,
    int conj,
    float scale) {
  const int log_h = LOG_H ? LOG_H : log_h_arg;
  const int log_w = LOG_W ? LOG_W : log_w_arg;
  extern __shared__ float2 smem[];
  const int P = 1 << (log_h + log_w);
  const int log_half = (log_h > log_w ? log_h : log_w) - 1;
  float2* rom = smem + regs::padded(P);
  regs::build_rom(rom, 1 << log_half);
  const long long base = static_cast<long long>(blockIdx.x) * P;
  const bool rows_padded = regs::pass_count(log_w) == 1;
  const regs::SmemFrame<false> rows_out{smem, log_w, rows_padded};
  regs::frame_panel<false, RADIX>(smem, P, log_w, log_w, log_half, rom,
                                  regs::HbmFrameRows{x + base, log_w, conj ? -1.f : 1.f},
                                  rows_out);
  __syncthreads();
  regs::frame_panel<true, RADIX>(
      smem, P, log_w, log_h, log_half, rom, regs::SmemFrame<true>{smem, log_w, rows_padded},
      regs::HbmFrameOut<true>{y + base, log_w, scale, conj ? -scale : scale});
}

// The 128x128 frame runs an instance of its own: with immediate offsets and
// shifts it needs 52 registers, not 64, at radix 4, and runs about 10%
// faster on an H100 (PERF.md); every other frame runs <0, 0>.
using Fft2RegsKernel = void (*)(const float2*, float2*, int, int, int, float);

template <int RADIX>
Fft2RegsKernel fft2_regs_instance(int log_h, int log_w) {
  if (log_h == 7 && log_w == 7) return fft2_regs_kernel<7, 7, RADIX>;
  return fft2_regs_kernel<0, 0, RADIX>;
}

}  // namespace
}  // namespace repro

extern "C" int repro_fft2_fused(const void* x, void* y, int frames, int h, int w, int radix,
                                int threads, int smem, int conj, float scale, int device,
                                void* stream) {
  using repro::is_pow2;
  if (frames < 1 || h < 2 || w < 2 || !is_pow2(h) || !is_pow2(w) ||
      (radix != 2 && radix != 4))
    return cudaErrorInvalidValue;
  const int half = (h > w ? h : w) / 2;
  if (!repro::regs::geometry_ok(h * w, threads, smem, half)) return cudaErrorInvalidConfiguration;
  const int log_h = repro::host_log2(h), log_w = repro::host_log2(w);
  const auto kernel = radix == 4 ? repro::fft2_regs_instance<4>(log_h, log_w)
                                 : repro::fft2_regs_instance<2>(log_h, log_w);
  cudaError_t err = repro::prepare(kernel, device, smem);
  if (err != cudaSuccess) return err;
  kernel<<<frames, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), log_h, log_w, conj, scale);
  return cudaGetLastError();
}
