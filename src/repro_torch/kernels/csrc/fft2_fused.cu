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
// Design: one block per frame, the whole frame in dynamic shared memory
// (at most 16384 complex values, a 128x128 frame: 128 KiB of the 227 KB a
// block may hold). The row panel treats the H rows as lines of stride W;
// the column panel treats the W columns as lines with element stride W and
// line stride 1, so the corner turn and the turn back are changes of
// indexing inside shared memory and never a copy. The frame is read once
// and written once. Frames that do not fit take the row / HBM transpose /
// column composition on fft_fused (repro_torch/kernels/ops.py).
#include <cuda_runtime.h>

#include "stockham.cuh"

namespace repro {
namespace {

template <int RADIX>
__global__ void __launch_bounds__(kMaxThreads)
fft2_fused_kernel(const float2* __restrict__ x,
    float2* __restrict__ y,
    int log_h,
    int log_w,
    int conj,
    float scale) {
  extern __shared__ float2 smem[];
  const int w = 1 << log_w;
  const int P = 1 << (log_h + log_w);
  const int log_nrom = log_h > log_w ? log_h : log_w;
  float2* buf = smem;
  float2* rom = smem + P;  // one ROM for both panels, at the longer length
  build_rom(rom, 1 << (log_nrom - 1), 1 << log_nrom);
  const long long base = static_cast<long long>(blockIdx.x) * P;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const float2 v = x[base + i];
    buf[i] = conj ? cconj(v) : v;
  }
  __syncthreads();
  const Lines rows{buf, log_w, log_h, w, 1, false};
  stockham_panel<RADIX>(rows, rom, log_nrom);
  const Lines cols{buf, log_h, log_w, 1, w, true};
  stockham_panel<RADIX>(cols, rom, log_nrom);
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const float2 v = buf[i];
    y[base + i] = make_float2(v.x * scale, (conj ? -v.y : v.y) * scale);
  }
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
  if (!repro::geometry_ok(h * w, threads, smem, (h > w ? h : w) / 2))
    return cudaErrorInvalidConfiguration;
  auto kernel = radix == 4 ? repro::fft2_fused_kernel<4> : repro::fft2_fused_kernel<2>;
  cudaError_t err = repro::prepare(kernel, device, smem);
  if (err != cudaSuccess) return err;
  kernel<<<frames, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), repro::host_log2(h),
      repro::host_log2(w), conj, scale);
  return cudaGetLastError();
}
