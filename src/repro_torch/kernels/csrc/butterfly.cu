// One radix-2 DIT stage over bit-reversed rows: butterfly_stage.
//
// Replaces src/repro/kernels/butterfly.py: butterfly_stage (:64, pallas_call
// at :85, body butterfly_stage_kernel at :28).
//
// Bound on an H100: HBM bytes. A stage reads the re and im planes once and
// writes them once (16 bytes per complex value) and does 10 flops per
// butterfly, so a (8192, 2048) stage moves 268 MB for 84 MFLOP. Rows of
// that batch do not fit the 50 MB L2, so every stage is one HBM round trip:
// this kernel is the paper's column architecture, measured against the
// fused kernel's single round trip.
//
// Design: one thread per butterfly, grid-stride over B * N/2. Butterfly j of
// a row at half-span h = 2^stage sits in group g = j / h at offset
// p = j % h; its inputs are elements g*2h + p and g*2h + p + h, so
// neighbouring threads touch neighbouring addresses (for h >= 32 a warp's
// loads are fully coalesced). The twiddle W = exp(-i pi p / h) comes from
// sincospif in registers, as the TPU kernel made it from an iota: p / h is
// exact in float32 because h is a power of two.
#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace repro {
namespace {

__global__ void __launch_bounds__(1024)
butterfly_stage_kernel(const float* __restrict__ re,
    const float* __restrict__ im,
    float* __restrict__ out_re,
    float* __restrict__ out_im,
    long long total,
    int log_n,
    int log_h) {
  const long long half_mask = (1LL << (log_n - 1)) - 1;
  const int h = 1 << log_h;
  const float inv_h = 1.0f / static_cast<float>(h);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const long long row = i >> (log_n - 1);
    const int j = static_cast<int>(i & half_mask);
    const int g = j >> log_h;
    const int p = j & (h - 1);
    const long long top = (row << log_n) + (static_cast<long long>(g) << (log_h + 1)) + p;
    const long long bot = top + h;
    float s, c;
    sincospif(-static_cast<float>(p) * inv_h, &s, &c);
    const float ar = re[top], ai = im[top];
    const float br = re[bot], bi = im[bot];
    const float tr = br * c - bi * s;
    const float ti = br * s + bi * c;
    out_re[top] = ar + tr;
    out_re[bot] = ar - tr;
    out_im[top] = ai + ti;
    out_im[bot] = ai - ti;
  }
}

}  // namespace
}  // namespace repro

// re, im, out_re, out_im: (batch, n) float32 planes; 0 <= stage < log2 n.
extern "C" int repro_butterfly_stage(const void* re, const void* im, void* out_re, void* out_im,
                                     int batch, int n, int stage, int blocks, int threads,
                                     int device, void* stream) {
  if (batch < 1 || n < 2 || !repro::is_pow2(n) || stage < 0 || (1 << stage) >= n)
    return cudaErrorInvalidValue;
  if (blocks < 1 || threads < 32 || threads > 1024 || threads % 32 != 0)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(batch) * (n / 2);
  repro::butterfly_stage_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(re), static_cast<const float*>(im), static_cast<float*>(out_re),
      static_cast<float*>(out_im), total, repro::host_log2(n), stage);
  return cudaGetLastError();
}
