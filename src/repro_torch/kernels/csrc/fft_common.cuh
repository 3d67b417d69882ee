// Device and host helpers shared by the FFT kernels: complex arithmetic,
// the two-for-one real recombination and untangling (rfft_recombine,
// irfft_untangle), and the thread contract of a one-block launch
// (geometry_ok) with the opt-in to its dynamic shared memory (prepare).
// The panels themselves are the register passes of stockham_regs.cuh,
// which every FFT kernel runs at both radices.
//
// Thread contract with the host census (repro_torch/kernels/fft_radix2.py):
// a block holds P complex f32 values and runs with P / e threads, where
// e = min(kMaxPerThread, P) is the number of complex values each thread
// holds in registers.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int kMaxPerThread = 16;

// Every kernel may run with up to 1024 threads (a 128x128 frame, or one
// 16384-point row); __launch_bounds__ holds the compiler to the 64
// registers a thread may then have.
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cconj(float2 a) { return make_float2(a.x, -a.y); }

// Two-for-one recombination of bin k (0 <= k <= m) of a real length-2m
// transform from the half-size spectrum z (length m) of the packed samples:
//   Y[k] = Xe[k] + W_{2m}^k Xo[k],  Xe = (Z[k] + conj Z[m-k]) / 2,
//   Xo = -i (Z[k] - conj Z[m-k]) / 2,  indices mod m.  w = W_{2m}^k.
__device__ __forceinline__ float2 rfft_recombine(const float2* z, int m, int k, float2 w) {
  const float2 zk = z[k == m ? 0 : k];
  const float2 zmk = cconj(z[k == 0 ? 0 : m - k]);
  const float2 xe = make_float2(0.5f * (zk.x + zmk.x), 0.5f * (zk.y + zmk.y));
  const float2 d = csub(zk, zmk);
  const float2 xo = make_float2(0.5f * d.y, -0.5f * d.x);
  return make_float2(xe.x + w.x * xo.x - w.y * xo.y, xe.y + w.x * xo.y + w.y * xo.x);
}

// Untangling for the inverse: from bins yk = Y[k] and ymk = conj Y[m-k]
// (imaginary parts at DC and Nyquist already zeroed) rebuild the packed
// value z[k] = Xe[k] + i Xo[k] of the half-size inverse; winv = W_{2m}^{-k}.
__device__ __forceinline__ float2 irfft_untangle(float2 yk, float2 ymk, float2 winv) {
  const float2 xe = make_float2(0.5f * (yk.x + ymk.x), 0.5f * (yk.y + ymk.y));
  const float2 tx = make_float2(0.5f * (yk.x - ymk.x), 0.5f * (yk.y - ymk.y));
  const float2 xo = cmul(tx, winv);
  return make_float2(xe.x - xo.y, xe.y + xo.x);
}

// ------------------------------ host side -------------------------------

inline bool is_pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

inline int host_log2(int v) { return 31 - __builtin_clz(static_cast<unsigned>(v)); }

// The launch geometry the host census computed must be the one the
// kernels assume: P values over `threads` threads, min(16, P) per thread,
// and room in `smem` bytes for P values plus a ROM of rom_len (the
// register-pass kernels call it through regs::geometry_ok, which pads both).
inline bool geometry_ok(int P, int threads, int smem, int rom_len) {
  if (threads < 1 || threads > kMaxThreads || P % threads != 0) return false;
  const int e = P / threads;
  const int want = P < kMaxPerThread ? P : kMaxPerThread;
  return e == want && smem >= (P + rom_len) * static_cast<int>(sizeof(float2));
}

// Select the device and opt the kernel into `smem` bytes of dynamic
// shared memory (above the default 48 KB).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int device, int smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace repro
