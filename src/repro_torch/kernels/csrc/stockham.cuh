// Device functions shared by the fused FFT kernels: complex helpers, the
// hoisted twiddle ROM, the radix-2 Stockham panel over lines held in shared
// memory (the radix-2 irfft2_fused and fft2_columns), and the two-for-one
// real recombination / untangling.
//
// Replaces the in-VMEM panels of src/repro/kernels/fft_radix2.py
// (_stockham_panel, _rfft_panel, _irfft_panel) for those kernels; the
// others run the register passes of stockham_regs.cuh.
//
// Layout contract with the host census (repro_torch/kernels/fft_radix2.py):
// a block holds P complex f32 values in dynamic shared memory, followed by
// the twiddle ROM. It runs with blockDim.x == P / e threads, where
// e = min(kMaxPerThread, P) is the number of complex values each thread
// stages in registers per stage. Each stage is done in place: every thread
// reads its butterflies' inputs into registers, the block synchronises,
// then every thread writes its outputs. One buffer, not a ping-pong pair,
// is what lets a whole 128x128 complex frame sit in one block.
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

// The hoisted twiddle ROM: rom[j] = exp(-2*pi*i*j / n_rom) for j < len.
// Every stage of every panel in the block reads a strided slice of it.
__device__ __forceinline__ void build_rom(float2* rom, int len, int n_rom) {
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    float s, c;
    sincospif(-2.0f * static_cast<float>(j) / static_cast<float>(n_rom), &s, &c);
    rom[j] = make_float2(c, s);
  }
}

// `lines` transforms of length n in shared memory; element j of line q sits
// at buf[q * line_stride + j * elem_stride]. A row panel has line_stride = n
// and elem_stride = 1; the column panel of a 2D frame has line_stride = 1
// and elem_stride = W, which is the corner turn done by indexing alone.
// line_fast puts neighbouring lines on neighbouring threads, so that a
// column panel's threads touch neighbouring addresses.
struct Lines {
  float2* buf;
  int log_n;
  int log_lines;
  int line_stride;
  int elem_stride;
  bool line_fast;

  __device__ __forceinline__ float2& at(int line, int j) const {
    return buf[line * line_stride + j * elem_stride];
  }

  __device__ __forceinline__ void split(int b, int log_span, int& line, int& t) const {
    if (line_fast) {
      line = b & ((1 << log_lines) - 1);
      t = b >> log_lines;
    } else {
      t = b & ((1 << log_span) - 1);
      line = b >> log_span;
    }
  }
};

// One radix-2 Stockham stage of half-span l = 2^log_l:
//   out[q*2l + k] = a + W_{2l}^k b,  out[q*2l + l + k] = a - W_{2l}^k b,
// with a = in[q*l + k], b = in[n/2 + q*l + k]; W_{2l}^k = rom[k * n_rom/(2l)].
__device__ __forceinline__ void radix2_stage(const Lines& L, int log_l, const float2* rom,
                                             int log_nrom) {
  const int log_span = L.log_n - 1;
  const int half = 1 << log_span;
  const int per = (1 << (L.log_lines + log_span)) / blockDim.x;
  const int kmask = (1 << log_l) - 1;
  const int rshift = log_nrom - 1 - log_l;
  float2 y[kMaxPerThread];
#pragma unroll
  for (int i = 0; i < kMaxPerThread / 2; ++i) {
    if (i < per) {
      int line, t;
      L.split(threadIdx.x + i * blockDim.x, log_span, line, t);
      float2 a = L.at(line, t);
      float2 b = L.at(line, t + half);
      if (log_l > 0) b = cmul(b, rom[(t & kmask) << rshift]);
      y[2 * i] = cadd(a, b);
      y[2 * i + 1] = csub(a, b);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxPerThread / 2; ++i) {
    if (i < per) {
      int line, t;
      L.split(threadIdx.x + i * blockDim.x, log_span, line, t);
      const int o = ((t >> log_l) << (log_l + 1)) + (t & kmask);
      L.at(line, o) = y[2 * i];
      L.at(line, o + (1 << log_l)) = y[2 * i + 1];
    }
  }
  __syncthreads();
}

// All radix-2 stages over the lines, in the order of the Pallas panel. The
// caller synchronises after loading `buf` and after writing `rom`; the
// panel ends synchronised.
__device__ __forceinline__ void stockham_panel(const Lines& L, const float2* rom, int log_nrom) {
  for (int log_l = 0; log_l < L.log_n; ++log_l) radix2_stage(L, log_l, rom, log_nrom);
}

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
// and room for P values plus the ROM in dynamic shared memory.
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
