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
// both. The recombination and untangling run in place through registers,
// as the Stockham stages do, and the corner turn is the column panel's
// indexing (stockham.cuh). Frames that do not fit take the row / HBM turn /
// column composition (repro_torch/kernels/ops.py).
#include <cuda_runtime.h>

#include "stockham.cuh"

namespace repro {
namespace {

// x: (F, H, 2m) reals read as (F, H, m) packed complex; y: (F, H, m+1).
template <int RADIX>
__global__ void __launch_bounds__(kMaxThreads)
rfft2_fused_kernel(const float2* __restrict__ x,
    float2* __restrict__ y,
    int log_h,
    int log_m) {
  extern __shared__ float2 smem[];
  const int h = 1 << log_h;
  const int m = 1 << log_m;
  const int P = h << log_m;
  const int log_nrom = log_h > log_m + 1 ? log_h : log_m + 1;
  const int wshift = log_nrom - log_m - 1;  // W_{2m}^k = rom[k << wshift]
  float2* buf = smem;
  float2* rom = smem + P;  // one ROM, W^j for j <= n_rom/2: both panels and the recombination
  build_rom(rom, (1 << (log_nrom - 1)) + 1, 1 << log_nrom);
  const long long base = static_cast<long long>(blockIdx.x) * P;
  for (int i = threadIdx.x; i < P; i += blockDim.x) buf[i] = x[base + i];
  __syncthreads();
  const Lines rows{buf, log_m, log_h, m, 1, false};
  stockham_panel<RADIX>(rows, rom, log_nrom);

  // Recombine each row in place: slot k <- Y[k] for 0 < k < m, slot 0 <-
  // Y[0] + i Y[m] (both real for a real row).
  const int per = P / blockDim.x;
  float2 v[kMaxPerThread];
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    if (i < per) {
      const int idx = threadIdx.x + i * blockDim.x;
      const int k = idx & (m - 1);
      const float2* z = buf + (idx >> log_m) * m;
      if (k == 0) {
        const float2 dc = rfft_recombine(z, m, 0, rom[0]);
        const float2 ny = rfft_recombine(z, m, m, rom[m << wshift]);
        v[i] = make_float2(dc.x, ny.x);
      } else {
        v[i] = rfft_recombine(z, m, k, rom[k << wshift]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    if (i < per) buf[threadIdx.x + i * blockDim.x] = v[i];
  }
  __syncthreads();

  const Lines cols{buf, log_h, log_m, 1, m, true};
  stockham_panel<RADIX>(cols, rom, log_nrom);

  // Column 0 now holds Z = A + iB with A, B the (Hermitian) transforms of
  // the DC and Nyquist columns: A = (Z[r] + conj Z[-r]) / 2,
  // B = -i (Z[r] - conj Z[-r]) / 2.
  const int out_w = m + 1;
  const long long out_base = static_cast<long long>(blockIdx.x) * h * out_w;
  for (int i = threadIdx.x; i < h * out_w; i += blockDim.x) {
    const int r = i / out_w;
    const int k = i - r * out_w;
    float2 o;
    if (k != 0 && k != m) {
      o = buf[r * m + k];
    } else {
      const float2 z = buf[r * m];
      const float2 zm = cconj(buf[((h - r) & (h - 1)) * m]);
      if (k == 0) {
        o = make_float2(0.5f * (z.x + zm.x), 0.5f * (z.y + zm.y));
      } else {
        const float2 d = csub(z, zm);
        o = make_float2(0.5f * d.y, -0.5f * d.x);
      }
    }
    y[out_base + i] = o;
  }
}

// x: (F, H, m+1) half spectra; y: (F, H, 2m) reals written as (F, H, m)
// packed complex. Both inverse panels run on the forward panel by
// conjugation; the output is scaled by 1/(H m).
template <int RADIX>
__global__ void __launch_bounds__(kMaxThreads)
irfft2_fused_kernel(const float2* __restrict__ x,
    float2* __restrict__ y,
    int log_h,
    int log_m) {
  extern __shared__ float2 smem[];
  const int h = 1 << log_h;
  const int m = 1 << log_m;
  const int P = h << log_m;
  const int log_nrom = log_h > log_m + 1 ? log_h : log_m + 1;
  const int wshift = log_nrom - log_m - 1;
  float2* buf = smem;
  float2* rom = smem + P;
  build_rom(rom, 1 << (log_nrom - 1), 1 << log_nrom);

  // Load conjugated. Slot 0 of row r packs the DC column a and Nyquist
  // column b as A + iB, A = (a[r] + conj a[-r]) / 2 (likewise B): the
  // inverse column transform of A + iB is Re(ifft a) + i Re(ifft b), which
  // is what the row transform keeps of those two bins.
  const int in_w = m + 1;
  const long long in_base = static_cast<long long>(blockIdx.x) * h * in_w;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const int r = i >> log_m;
    const int k = i & (m - 1);
    const float2* row = x + in_base + r * in_w;
    float2 v;
    if (k != 0) {
      v = row[k];
    } else {
      const float2* mirror = x + in_base + ((h - r) & (h - 1)) * in_w;
      const float2 a = row[0], am = cconj(mirror[0]);
      const float2 b = row[m], bm = cconj(mirror[m]);
      const float2 A = make_float2(0.5f * (a.x + am.x), 0.5f * (a.y + am.y));
      const float2 B = make_float2(0.5f * (b.x + bm.x), 0.5f * (b.y + bm.y));
      v = make_float2(A.x - B.y, A.y + B.x);
    }
    buf[i] = cconj(v);
  }
  __syncthreads();
  const Lines cols{buf, log_h, log_m, 1, m, true};
  stockham_panel<RADIX>(cols, rom, log_nrom);

  // buf = conj(H * column inverse). Untangle each row in place into the
  // conjugated packed values of the half-size row inverse, as irfft_fused.
  const int per = P / blockDim.x;
  float2 v[kMaxPerThread];
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    if (i < per) {
      const int idx = threadIdx.x + i * blockDim.x;
      const int k = idx & (m - 1);
      const float2* row = buf + (idx >> log_m) * m;
      float2 yk, ym;  // Y[k] and Y[m-k]
      if (k == 0) {
        const float2 c = row[0];
        yk = make_float2(c.x, 0.f);
        ym = make_float2(-c.y, 0.f);
      } else {
        yk = cconj(row[k]);
        ym = cconj(row[m - k]);
      }
      v[i] = cconj(irfft_untangle(yk, cconj(ym), cconj(rom[k << wshift])));
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    if (i < per) buf[threadIdx.x + i * blockDim.x] = v[i];
  }
  __syncthreads();
  const Lines rows{buf, log_m, log_h, m, 1, false};
  stockham_panel<RADIX>(rows, rom, log_nrom);
  const float inv = 1.0f / static_cast<float>(P);
  const long long base = static_cast<long long>(blockIdx.x) * P;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const float2 o = buf[i];
    y[base + i] = make_float2(o.x * inv, -o.y * inv);
  }
}

// Shared checks of both entries: a power-of-two frame of at least 2x2 and
// the geometry of a block holding H*W/2 values and the ROM.
cudaError_t check(int frames, int h, int w, int radix, int threads, int smem) {
  if (frames < 1 || h < 2 || w < 2 || !is_pow2(h) || !is_pow2(w) ||
      (radix != 2 && radix != 4))
    return cudaErrorInvalidValue;
  const int rom_len = (h > w ? h : w) / 2 + 1;
  if (!geometry_ok(h * (w / 2), threads, smem, rom_len)) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

}  // namespace
}  // namespace repro

extern "C" int repro_rfft2_fused(const void* x, void* y, int frames, int h, int w, int radix,
                                 int threads, int smem, int device, void* stream) {
  cudaError_t err = repro::check(frames, h, w, radix, threads, smem);
  if (err != cudaSuccess) return err;
  auto kernel = radix == 4 ? repro::rfft2_fused_kernel<4> : repro::rfft2_fused_kernel<2>;
  err = repro::prepare(kernel, device, smem);
  if (err != cudaSuccess) return err;
  kernel<<<frames, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), repro::host_log2(h),
      repro::host_log2(w / 2));
  return cudaGetLastError();
}

extern "C" int repro_irfft2_fused(const void* x, void* y, int frames, int h, int w, int radix,
                                  int threads, int smem, int device, void* stream) {
  cudaError_t err = repro::check(frames, h, w, radix, threads, smem);
  if (err != cudaSuccess) return err;
  auto kernel = radix == 4 ? repro::irfft2_fused_kernel<4> : repro::irfft2_fused_kernel<2>;
  err = repro::prepare(kernel, device, smem);
  if (err != cudaSuccess) return err;
  kernel<<<frames, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), repro::host_log2(h),
      repro::host_log2(w / 2));
  return cudaGetLastError();
}
