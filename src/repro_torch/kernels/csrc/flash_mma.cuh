// The split-TF32 tensor-core products and the cp.async copies shared by
// flash attention's forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu).
//
// A float32 product on the tensor cores: x = big + small, big a TF32
// value (x with its low 13 bits cleared) and small the exact float32
// remainder, and a * b as three TF32 mma.sync m16n8k8 products, small*big
// + big*small first and big*big last, summed in float32. What is dropped,
// small*small and the bits of small below TF32's, is some 2^-21 of the
// product (flash_attention.cu's header says why truncation, and why an
// accumulator summed over many keys takes its products from zero).
//
// Tiles sit in shared memory in rows of round8(width) + kPad floats: the
// width padded with zeros to the mma's k and n step, plus 4 floats, so that
// 16-byte copies stay aligned and fragment reads fall in 32 distinct banks.
//
// The warp-wide instructions (mma.sync, ldmatrix, cp.async) are inline PTX;
// where REPRO_CUDA_EMU is defined, tools/cuda_emu/cuda_runtime.h gives
// stand-ins of the same names that run the arithmetic on the CPU.
#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

namespace repro {
namespace {

constexpr int kPad = 4;  // floats after each shared row

__host__ __device__ constexpr int round8(int x) { return (x + 7) & ~7; }

// x = big + small: big is x with the low 13 bits cleared (a TF32 value),
// small the float32 remainder, exact, of which the mma reads the top 19
// bits (it ignores the low 13 of a TF32 operand).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

#ifndef REPRO_CUDA_EMU
// c += a b for one 16 x 8 x 8 tile (A row-major, B column-major): lane l
// holds A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4], B[t][g], B[t+4][g] and
// C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1] (g = l / 4, t = l % 4).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 4-float matrices from shared memory: lane l gives the address
// of row l % 8 of matrix l / 8 and receives element (l / 4, l % 4) of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
#endif

// c += a * b in three TF32 products: the small terms first.
__device__ __forceinline__ void mma_split(float (&c)[4], const uint32_t (&a_big)[4],
                                          const uint32_t (&a_small)[4],
                                          const uint32_t (&b_big)[2],
                                          const uint32_t (&b_small)[2]) {
  mma_tf32(c, a_small, b_big[0], b_big[1]);
  mma_tf32(c, a_big, b_small[0], b_small[1]);
  mma_tf32(c, a_big, b_big[0], b_big[1]);
}

// c += a * b as mma_split takes it, but the three products summed from
// zero and that sum added to c on the CUDA cores, rounded to nearest. The
// tensor core truncates as it adds into its accumulator, so the output
// accumulator, chained through every 8-key slice of the keys, drifted by
// that bias: 1.1e-5 to 1.8e-5 of max|out| over whisper's 1500 keys, where
// the plain version is 3e-7 to 2e-6 from float64.
__device__ __forceinline__ void mma_split_add(float (&c)[4], const uint32_t (&a_big)[4],
                                              const uint32_t (&a_small)[4],
                                              const uint32_t (&b_big)[2],
                                              const uint32_t (&b_small)[2]) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_split(part, a_big, a_small, b_big, b_small);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += part[e];
}

// Zeroes columns [cols, round8(cols)) of `rows` shared rows; no copy
// writes there.
template <int Threads>
__device__ __forceinline__ void zero_pad(float* dst, int ld, int cols, int rows) {
  const int extra = round8(cols) - cols;
  for (int i = threadIdx.x; i < rows * extra; i += Threads) {
    const int r = i / extra;
    dst[r * ld + cols + (i - r * extra)] = 0.f;
  }
}

}  // namespace
}  // namespace repro
