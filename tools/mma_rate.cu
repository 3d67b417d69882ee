// The rate of mma.sync m16n8k8 TF32 on one NVIDIA card: the ceiling of the
// split-TF32 flash attention kernels (csrc/flash_mma.cuh), whose products
// are mma.sync rather than wgmma. For 1 to 8 warps a block (8 blocks
// an SM) and 1, 4 or 8 independent accumulator chains a warp, the TFLOP/s in
// TF32 and the ns between two mma on one of the SM's 4 sub-partitions; one
// chain a warp shows the dependent latency.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_rate tools/mma_rate.cu
//   build/mma_rate
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int CH>
__global__ void bench(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  float c[CH][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int k = 0; k < CH; ++k) mma_tf32(c[k], a, a[k & 3] + i, a[(k + 1) & 3]);
  float s = 0;
#pragma unroll
  for (int k = 0; k < CH; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int CH>
void run(int warps, float* out) {
  const int iters = 4096, blocks = 132 * 8;
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  bench<CH><<<blocks, 32 * warps>>>(out, 16);
  cudaEventRecord(a);
  bench<CH><<<blocks, 32 * warps>>>(out, iters);
  cudaEventRecord(b); cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b);
  const double mmas = double(blocks) * warps * iters * CH;
  printf("chains %d warps/block %d: %.3f ms, %.1f TFLOP/s tf32, %.2f ns per mma per SMSP\n", CH, warps, ms,
         mmas * 2048 / ms / 1e9, ms * 1e6 / (mmas / (132 * 4)));
}
int main() {
  float* out; cudaMalloc(&out, 132 * 8 * 1024 * 4);
  for (int w : {1, 2, 4, 8}) { run<1>(w, out); run<4>(w, out); run<8>(w, out); }
  return 0;
}
