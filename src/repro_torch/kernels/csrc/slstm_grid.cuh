// What the sLSTM scan (slstm_scan.cu) and its backward (slstm_scan_bwd.cu)
// share: the FP64 tensor-core tile, the grid barrier of their one
// persistent cooperative grid, and its launch.
#pragma once
#include <cuda_runtime.h>

#include <cuda/atomic>

namespace repro {
namespace {

// Clock cycles a CTA waits on one grid barrier before it traps (~10 s).
constexpr long long kBarrierPatience = 20000000000LL;

#ifndef REPRO_CUDA_EMU
// C += A B for one 8 x 8 x 4 tile in double on the tensor cores (mma.sync
// m8n8k4): lane l holds A[l / 4][l % 4], B[l % 4][l / 4] and
// C[l / 4][2 (l % 4) + {0, 1}].
__device__ __forceinline__ void mma_m8n8k4(double& c0, double& c1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(c0), "+d"(c1)
               : "d"(a), "d"(b));
}
#endif

// Every thread of the CTA has passed __syncthreads(), so the CTA's stores
// are ordered before one thread counts the CTA in with release semantics
// (atom.add.release.gpu).
__device__ __forceinline__ void grid_arrive(unsigned long long* count) {
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> ref(*count);
    ref.fetch_add(1ULL, cuda::std::memory_order_release);
  }
}

// One thread polls with an acquire load until all `target` arrivals are
// in; the CTA's later reads are ordered after it by __syncthreads(). A
// wait past kBarrierPatience traps, so a fault ends the launch with an
// error and does not hang the card.
__device__ __forceinline__ void grid_wait(unsigned long long* count, unsigned long long target) {
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> ref(*count);
    const long long start = clock64();
    while (ref.load(cuda::std::memory_order_acquire) < target)
      if (clock64() - start > kBarrierPatience) __trap();
  }
  __syncthreads();
}

// A cooperative launch: all of the grid resident at once, or the launch
// is refused.
template <class... P, class... A>
cudaError_t launch_cooperative(void (*kernel)(P...), int ctas, int threads, int smem,
                               cudaStream_t stream, A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace
}  // namespace repro
