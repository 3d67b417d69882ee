// CPU emulation of the CUDA subset the FFT kernels use: one std::thread per
// CUDA thread, std::barrier for __syncthreads; dynamic shared memory is a
// per-block buffer of NaNs with a guard band after it (an overrun fails the
// launch). See emulate.py.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdio>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct emu_dim { unsigned x; };
inline thread_local emu_dim threadIdx, blockIdx, blockDim;
using std::max;
using std::min;
inline void sincospif(float x, float* s, float* c) {
  const double a = M_PI * static_cast<double>(x);
  *s = static_cast<float>(std::sin(a));
  *c = static_cast<float>(std::cos(a));
}
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K> inline int cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
inline int cudaSetDevice(int) { return 0; }
namespace emu {
inline int last_error = 0;
inline thread_local float2* g_smem = nullptr;
inline thread_local std::barrier<>* g_bar = nullptr;
inline long long smem_bytes_max = 232448;
template <class K, class... A>
void launch(K kernel, int grid, int threads, int smem, cudaStream_t, A... args) {
  if (threads < 1 || threads > 1024 || smem > smem_bytes_max) { last_error = 9; return; }
  const int n = smem / 8;
  for (int b = 0; b < grid; ++b) {
    std::vector<float2> shm(n + 64, {NAN, NAN});
    const float guard = 12345.f;
    for (int i = n; i < n + 64; ++i) shm[i] = {guard, guard};
    std::barrier<> bar(threads);
    std::vector<std::thread> ts;
    ts.reserve(threads);
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx.x = t; blockIdx.x = b; blockDim.x = threads;
        g_smem = shm.data(); g_bar = &bar;
        kernel(args...);
        bar.arrive_and_drop();
      });
    for (auto& th : ts) th.join();
    for (int i = n; i < n + 64; ++i)
      if (shm[i].x != guard || shm[i].y != guard) { std::fprintf(stderr, "smem overrun block %d\n", b); last_error = 77; }
  }
}
}  // namespace emu
inline void __syncthreads() { emu::g_bar->arrive_and_wait(); }
inline int cudaGetLastError() { int e = emu::last_error; emu::last_error = 0; return e; }
