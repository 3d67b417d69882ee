// CPU emulation of the CUDA subset the port's kernels use: one std::thread
// per CUDA thread, std::barrier for __syncthreads; dynamic shared memory is
// a per-block buffer of NaNs with a guard band after it (an overrun fails
// the launch). A cooperative launch (cudaLaunchKernelEx with
// cudaLaunchAttributeCooperative) runs every block's threads at once, so a
// grid barrier on atomics works as on the card; any other launch runs the
// blocks one after another. Warp-wide instructions the kernels write as
// inline PTX (mma_m8n8k4, the TF32 mma_tf32, ldmatrix_x4, __shfl_xor_sync)
// have stand-ins here, on a barrier per warp, and so do the cp.async
// copies; the kernels leave theirs out where REPRO_CUDA_EMU is defined.
// See emulate.py.
#pragma once
#define REPRO_CUDA_EMU 1
#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_dim { unsigned x; };
inline thread_local emu_dim threadIdx, blockIdx, blockDim, gridDim;
using std::max;
using std::min;
inline void sincospif(float x, float* s, float* c) {
  const double a = M_PI * static_cast<double>(x);
  *s = static_cast<float>(std::sin(a));
  *c = static_cast<float>(std::cos(a));
}
// Loads through a cache level are plain loads here; the grid barrier's
// atomics (cuda/atomic beside this file) order them.
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) { return *p; }
inline unsigned __float_as_uint(float x) {
  unsigned u;
  std::memcpy(&u, &x, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float x;
  std::memcpy(&x, &u, 4);
  return x;
}
// Cycles of a 2 GHz clock.
inline long long clock64() {
  return 2 * std::chrono::duration_cast<std::chrono::nanoseconds>(
                 std::chrono::steady_clock::now().time_since_epoch()).count();
}
[[noreturn]] inline void __trap() {
  std::fprintf(stderr, "__trap\n");
  std::abort();
}
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaErrorCooperativeLaunchTooLarge = 720,
};
typedef void* cudaStream_t;
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributePreferredSharedMemoryCarveout,
};
enum { cudaSharedmemCarveoutMaxShared = 100 };
template <class K> inline int cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
inline int cudaSetDevice(int) { return 0; }
// One block an SM: the emulator's "card" holds any grid of one-block SMs.
template <class K>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, K, int, size_t) {
  *blocks = 1;
  return 0;
}
enum cudaLaunchAttributeID { cudaLaunchAttributeCooperative = 2 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  union { int cooperative; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
namespace emu {
inline int last_error = 0;
inline thread_local float2* g_smem = nullptr;
inline thread_local std::barrier<>* g_bar = nullptr;
inline thread_local std::barrier<>* g_warp_bar = nullptr;  // the thread's warp
inline thread_local double* g_warp_buf = nullptr;          // kWarpBuf doubles a warp
inline thread_local long long g_smem_bytes = 0;
constexpr int kWarpBuf = 256;
inline thread_local unsigned g_warp_calls = 0;  // the thread's warp-wide stand-in calls
// Scratch for one warp-wide call: the two halves of the warp's buffer in
// turn. Every lane makes the same calls in the same order, so one barrier
// a call is enough: a lane writes a half again only two calls later, after
// every lane has passed the barrier of the call between, and so has read.
inline double* warp_slot() { return g_warp_buf + (kWarpBuf / 2) * (g_warp_calls++ & 1); }
// A fault a stand-in found (a misaligned or out-of-bounds shared access);
// the launch returns it.
inline std::atomic<int> fault{0};
inline long long smem_bytes_max = 232448;
// Blocks a cooperative launch may hold at once (threads are OS threads).
inline int cooperative_blocks_max = 64;

// Run blocks first .. first + count - 1 of `grid`, all their threads at once.
template <class F>
void run_blocks(int first, int count, int grid, int threads, long long smem, F body) {
  const int n = static_cast<int>((smem + 7) / 8);
  const float guard = 12345.f;
  const int warps = (threads + 31) / 32;
  std::vector<std::vector<float2>> shm(count);
  std::vector<std::barrier<>*> bars, warp_bars;
  std::vector<double> warp_buf(static_cast<size_t>(count) * warps * kWarpBuf);
  for (auto& s : shm) {
    s.assign(n + 64, {NAN, NAN});
    for (int i = n; i < n + 64; ++i) s[i] = {guard, guard};
    bars.push_back(new std::barrier<>(threads));
    for (int w = 0; w < warps; ++w) warp_bars.push_back(new std::barrier<>(min(32, threads - 32 * w)));
  }
  std::vector<std::thread> ts;
  ts.reserve(static_cast<size_t>(count) * threads);
  for (int k = 0; k < count; ++k)
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, k, t] {
        threadIdx.x = t; blockIdx.x = first + k; blockDim.x = threads; gridDim.x = grid;
        g_smem = shm[k].data(); g_smem_bytes = smem; g_bar = bars[k];
        g_warp_bar = warp_bars[k * warps + t / 32];
        g_warp_buf = warp_buf.data() + (static_cast<size_t>(k) * warps + t / 32) * kWarpBuf;
        body();
        bars[k]->arrive_and_drop();
        g_warp_bar->arrive_and_drop();
      });
  for (auto& th : ts) th.join();
  for (auto* b : warp_bars) delete b;
  if (const int f = fault.exchange(0)) last_error = f;
  for (int k = 0; k < count; ++k) {
    delete bars[k];
    for (int i = n; i < n + 64; ++i)
      if (shm[k][i].x != guard || shm[k][i].y != guard) {
        std::fprintf(stderr, "smem overrun block %d\n", first + k);
        last_error = 77;
      }
  }
}

template <class K, class... A>
void launch(K kernel, int grid, int threads, int smem, cudaStream_t, A... args) {
  if (threads < 1 || threads > 1024 || smem > smem_bytes_max) { last_error = 9; return; }
  for (int b = 0; b < grid; ++b) run_blocks(b, 1, grid, threads, smem, [&] { kernel(args...); });
}
}  // namespace emu
template <class... P, class... A>
int cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(P...), A&&... args) {
  const int grid = static_cast<int>(cfg->gridDim.x), threads = static_cast<int>(cfg->blockDim.x);
  const long long smem = static_cast<long long>(cfg->dynamicSmemBytes);
  if (threads < 1 || threads > 1024 || smem > emu::smem_bytes_max) return cudaErrorInvalidConfiguration;
  bool cooperative = false;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    cooperative |= cfg->attrs[i].id == cudaLaunchAttributeCooperative && cfg->attrs[i].val.cooperative;
  const auto body = [&] { kernel(args...); };
  if (!cooperative) {
    for (int b = 0; b < grid; ++b) emu::run_blocks(b, 1, grid, threads, smem, body);
  } else {
    if (grid > emu::cooperative_blocks_max) return cudaErrorCooperativeLaunchTooLarge;
    emu::run_blocks(0, grid, grid, threads, smem, body);
  }
  const int e = emu::last_error;
  emu::last_error = 0;
  return e;
}
inline void __syncthreads() { emu::g_bar->arrive_and_wait(); }
// mma.sync m8n8k4 f64 (C += A B, 8 x 8 x 4) over the 32 lanes of a warp:
// lane l holds A[l / 4][l % 4], B[l % 4][l / 4], C[l / 4][2 (l % 4) + {0, 1}].
inline void mma_m8n8k4(double& c0, double& c1, double a, double b) {
  const int lane = static_cast<int>(threadIdx.x % 32);
  double* buf = emu::g_warp_buf;
  buf[lane] = a;
  buf[32 + lane] = b;
  emu::g_warp_bar->arrive_and_wait();
  const int r = lane / 4, c = 2 * (lane % 4);
  for (int k = 0; k < 4; ++k) {
    c0 += buf[4 * r + k] * buf[32 + 4 * c + k];
    c1 += buf[4 * r + k] * buf[32 + 4 * (c + 1) + k];
  }
  emu::g_warp_bar->arrive_and_wait();
}
// mma.sync m16n8k8 TF32 (C += A B, 16 x 8 x 8, A row-major, B column-major)
// over the 32 lanes of a warp: lane l holds A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4], B[t][g], B[t+4][g] and C[g][2t], C[g][2t+1], C[g+8][2t],
// C[g+8][2t+1] (g = l / 4, t = l % 4). The tensor core reads the top 19
// bits of each operand (a TF32 value) and ignores the low 13, so this does
// too; the products are summed in double and rounded once to float32.
inline void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const int lane = static_cast<int>(threadIdx.x % 32), g = lane / 4, t = lane % 4;
  auto* A = reinterpret_cast<uint32_t*>(emu::warp_slot());  // 16 x 8
  uint32_t* B = A + 128;                                    // 8 x 8, B[k][n]
  A[g * 8 + t] = a[0];
  A[(g + 8) * 8 + t] = a[1];
  A[g * 8 + t + 4] = a[2];
  A[(g + 8) * 8 + t + 4] = a[3];
  B[t * 8 + g] = b0;
  B[(t + 4) * 8 + g] = b1;
  emu::g_warp_bar->arrive_and_wait();
  const auto tf32 = [](uint32_t x) { return static_cast<double>(__uint_as_float(x & 0xffffe000u)); };
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), n = 2 * t + (e & 1);
    double s = c[e];
    for (int k = 0; k < 8; ++k) s += tf32(A[r * 8 + k]) * tf32(B[k * 8 + n]);
    c[e] = static_cast<float>(s);
  }
}
namespace emu {
// Faults unless `bytes` at p lie in the block's shared memory, aligned to `align`.
inline void check_shared(const void* p, int bytes, int align, const char* what) {
  const auto off = reinterpret_cast<const char*>(p) - reinterpret_cast<const char*>(g_smem);
  if (off < 0 || off + bytes > g_smem_bytes || off % align != 0) {
    std::fprintf(stderr, "%s: shared offset %lld (%d bytes, align %d) outside %lld bytes\n", what,
                 static_cast<long long>(off), bytes, align, g_smem_bytes);
    fault = 79;
  }
}
}  // namespace emu
// ldmatrix.m8n8.x4.b16 on 32-bit words: lane l gives the address of row l % 8
// of matrix l / 8 (16 aligned bytes of shared memory) and receives word
// (l / 4, l % 4) of each matrix.
inline void ldmatrix_x4(uint32_t (&r)[4], const float* row) {
  const int lane = static_cast<int>(threadIdx.x % 32);
  emu::check_shared(row, 16, 16, "ldmatrix");
  auto** rows = reinterpret_cast<const float**>(emu::warp_slot());
  rows[lane] = row;
  emu::g_warp_bar->arrive_and_wait();
  for (int m = 0; m < 4; ++m) std::memcpy(&r[m], rows[8 * m + lane / 4] + lane % 4, 4);
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int mask) {
  static_assert(sizeof(T) <= 8, "one 8-byte slot a lane");
  const int lane = static_cast<int>(threadIdx.x % 32);
  auto* buf = reinterpret_cast<char*>(emu::warp_slot());
  std::memcpy(buf + 8 * lane, &v, sizeof(T));
  emu::g_warp_bar->arrive_and_wait();
  T out;
  std::memcpy(&out, buf + 8 * (lane ^ mask), sizeof(T));
  return out;
}
// cp.async: each copy is held back until a cp.async.wait_group lets its
// group land (then copied, or zero-filled where the source size is 0), so a
// read of a tile before its wait sees the old contents, as on the card.
namespace emu {
struct AsyncCopy {
  long long group;
  float* dst;
  const float* src;
  int bytes;
  bool ok;
};
inline thread_local std::vector<AsyncCopy> g_async;
inline thread_local long long g_groups = 0;  // committed groups
}  // namespace emu
inline void cp_async16(float* dst, const float* src, bool ok) {
  emu::check_shared(dst, 16, 16, "cp.async 16");
  emu::g_async.push_back({emu::g_groups, dst, src, 16, ok});
}
inline void cp_async4(float* dst, const float* src, bool ok) {
  emu::check_shared(dst, 4, 4, "cp.async 4");
  emu::g_async.push_back({emu::g_groups, dst, src, 4, ok});
}
inline void cp_async_commit() { ++emu::g_groups; }
template <int N>
inline void cp_async_wait() {
  auto& q = emu::g_async;
  size_t keep = 0;
  for (auto& c : q) {
    if (c.group < emu::g_groups - N) {
      if (c.ok) std::memcpy(c.dst, c.src, c.bytes);
      else std::memset(c.dst, 0, c.bytes);
    } else {
      q[keep++] = c;
    }
  }
  q.resize(keep);
}
inline int cudaGetLastError() { int e = emu::last_error; emu::last_error = 0; return e; }
