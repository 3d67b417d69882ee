// One-trip FFT of rows over one block on a thread-block cluster:
// fft_fused, rfft_fused and irfft_fused at radix 4 on rows of
// 2^14 < N <= 2^18.
//
// Replaces, over those rows (src/repro/kernels/fft_radix2.py):
//   fft_fused   (:279, pallas_call at :299)  complex (B, N) -> (B, N)
//   rfft_fused  (:319, pallas_call at :340)  real (B, N) -> (B, N/2+1)
//   irfft_fused (:358, pallas_call at :379)  (B, N/2+1) -> real (B, N)
// The Pallas kernels hold a whole row in VMEM and read and write it once.
// A Hopper block holds at most 227 KB and a row of 2^18 complex values is
// 2 MiB; a cluster of C CTAs on neighbouring SMs holds the row across
// their shared memories, each CTA reaching its peers' through distributed
// shared memory (DSMEM).
//
// Bound on an H100: HBM bytes, as for fft_fused.cu. This kernel reads each
// row once and writes it once, for the complex and the real kinds alike,
// in one launch (fft_two_pass.cu, which radix 2 keeps, moves a complex row
// through HBM twice and a real row three times). DSMEM is no faster than
// HBM (on the card an exchange of the row through it took about as long as
// an HBM trip), so the design crosses the cluster once, and reads HBM in
// whole 32-byte sectors.
//
// Design. A row of m complex values (a real row of N: its m = N/2 values
// packed two for one, as fft_fused.cu reads them) is m = A Q: A lines
// a < A of Q values, line a holding x[a + A n], and
//   X[q + Q k] = sum_a W_A^(a k) W_m^(a q) Y_a[q],
//   Y_a[q] = sum_n W_Q^(n q) x[a + A n],   q < Q, k < A.
// CTA c of the row's cluster holds the P lines a = Pc ... Pc+P-1 (P = 4,
// or 8 at C = 2; A = PC = 16, 32 or 64).
// 1. Load. CTA c reads its lines straight from HBM: for each n the run
//    x[An + Pc ... An + Pc + P), 32 bytes (64 at C = 2), whole sectors; value
//    j of the run goes to line j. The lines sit in shared memory at a
//    stride of Q + 16/P values, which spreads the 16 values a half-warp
//    writes over 16 bank pairs. An inverse conjugates here; irfft
//    untangles here from Y[n] and the mirrored run Y[m - n].
// 2. The register-pass panel of stockham_regs.cuh runs over the P lines,
//    shared memory to shared memory: its first pass reads that layout, its
//    last leaves Y_a[q] at a line stride of Q + 16/L (below).
// 3. Exchange and store. After a cluster barrier, L = A/16 neighbouring
//    lanes take one q: lane a1 < L reads Y_a[q] for a = a1 + L a2, a2 < 16
//    (at C = 16 one line of every CTA), each read instruction L runs of
//    32/L consecutive values of one CTA, free of bank conflicts at that
//    line stride. It multiplies each by W_m^(a q) (the
//    panel's ROM W_Q^(e/A) times a table of W_m^(e mod A), e = a q < m: no
//    product of more than two rounded twiddles), runs the 16-point DFT over
//    a2 in registers, multiplies output k2 by W_A^(a1 k2), and the L lanes
//    finish the L-point DFT over a1 by shuffles (lane a1 ends with output
//    k1 = a1 at L = 2, its bit reversal at L = 4): X[q + Q (k2 + 16 k1)],
//    stored as runs of 16/L consecutive values. An inverse conjugates and
//    scales here. For rfft, the lanes of q and of Q - q sit 16 apart in a
//    warp, and Z[m - k] is the other's output (15 - k2, L-1 - k1): each
//    lane takes its partner's value by shuffle, recombines its own bins in
//    registers and stores them (rising and falling runs); q = 0 and Q/2
//    pair within their own lanes, and q = 0 also stores the Nyquist bin. A
//    last cluster barrier keeps each CTA's shared memory alive until its
//    peers have read it.
//
// Geometry: one instance per (C, M, kind), so every stride and shift is a
// constant. M = PQ = 2^13 (two CTAs an SM) with C = 2, 4, 8, 16 (m = 2^14
// to 2^17; 16 is a non-portable cluster size, and at m = 2^17 it timed
// faster than C = 8 at M = 2^14); M = 2^14 (one CTA an SM) with C = 16 at
// m = 2^18. The lines are Q = 2^10 to 2^12 values, three register passes
// each. The host census
// (repro_torch/kernels/fft_radix2.py: cluster_geometry) picks one and the
// C entry checks it.
#include <climits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fft_common.cuh"
#include "stockham_regs.cuh"

namespace repro {
namespace {

namespace cg = cooperative_groups;

enum Kind : int { kFft = 0, kRfft = 1, kIrfft = 2 };

constexpr int kMinLogM = 13;
constexpr int kMaxLogM = 14;
constexpr int kMaxLogC = 4;

// A cluster barrier: every thread of every CTA arrives (release: its
// shared-memory writes, local or remote, become visible), then waits
// (acquire). Split in two where work fits between the halves.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__host__ __device__ constexpr int cluster_threads(int log_m) {
  return (1 << log_m) / regs::kValues;
}

// Two CTAs an SM at M = 2^13 (512 threads, 64 registers each), one at 2^14.
__host__ __device__ constexpr int cluster_min_blocks(int log_m) {
  return log_m <= kMinLogM ? 2 : 1;
}

// Lines one CTA holds: 8 at C = 2, else 4 (each run of the load a whole
// 32-byte sector).
__host__ __device__ constexpr int cluster_cta_lines(int ctas) { return ctas == 2 ? 8 : 4; }

// Shared memory of one CTA (the census's smem): its M values and the
// panel's ROM of Q/2 twiddles, each padded, the A twiddles W_m^t and the
// 128 twiddles W_128^p.
__host__ __device__ constexpr int cluster_smem_bytes(int ctas, int values) {
  return (regs::padded(values) + regs::padded(values / cluster_cta_lines(ctas) / 2) +
          ctas * cluster_cta_lines(ctas) + 128) *
         static_cast<int>(sizeof(float2));
}

// Lines at a stride of STRIDE values: the panel's first pass reads them as
// the load left them, its last pass writes them for the exchange.
template <int STRIDE>
struct StridedLines {
  static constexpr bool kShared = true;
  float2* buf;

  template <int R>
  __device__ __forceinline__ void read(int line, int t, int s, float2* v, bool ok) const {
    if (!ok) line = t = 0;
    const float2* p = buf + line * STRIDE + t;
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = p[j * s];
  }

  template <int R>
  __device__ __forceinline__ void write(int line, int pos, int l, const float2* v, bool ok) const {
    if (!ok) return;
    float2* p = buf + line * STRIDE + pos;
#pragma unroll
    for (int c = 0; c < R; ++c) p[c * l] = v[regs::out_reg<R>(c)];
  }
};

__device__ __forceinline__ float2 shfl(float2 z, int src) {
  return make_float2(__shfl_sync(0xffffffffu, z.x, src), __shfl_sync(0xffffffffu, z.y, src));
}

// The L-point DFT over a1 = lane mod L of the L lanes that share a q: lane
// a1 ends with output a1 (L = 2) or with output bitrev(a1) (L = 4, two
// radix-2 layers, decimation in frequency).
template <int L>
__device__ __forceinline__ float2 lane_dft(float2 z, int lane, int a1) {
  if constexpr (L == 2) {
    const float2 o = shfl(z, lane ^ 1);
    return a1 == 0 ? cadd(z, o) : csub(o, z);
  } else {
    float2 o = shfl(z, lane ^ 2);
    if (a1 < 2) {
      z = cadd(z, o);
    } else {
      z = csub(o, z);
      if (a1 == 3) z = make_float2(z.y, -z.x);  // times W_4 = -i
    }
    o = shfl(z, lane ^ 1);
    return (a1 & 1) == 0 ? cadd(z, o) : csub(o, z);
  }
}

// x, y: rows of m = 2^(LOG_C + LOG_M) complex values (kFft: out =
// conj_out(FFT(conj_in x)) * scale; kRfft: x the packed real rows, y the
// (B, m+1) half spectra; kIrfft: x the (B, m+1) half spectra, y the packed
// real rows, scaled by `scale` = 1/m). Grid: B C blocks in clusters of C.
template <int LOG_C, int LOG_M, int KIND>
__global__ void __launch_bounds__(cluster_threads(LOG_M), cluster_min_blocks(LOG_M))
fft_cluster_kernel(const float2* __restrict__ x,
    float2* __restrict__ y,
    int conj,
    float scale) {
  using regs::kValues;
  using regs::out_reg;
  constexpr int LOG_ROW = LOG_C + LOG_M;
  constexpr int m = 1 << LOG_ROW;
  constexpr int M = 1 << LOG_M;
  constexpr int P = cluster_cta_lines(1 << LOG_C);  // lines of one CTA
  constexpr int LOG_P = P == 8 ? 3 : 2;
  constexpr int LOG_A = LOG_P + LOG_C;
  constexpr int A = 1 << LOG_A;  // lines of the row
  constexpr int LOG_L = LOG_A - 4;
  constexpr int L = 1 << LOG_L;  // lanes that share one q
  constexpr int LOG_Q = LOG_ROW - LOG_A;
  constexpr int Q = 1 << LOG_Q;
  constexpr int T = cluster_threads(LOG_M);
  constexpr int QC = Q >> LOG_C;  // the q of one CTA
  constexpr int LOAD_STRIDE = Q + 16 / P;  // line stride as loaded
  constexpr int LINE_STRIDE = Q + 16 / L;  // line stride after the panel
  static_assert(P * Q == M && QC * L == T && kValues == 16 && L <= 4, "geometry");
  extern __shared__ float2 smem[];
  float2* buf = smem;  // the lines: as loaded, the panel's layouts, as left
  float2* rom = smem + regs::padded(M);  // W_Q^j, j < Q/2, padded
  float2* fine = rom + regs::padded(Q / 2);  // W_m^t, t < A
  float2* w128 = fine + A;  // W_128^p, p < 128
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const long long row = static_cast<long long>(blockIdx.x) >> LOG_C;
  const int tid = threadIdx.x;

  // 1. Load: value i of the CTA is value j = i mod P of the run n = i / P.
  float2 v[kValues];
  if constexpr (KIND == kIrfft) {
    const float2* half = x + row * (m + 1);
#pragma unroll
    for (int s = 0; s < kValues; ++s) {
      const int i = tid + s * T;
      const int k = ((i >> LOG_P) << LOG_A) + r * P + (i & (P - 1));
      float2 yk = half[k];
      float2 ym = half[m - k];
      if (k == 0) {  // DC and Nyquist bins of a Hermitian spectrum are real
        yk.y = 0.f;
        ym.y = 0.f;
      }
      float sn, cs;
      sincospif(-static_cast<float>(k) / static_cast<float>(m), &sn, &cs);  // W_2m^k
      v[s] = cconj(irfft_untangle(yk, cconj(ym), make_float2(cs, -sn)));
    }
  } else {
    const float2* src = x + (row << LOG_ROW) + r * P;
#pragma unroll
    for (int s = 0; s < kValues; ++s) {
      const int i = tid + s * T;
      v[s] = src[((i >> LOG_P) << LOG_A) + (i & (P - 1))];
    }
  }
  regs::build_rom(rom, Q / 2);
  for (int t = tid; t < A + 128; t += T) {
    float sn, cs;
    sincospif(t < A ? -2.0f * static_cast<float>(t) / static_cast<float>(m)
                    : -static_cast<float>(t - A) / 64.0f, &sn, &cs);
    fine[t] = make_float2(cs, sn);
  }
#pragma unroll
  for (int s = 0; s < kValues; ++s) {
    const int i = tid + s * T;
    buf[(i & (P - 1)) * LOAD_STRIDE + (i >> LOG_P)] = conj ? cconj(v[s]) : v[s];
  }
  __syncthreads();

  // 2. The lines' Q-point FFTs, shared memory to shared memory.
  regs::panel<LOG_Q, LOG_Q - 1>(buf, M, rom, StridedLines<LOAD_STRIDE>{buf},
                                StridedLines<LINE_STRIDE>{buf});
  cluster_arrive();  // every Y_a is complete
  cluster_wait();

  // 3. The A-point DFTs across the cluster, and the store. L lanes take a
  // q: r QC + tid / L, or for rfft the pair (p, Q - p) 16 lanes apart (p = 0
  // with Q/2).
  const int lane = tid & 31;
  const int a1 = tid & (L - 1);
  int q = r * QC + (tid >> LOG_L);
  if constexpr (KIND == kRfft) {
    const int p = r * (QC / 2) + (tid >> 5) * (16 / L) + ((lane & 15) >> LOG_L);
    q = lane < 16 ? p : (p == 0 ? Q / 2 : Q - p);
  }
#pragma unroll
  for (int a2 = 0; a2 < 16; ++a2) {
    const int a = a1 + L * a2;
    const float2* peer = cluster.map_shared_rank(buf, a >> LOG_P);
    v[a2] = peer[(a & (P - 1)) * LINE_STRIDE + q];
  }
  cluster_arrive();  // done with the peers' shared memory
#pragma unroll
  for (int a2 = 0; a2 < 16; ++a2) {
    const int e = (a1 + L * a2) * q;  // W_m^e = W_Q^(e / A) W_m^(e mod A)
    v[a2] = cmul(v[a2], cmul(regs::rom_twiddle(rom, e >> LOG_A, Q / 2), fine[e & (A - 1)]));
  }
  regs::dft<16>(v);
  const int k1 = L == 4 ? ((a1 & 1) << 1) | (a1 >> 1) : a1;
  if constexpr (L > 1) {
#pragma unroll
    for (int k2 = 0; k2 < 16; ++k2) {
      float2& z = v[out_reg<16>(k2)];
      z = lane_dft<L>(cmul(z, w128[(8 / L) * a1 * k2]), lane, a1);  // W_A^(a1 k2)
    }
  }
  if constexpr (KIND == kRfft) {
    // Y[k] = Xe + w Xo from Z[k] and conj Z[m-k], k = q + Q kA, kA = k2 +
    // 16 k1, w = W_2m^k = W_2m^q W_128^((4/L) kA). Z[m-k] is output
    // (15 - k2, L-1 - k1) of the partner's q, or for q = 0 output
    // ((16 - k2) mod 16, ...) of its own.
    float2* out = y + row * (m + 1);
    float sn, cs;
    sincospif(-static_cast<float>(q) / static_cast<float>(m), &sn, &cs);
    const float2 wq = make_float2(cs, sn);
    const int zero_a1 = a1 < 2 ? a1 : a1 ^ 1;  // k1 -> (L - k1) mod L at L = 4
#pragma unroll
    for (int k2 = 0; k2 < 16; ++k2) {
      const float2 send = q == 0 ? v[out_reg<16>((16 - k2) & 15)] : v[out_reg<16>(15 - k2)];
      int src = lane ^ (16 | (L - 1));
      if (q == Q / 2 || (q == 0 && k2 != 0)) src = lane ^ (L - 1);
      if (q == 0 && k2 == 0) src = (lane & ~(L - 1)) | (L == 4 ? zero_a1 : a1);
      const float2 zm = shfl(send, src);
      const int ka = k2 + 16 * k1;
      out[q + Q * ka] = regs::recombine(v[out_reg<16>(k2)], cconj(zm),
                                        cmul(wq, w128[(4 / L) * ka]));
    }
    if (q == 0 && a1 == 0) out[m] = regs::recombine(v[0], cconj(v[0]), make_float2(-1.f, 0.f));
  } else {
    const bool conj_out = KIND == kIrfft || conj;
    float2* out = y + (row << LOG_ROW);
#pragma unroll
    for (int k2 = 0; k2 < 16; ++k2) {
      const float2 z = v[out_reg<16>(k2)];
      out[q + Q * (k2 + 16 * k1)] = make_float2(z.x * scale, (conj_out ? -z.y : z.y) * scale);
    }
  }
  cluster_wait();
}

using ClusterKernel = void (*)(const float2*, float2*, int, float);

template <int LOG_C, int LOG_M>
ClusterKernel cluster_kernel_of_kind(int kind) {
  switch (kind) {
    case kFft: return fft_cluster_kernel<LOG_C, LOG_M, kFft>;
    case kRfft: return fft_cluster_kernel<LOG_C, LOG_M, kRfft>;
    case kIrfft: return fft_cluster_kernel<LOG_C, LOG_M, kIrfft>;
    default: return nullptr;
  }
}

// The instances: (C, M) = (2, 4, 8, 16; 2^13) and (16; 2^14).
ClusterKernel cluster_kernel(int log_c, int log_m, int kind) {
  if (log_m == 13) {
    switch (log_c) {
      case 1: return cluster_kernel_of_kind<1, 13>(kind);
      case 2: return cluster_kernel_of_kind<2, 13>(kind);
      case 3: return cluster_kernel_of_kind<3, 13>(kind);
      case 4: return cluster_kernel_of_kind<4, 13>(kind);
      default: return nullptr;
    }
  }
  return log_m == 14 && log_c == 4 ? cluster_kernel_of_kind<4, 14>(kind) : nullptr;
}

// The census the host computed (cluster_geometry) must be one of the
// instances: C M = m, M/16 threads, and the CTA's shared memory.
ClusterKernel checked_kernel(int m, int kind, int ctas, int values, int threads, int smem) {
  if (!is_pow2(m) || !is_pow2(ctas) || !is_pow2(values) || ctas < 2 ||
      ctas > (1 << kMaxLogC) || values < (1 << kMinLogM) || values > (1 << kMaxLogM) ||
      static_cast<long long>(ctas) * values != m || threads != cluster_threads(host_log2(values)) ||
      smem != cluster_smem_bytes(ctas, values))
    return nullptr;
  return cluster_kernel(host_log2(ctas), host_log2(values), kind);
}

// Select the device, raise the kernel's dynamic shared memory, allow a
// cluster of 16, and describe the launch: `blocks` blocks in clusters of
// `ctas`.
cudaError_t cluster_config(ClusterKernel kernel, int device, int ctas, int threads, int smem,
                           unsigned blocks, cudaStream_t stream, cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
  cudaError_t err = prepare(kernel, device, smem);
  if (err != cudaSuccess) return err;
  if (ctas > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(ctas);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(static_cast<unsigned>(threads));
  cfg->dynamicSmemBytes = static_cast<size_t>(smem);
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace
}  // namespace repro

using repro::host_log2;
using repro::is_pow2;

extern "C" int repro_fft_cluster(const void* x, void* y, int batch, int m, int kind, int ctas,
                                 int values, int threads, int smem, int conj, float scale,
                                 int device, void* stream) {
  if (batch < 1 || static_cast<long long>(batch) * ctas > INT_MAX) return cudaErrorInvalidValue;
  const auto kernel = repro::checked_kernel(m, kind, ctas, values, threads, smem);
  if (kernel == nullptr) return cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = repro::cluster_config(kernel, device, ctas, threads, smem,
                                          static_cast<unsigned>(batch * ctas),
                                          static_cast<cudaStream_t>(stream), &attr, &cfg);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float2*>(x), static_cast<float2*>(y),
                           conj, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of the instance that the card holds at once
// (cudaOccupancyMaxActiveClusters); a negative value is a CUDA error.
extern "C" int repro_fft_cluster_occupancy(int m, int kind, int ctas, int values, int threads,
                                           int smem, int device) {
  const auto kernel = repro::checked_kernel(m, kind, ctas, values, threads, smem);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidConfiguration);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = repro::cluster_config(kernel, device, ctas, threads, smem,
                                          static_cast<unsigned>(ctas), nullptr, &attr, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : clusters;
}
