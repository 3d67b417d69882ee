// The sLSTM recurrence over a whole sequence: slstm_scan.
//
// Replaces src/repro/kernels/slstm_scan.py: slstm_scan (:86, pallas_call at
// :98, body _kernel at :29).
//
// Bound on an H100: on paper float32 operations (2 B D^2 flops per step for
// the recurrent product: 69 GFLOP at xlstm-350m's D = 1024, B = 8,
// L = 4096) over bytes (xg read once, hs written once: 675 MB). Neither is
// reachable: step t needs all of h_{t-1}, so the L steps run one after
// another, and each step's product reads the whole of wr (4 heads x D/4 x D
// floats, 4 MiB at D = 1024) again. With one block per batch row that read
// comes from L2 into one SM per row every step; how much of a step's time
// it takes, against the barrier and the gate arithmetic, is not measured.
//
// Design: one block per batch row. The recurrence couples all four heads
// every step, and under the head-major wiring of the reference
// (models/xlstm.py::_slstm_step) head k's product is gate block k
// (i, f, z, o for k = 0..3): unit u's four gates are column u of the four
// heads' products. So thread t owns units u = t, t + T, ... (at most 4):
// it reads column u of wr[k] for each head (neighbouring threads on
// neighbouring addresses), takes h_{t-1} from shared memory, and keeps
// c, n and m of its units in registers for the whole sequence. h is
// double-buffered in shared memory, so one barrier per step suffices.
// m0 = -inf gives f = exp(-inf) = 0 and no NaN, as in the reference.
#include <cuda_runtime.h>

#include <math.h>

namespace repro {
namespace {

constexpr int kHeads = 4;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

template <int U>
__global__ void __launch_bounds__(kMaxThreads)
slstm_scan_kernel(const float* __restrict__ xg,
    const float* __restrict__ wr,
    const float* __restrict__ bias,
    const float* __restrict__ c0,
    const float* __restrict__ n0,
    const float* __restrict__ h0,
    const float* __restrict__ m0,
    float* __restrict__ hs,
    float* __restrict__ cf,
    float* __restrict__ nf,
    float* __restrict__ hf,
    float* __restrict__ mf,
    int len,
    int d) {
  extern __shared__ float hbuf[];  // 2 x d: h_{t-1} and h_t
  const int b = blockIdx.x;
  const int hd = d / kHeads;
  float c[U], n[U], m[U], h[U], bz[U][kHeads];
#pragma unroll
  for (int uu = 0; uu < U; ++uu) {
    const int u = threadIdx.x + uu * blockDim.x;
    if (u < d) {
      const size_t s = static_cast<size_t>(b) * d + u;
      c[uu] = c0[s];
      n[uu] = n0[s];
      m[uu] = m0[s];
      h[uu] = h0[s];
      hbuf[u] = h[uu];
#pragma unroll
      for (int g = 0; g < kHeads; ++g) bz[uu][g] = bias[g * d + u];
    }
  }
  __syncthreads();
  float* hcur = hbuf;
  float* hnext = hbuf + d;
  const float* xrow = xg + static_cast<size_t>(b) * len * kHeads * d;
  float* hrow = hs + static_cast<size_t>(b) * len * d;
  const size_t head_stride = static_cast<size_t>(hd) * d;

  for (int t = 0; t < len; ++t) {
    const float* xt = xrow + static_cast<size_t>(t) * kHeads * d;
#pragma unroll
    for (int uu = 0; uu < U; ++uu) {
      const int u = threadIdx.x + uu * blockDim.x;
      if (u >= d) continue;
      float x[kHeads], a[kHeads];
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        x[g] = xt[g * d + u];
        a[g] = 0.f;
      }
      const float* w = wr + u;
#pragma unroll 4
      for (int kk = 0; kk < hd; ++kk) {
#pragma unroll
        for (int g = 0; g < kHeads; ++g)
          a[g] = fmaf(hcur[g * hd + kk], w[g * head_stride + static_cast<size_t>(kk) * d], a[g]);
      }
      const float it = (x[0] + a[0]) + bz[uu][0];
      const float ft = (x[1] + a[1]) + bz[uu][1];
      const float zt = (x[2] + a[2]) + bz[uu][2];
      const float ot = (x[3] + a[3]) + bz[uu][3];
      const float log_f = log_sigmoid(ft);
      const float m_new = fmaxf(log_f + m[uu], it);
      const float i_sc = expf(it - m_new);
      const float f_sc = expf(log_f + m[uu] - m_new);
      c[uu] = f_sc * c[uu] + i_sc * tanhf(zt);
      n[uu] = f_sc * n[uu] + i_sc;
      m[uu] = m_new;
      h[uu] = sigmoid(ot) * c[uu] / fmaxf(n[uu], 1e-6f);
      hnext[u] = h[uu];
      hrow[static_cast<size_t>(t) * d + u] = h[uu];
    }
    __syncthreads();  // h_t complete; everyone is done reading h_{t-1}
    float* tmp = hcur;
    hcur = hnext;
    hnext = tmp;
  }

#pragma unroll
  for (int uu = 0; uu < U; ++uu) {
    const int u = threadIdx.x + uu * blockDim.x;
    if (u < d) {
      const size_t s = static_cast<size_t>(b) * d + u;
      cf[s] = c[uu];
      nf[s] = n[uu];
      hf[s] = h[uu];
      mf[s] = m[uu];
    }
  }
}

template <int U>
cudaError_t launch_slstm(const float* xg, const float* wr, const float* bias, const float* c0,
                         const float* n0, const float* h0, const float* m0, float* hs, float* cf,
                         float* nf, float* hf, float* mf, int batch, int len, int d, int threads,
                         int smem, cudaStream_t stream) {
  slstm_scan_kernel<U><<<batch, threads, smem, stream>>>(xg, wr, bias, c0, n0, h0, m0, hs, cf,
                                                         nf, hf, mf, len, d);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// xg (batch, len, 4d); wr (4, d/4, d); bias (4d); c0, n0, h0, m0 and the
// final states (batch, d); hs (batch, len, d); all float32, contiguous.
// units = ceil(d / threads) in 1..4, smem = 2 d floats.
extern "C" int repro_slstm_scan(const void* xg, const void* wr, const void* bias, const void* c0,
                                const void* n0, const void* h0, const void* m0, void* hs,
                                void* cf, void* nf, void* hf, void* mf, int batch, int len,
                                int d, int units, int threads, int smem, int device,
                                void* stream) {
  if (batch < 1 || len < 1 || d < repro::kHeads || d % repro::kHeads != 0)
    return cudaErrorInvalidValue;
  if (threads < 32 || threads > repro::kMaxThreads || threads % 32 != 0 ||
      static_cast<long long>(threads) * units < d ||
      static_cast<long long>(threads) * (units - 1) >= d ||
      smem != 2 * d * static_cast<int>(sizeof(float)))
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto g = [](void* p) { return static_cast<float*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  switch (units) {
    case 1:
      return repro::launch_slstm<1>(f(xg), f(wr), f(bias), f(c0), f(n0), f(h0), f(m0), g(hs),
                                    g(cf), g(nf), g(hf), g(mf), batch, len, d, threads, smem, s);
    case 2:
      return repro::launch_slstm<2>(f(xg), f(wr), f(bias), f(c0), f(n0), f(h0), f(m0), g(hs),
                                    g(cf), g(nf), g(hf), g(mf), batch, len, d, threads, smem, s);
    case 3:
      return repro::launch_slstm<3>(f(xg), f(wr), f(bias), f(c0), f(n0), f(h0), f(m0), g(hs),
                                    g(cf), g(nf), g(hf), g(mf), batch, len, d, threads, smem, s);
    case 4:
      return repro::launch_slstm<4>(f(xg), f(wr), f(bias), f(c0), f(n0), f(h0), f(m0), g(hs),
                                    g(cf), g(nf), g(hf), g(mf), batch, len, d, threads, smem, s);
    default:
      return cudaErrorInvalidConfiguration;
  }
}
