// Backward of the online-softmax attention: flash_attention_bwd.
//
// Replaces no TPU kernel: the reference has no backward kernel. Its model
// attention is the jnp function src/repro/models/attention.py:29
// (flash_attention), differentiated by XLA; the port runs its forward on
// csrc/flash_attention.cu, so the gradient needs a kernel of its own.
//
// With P = softmax(scale q k^T, masked) recomputed from each query row's
// logsumexp (written by the forward), and dO the output's cotangent:
//   delta = rowsum(dO o O),  dV = P^T dO,  dP = dO V^T,
//   dS = P o (dP - delta),   dQ = scale dS K,  dK = scale dS^T Q.
// The scores and P never reach device memory.
//
// Bound on an H100: operations. Each unmasked (query, key) pair costs 6 D
// + 4 Dv flops (the scores again, dP, dV, dQ, dK); at llama3.2-3b's D =
// Dv = 128 that is some 300 flops for every byte of q, k, v, o, dO and the
// three gradients. This first version runs them as float32 FMAs on the
// CUDA cores (67 TFLOP/s on an H100 SXM): the tensor cores, TMA and
// wgmma are later work (ROADMAP).
//
// Design: two kernels, one launch of the C entry, no atomics, so the
// result is the same bits on every run (remat and a resumed run repeat
// them):
// * flash_bwd_dq_kernel: a block takes one (query tile, batch-head),
//   writes delta for its rows (read again by the second kernel), and walks
//   the key tiles its rows see, accumulating dQ in registers;
// * flash_bwd_dkdv_kernel: a block takes one (key tile, batch-head) and
//   walks the query tiles that see its keys, accumulating dK and dV.
// Each recomputes the tile's scores and dP. A tile is BT = 16 T rows (T 4,
// or 2 where D or Dv exceeds 128, so shared memory holds the tiles at 256);
// 256 threads as 16 x 16, thread (ty, tx) owning rows ty + 16 i and
// columns tx + 16 j of each product, so that in a warp the row operand is
// a broadcast and the column operand 16 consecutive banks (rows padded to
// an odd number of floats). Operands are staged in shared memory, the
// accumulators live in registers (DM / 16 columns a row, DM the head width
// rounded up to 32, 64, 128 or 256).
//
// Masks as in the forward: causal (key <= query), the window (key > query
// - window), keys past Sk. A row that sees no key (only with a window,
// query > Sk + window - 2) took in the forward the mean of the padded keys'
// values: acc = sum of v over Sk keys, divided by sk_pad. Its P is then
// 1 / sk_pad on every real key and its scores get no gradient (dS = 0):
// dV gains dO / sk_pad there and dQ nothing. The dK/dV kernel visits the
// query tiles that hold such rows for every key tile.
//
// No inline PTX and no warp shuffles: tools/cuda_emu runs this file on the
// CPU (tests/test_torch_flash_attention_bwd.py).
#include <cuda_runtime.h>

#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace repro {
namespace {

constexpr int kBwdThreads = 256;

// Rows of a tile per thread: 4 (64-row tiles), 2 at head width 256.
__host__ __device__ constexpr int bwd_t(int dm) { return dm > 128 ? 2 : 4; }

// Floats of each kernel's shared memory at (d, dv) for width instance dm.
__host__ __device__ constexpr int bwd_dq_floats(int d, int dv, int dm) {
  return 16 * bwd_t(dm) * (2 * (d + 1) + 2 * (dv + 1) + 16 * bwd_t(dm) + 1 + 2);
}
__host__ __device__ constexpr int bwd_dkdv_floats(int d, int dv, int dm) {
  return 16 * bwd_t(dm) * (2 * (d + 1) + 2 * (dv + 1) + 2 * (16 * bwd_t(dm) + 1) + 2);
}

// The keys query row q sees: [lo, hi] (lo > hi: none).
struct Visible {
  int lo, hi;
};

__device__ __forceinline__ Visible visible(long long q, int sk, int causal, int has_window,
                                           int window) {
  Visible v;
  v.lo = has_window ? static_cast<int>(min(static_cast<long long>(INT_MAX),
                                           max(0LL, q - window + 1)))
                    : 0;
  v.hi = causal ? static_cast<int>(min(static_cast<long long>(sk - 1), q)) : sk - 1;
  return v;
}

// Copies `rows` rows of `cols` floats (row-major at src) into shared rows
// of stride ld; rows at or past `avail` are zeros.
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, int cols, int rows,
                                      int avail) {
  for (int i = threadIdx.x; i < rows * cols; i += kBwdThreads) {
    const int r = i / cols;
    const int c = i - r * cols;
    dst[r * ld + c] = r < avail ? src[static_cast<size_t>(r) * cols + c] : 0.f;
  }
}

// acc[i][j] = sum_c a[ty + 16 i][c] * b[tx + 16 j][c] over `width` columns.
template <int T>
__device__ __forceinline__ void dots(float (&acc)[T][T], const float* a, int lda, const float* b,
                                     int ldb, int width, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < T; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < width; ++c) {
    float av[T], bv[T];
#pragma unroll
    for (int i = 0; i < T; ++i) av[i] = a[(ty + 16 * i) * lda + c];
#pragma unroll
    for (int j = 0; j < T; ++j) bv[j] = b[(tx + 16 * j) * ldb + c];
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int j = 0; j < T; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// out[i][j] += sum_n w[n][ty + 16 i] * m[n][tx + 16 j] over `count` rows n
// (w transposed: rows n of the weights), for the columns below `width`.
template <int T, int NC>
__device__ __forceinline__ void accumulate_t(float (&out)[T][NC], const float* w, int ldw,
                                             const float* m, int ldm, int count, int width,
                                             int ty, int tx) {
  for (int n = 0; n < count; ++n) {
    float wv[T];
#pragma unroll
    for (int i = 0; i < T; ++i) wv[i] = w[n * ldw + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = tx + 16 * j;
      if (col < width) {
        const float mv = m[n * ldm + col];
#pragma unroll
        for (int i = 0; i < T; ++i) out[i][j] = fmaf(wv[i], mv, out[i][j]);
      }
    }
  }
}

// dQ for one (query tile, batch-head); writes delta of its rows.
template <int DM>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ o, const float* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta, float* __restrict__ dq,
    int n_heads, int sq, int sk, int d, int dv, int causal, int has_window, int window,
    float scale) {
  constexpr int T = bwd_t(DM);
  constexpr int BT = 16 * T;
  constexpr int NC = DM / 16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldd = d + 1, ldv = dv + 1, lds = BT + 1;
  float* qs = smem;
  float* dos = qs + BT * ldd;
  float* ks = dos + BT * ldv;
  float* vs = ks + BT * ldd;
  float* ds = vs + BT * ldv;
  float* lse_s = ds + BT * lds;
  float* delta_s = lse_s + BT;

  const int bh = blockIdx.x % n_heads;
  const int q0 = static_cast<int>(blockIdx.x / n_heads) * BT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qoff = static_cast<size_t>(bh) * sq;
  const float* kh = k + static_cast<size_t>(bh) * sk * d;
  const float* vh = v + static_cast<size_t>(bh) * sk * dv;

  stage(qs, ldd, q + (qoff + q0) * d, d, BT, sq - q0);
  stage(dos, ldv, dout + (qoff + q0) * dv, dv, BT, sq - q0);
  __syncthreads();
  // delta = rowsum(dO o O), one thread a row, in column order.
  for (int r = threadIdx.x; r < BT; r += kBwdThreads) {
    float acc = 0.f;
    if (q0 + r < sq) {
      const float* orow = o + (qoff + q0 + r) * dv;
      for (int c = 0; c < dv; ++c) acc = fmaf(dos[r * ldv + c], orow[c], acc);
      delta[qoff + q0 + r] = acc;
      lse_s[r] = lse[qoff + q0 + r];
    } else {
      lse_s[r] = 0.f;
    }
    delta_s[r] = acc;
  }

  // Key tiles any row of the tile sees.
  const int q_last = min(q0 + BT, sq) - 1;
  const int lo = has_window ? static_cast<int>(max(0LL, static_cast<long long>(q0) - window + 1))
                            : 0;
  const int hi = causal ? min(sk - 1, q_last) : sk - 1;
  Visible see[T];
#pragma unroll
  for (int i = 0; i < T; ++i) see[i] = visible(q0 + ty + 16 * i, sk, causal, has_window, window);

  float acc[T][NC];
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  for (int k0 = lo - lo % BT; k0 <= hi && lo <= hi; k0 += BT) {
    __syncthreads();  // every thread is done with the last tile's K and dS
    stage(ks, ldd, kh + static_cast<size_t>(k0) * d, d, BT, sk - k0);
    stage(vs, ldv, vh + static_cast<size_t>(k0) * dv, dv, BT, sk - k0);
    __syncthreads();
    float s[T][T], dp[T][T];
    dots<T>(s, qs, ldd, ks, ldd, d, ty, tx);
    dots<T>(dp, dos, ldv, vs, ldv, dv, ty, tx);
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool keep = kpos >= see[i].lo && kpos <= see[i].hi;
        const float p = keep ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        ds[r * lds + tx + 16 * j] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    // dQ[r][c] += sum_n dS[r][n] K[n][c]: dS read by rows, so stage it
    // transposed in the product (w[n][r] = dS[r][n]).
    for (int n = 0; n < BT; ++n) {
      float wv[T];
#pragma unroll
      for (int i = 0; i < T; ++i) wv[i] = ds[(ty + 16 * i) * lds + n];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = tx + 16 * j;
        if (col < d) {
          const float kv = ks[n * ldd + col];
#pragma unroll
          for (int i = 0; i < T; ++i) acc[i][j] = fmaf(wv[i], kv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = tx + 16 * j;
      if (col < d) dq[(qoff + row) * d + col] = acc[i][j] * scale;
    }
  }
}

// dK and dV for one (key tile, batch-head).
template <int DM>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv_out,
    int n_heads, int sq, int sk, int d, int dv, int causal, int has_window, int window,
    float scale, int sk_pad) {
  constexpr int T = bwd_t(DM);
  constexpr int BT = 16 * T;
  constexpr int NC = DM / 16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldd = d + 1, ldv = dv + 1, lds = BT + 1;
  float* ks = smem;
  float* vs = ks + BT * ldd;
  float* qs = vs + BT * ldv;
  float* dos = qs + BT * ldd;
  float* ps = dos + BT * ldv;
  float* ds = ps + BT * lds;
  float* lse_s = ds + BT * lds;
  float* delta_s = lse_s + BT;

  const int bh = blockIdx.x % n_heads;
  const int k0 = static_cast<int>(blockIdx.x / n_heads) * BT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qoff = static_cast<size_t>(bh) * sq;
  const size_t koff = static_cast<size_t>(bh) * sk;

  stage(ks, ldd, k + (koff + k0) * d, d, BT, sk - k0);
  stage(vs, ldv, v + (koff + k0) * dv, dv, BT, sk - k0);

  // Query rows that see a key of this tile: [q_lo, q_hi]; rows that see
  // no key at all (from q_blind on) take every key tile's values.
  const int k_last = min(k0 + BT, sk) - 1;
  long long q_lo = causal ? k0 : 0;
  long long q_hi = has_window ? static_cast<long long>(k_last) + window - 1 : sq - 1;
  q_hi = min(q_hi, static_cast<long long>(sq - 1));
  long long q_blind = has_window ? max(0LL, static_cast<long long>(sk) + window - 1) : sq;
  if (q_blind < sq) q_hi = sq - 1;
  const float blind_p = 1.f / static_cast<float>(sk_pad);

  float acc_k[T][NC], acc_v[T][NC];
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      acc_k[i][j] = 0.f;
      acc_v[i][j] = 0.f;
    }

  for (long long qt = q_lo - q_lo % BT; qt <= q_hi; qt += BT) {
    const int q0 = static_cast<int>(qt);
    __syncthreads();  // every thread is done with the last tile's Q, dO, P and dS
    stage(qs, ldd, q + (qoff + q0) * d, d, BT, sq - q0);
    stage(dos, ldv, dout + (qoff + q0) * dv, dv, BT, sq - q0);
    for (int r = threadIdx.x; r < BT; r += kBwdThreads) {
      const bool real = q0 + r < sq;
      lse_s[r] = real ? lse[qoff + q0 + r] : 0.f;
      delta_s[r] = real ? delta[qoff + q0 + r] : 0.f;
    }
    __syncthreads();
    float s[T][T], dp[T][T];
    dots<T>(s, qs, ldd, ks, ldd, d, ty, tx);
    dots<T>(dp, dos, ldv, vs, ldv, dv, ty, tx);
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int r = ty + 16 * i;
      const long long qpos = q0 + r;
      const Visible see = visible(qpos, sk, causal, has_window, window);
      const bool real_row = qpos < sq;
      const bool blind = see.lo > see.hi;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool keep = real_row && kpos >= see.lo && kpos <= see.hi;
        float p = keep ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        if (real_row && blind && kpos < sk) p = blind_p;
        ps[r * lds + tx + 16 * j] = p;
        ds[r * lds + tx + 16 * j] = keep ? p * (dp[i][j] - delta_s[r]) : 0.f;
      }
    }
    __syncthreads();
    accumulate_t<T, NC>(acc_v, ps, lds, dos, ldv, BT, dv, ty, tx);
    accumulate_t<T, NC>(acc_k, ds, lds, qs, ldd, BT, d, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= sk) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = tx + 16 * j;
      if (col < d) dk[(koff + key) * d + col] = acc_k[i][j] * scale;
      if (col < dv) dv_out[(koff + key) * dv + col] = acc_v[i][j];
    }
  }
}

template <int DM>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* o,
                       const float* dout, const float* lse, float* delta, float* dq, float* dk,
                       float* dvo, int bh, int sq, int sk, int d, int dv, int causal,
                       int has_window, int window, float scale, int sk_pad, int smem_dq,
                       int smem_dkdv, cudaStream_t stream) {
  constexpr int BT = 16 * bwd_t(DM);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<DM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv);
  if (err != cudaSuccess) return err;
  const int q_blocks = (sq + BT - 1) / BT * bh;
  flash_bwd_dq_kernel<DM><<<q_blocks, kBwdThreads, smem_dq, stream>>>(
      q, k, v, o, dout, lse, delta, dq, bh, sq, sk, d, dv, causal, has_window, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int k_blocks = (sk + BT - 1) / BT * bh;
  flash_bwd_dkdv_kernel<DM><<<k_blocks, kBwdThreads, smem_dkdv, stream>>>(
      q, k, v, dout, lse, delta, dk, dvo, bh, sq, sk, d, dv, causal, has_window, window, scale,
      sk_pad);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q (bh, sq, d), k (bh, sk, d), v (bh, sk, dv), o and dout (bh, sq, dv),
// lse (bh, sq): float32, contiguous. delta (bh, sq) is scratch; dq, dk, dv
// take the gradients. dm: the width instance (32, 64, 128 or 256, the
// smallest covering d and dv); threads and the two kernels' shared memory
// as the wrapper's census gives them.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv_out, int bh,
                                         int sq, int sk, int d, int dv, int causal,
                                         int has_window, int window, float scale, int sk_pad,
                                         int dm, int threads, int smem_dq, int smem_dkdv,
                                         int device, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || d < 1 || d > 256 || dv < 1 || dv > 256 || sk_pad < sk ||
      static_cast<long long>((sq + 31) / 32) * bh > INT_MAX ||
      static_cast<long long>((sk + 31) / 32) * bh > INT_MAX)
    return cudaErrorInvalidValue;
  const int want = d > 128 || dv > 128 ? 256 : d > 64 || dv > 64 ? 128 : d > 32 || dv > 32 ? 64 : 32;
  if (threads != repro::kBwdThreads || dm != want ||
      smem_dq != repro::bwd_dq_floats(d, dv, dm) * static_cast<int>(sizeof(float)) ||
      smem_dkdv != repro::bwd_dkdv_floats(d, dv, dm) * static_cast<int>(sizeof(float)))
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_BWD_CASE(N)                                                                     \
  case N:                                                                                     \
    return repro::launch_bwd<N>(                                                              \
        static_cast<const float*>(q), static_cast<const float*>(k),                           \
        static_cast<const float*>(v), static_cast<const float*>(o),                           \
        static_cast<const float*>(dout), static_cast<const float*>(lse),                      \
        static_cast<float*>(delta), static_cast<float*>(dq), static_cast<float*>(dk),         \
        static_cast<float*>(dv_out), bh, sq, sk, d, dv, causal, has_window, window, scale,    \
        sk_pad, smem_dq, smem_dkdv, s);
  switch (dm) {
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(128)
    REPRO_BWD_CASE(256)
    default:
      return cudaErrorInvalidConfiguration;
  }
#undef REPRO_BWD_CASE
}
