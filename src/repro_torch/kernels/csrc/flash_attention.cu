// Forward attention with an online softmax: flash_attention_fwd.
//
// Replaces src/repro/kernels/flash_attention.py: flash_attention_fwd (:81,
// pallas_call at :107, body _kernel at :32).
//
// Bound on an H100: float32 operations. Each unmasked (query, key) pair
// costs 2 D flops for the score and 2 Dv for the weighted value; at
// llama3.2-3b's D = Dv = 128 that is about 250 flops for every byte of q,
// k, v and output, far above the card's 67 TFLOP/s over 3.35 TB/s. This
// first kernel runs those flops as float32 FMAs on the CUDA cores, not on
// the tensor cores (TF32 would keep three decimal digits, and the numbers
// must stay the TPU kernel's float32 ones), so it cannot approach the
// bound; wgmma and TMA are later work.
//
// Design: one block of 256 threads (16 x 16) per (query tile of 64 rows,
// batch-head); the grid walks query tiles last to first so that the
// causal mask's heaviest tiles start first. The block keeps its Q tile in
// shared memory and loops over key tiles of 64: it stages K and V, each
// thread computes a 4 x 4 patch of scores (rows ty*4+i, keys tx+16j),
// masks them with NEG_INF = -1e30 exactly as the TPU kernel does, and four
// threads per row carry the running max m and sum l; each thread keeps a
// 4 x (16 NJ) patch of the accumulator (columns tx+16j) in registers.
// K rows are padded to D+1 floats so the 16 keys a warp reads sit in 16
// banks.
//
// Which key tiles are visited. The TPU kernel visits every key block, and
// a key block that is fully masked for a row either comes after a key the
// row sees (it then adds exp(-1e30 - m) = 0 and leaves m and l as they
// are, bit for bit) or before every such key (its p = 1 values are then
// multiplied by exp(-1e30 - m) = 0 when the first seen key arrives). So a
// tile that is fully masked for every row of the block changes no row that
// sees at least one key, and the kernel skips it. A row that sees no key
// at all (only with a window, when q > Sk + window - 2) ends in the TPU
// kernel with acc = sum of v and l = Sk padded to block_k; a query tile
// that holds such a row visits every key tile, and the row divides by that
// padded Sk (sk_pad, from the wrapper) as the TPU kernel does.
#include <cuda_runtime.h>

#include <math.h>

namespace repro {
namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1.0e30f;

__host__ __device__ constexpr int flash_smem_floats(int d, int dv) {
  return (kBQ + kBK) * (d + 1) + kBK * dv + kBQ * (kBK + 1) + 3 * kBQ;
}

template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
    const float* __restrict__ k,
    const float* __restrict__ v,
    float* __restrict__ o,
    int sq,
    int sk,
    int d,
    int dv,
    int causal,
    int has_window,
    int window,
    float scale,
    int sk_pad) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int ldp = kBK + 1;
  float* qs = smem;
  float* ks = qs + kBQ * ld;
  float* vs = ks + kBK * ld;
  float* ps = vs + kBK * dv;
  float* row_m = ps + kBQ * ldp;
  float* row_l = row_m + kBQ;
  float* row_c = row_l + kBQ;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float* qh = q + static_cast<size_t>(bh) * sq * d;
  const float* kh = k + static_cast<size_t>(bh) * sk * d;
  const float* vh = v + static_cast<size_t>(bh) * sk * dv;
  float* oh = o + static_cast<size_t>(bh) * sq * dv;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    qs[r * ld + c] = q0 + r < sq ? qh[static_cast<size_t>(q0 + r) * d + c] : 0.f;
  }
  if (tid < kBQ) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // Key tiles: [t_lo, t_hi) when every real row of the tile sees a key,
  // else all of them (see the note at the top of the file).
  const long long q_last = min(q0 + kBQ, sq) - 1;
  const bool every_row_sees_a_key =
      !has_window || (q_last - window + 1 <= sk - 1 && (!causal || window >= 1));
  int t_lo = 0;
  int t_hi = (sk + kBK - 1) / kBK;
  if (every_row_sees_a_key) {
    const long long lo = has_window ? max(0LL, static_cast<long long>(q0) - window + 1) : 0;
    const long long hi = causal ? min(static_cast<long long>(sk - 1), q_last) : sk - 1;
    t_lo = static_cast<int>(lo / kBK);
    t_hi = static_cast<int>(hi / kBK) + 1;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d;
      const int c = i - r * d;
      ks[r * ld + c] = k0 + r < sk ? kh[static_cast<size_t>(k0 + r) * d + c] : 0.f;
    }
    for (int i = tid; i < kBK * dv; i += kThreads) {
      const int r = i / dv;
      vs[i] = k0 + r < sk ? vh[static_cast<size_t>(k0) * dv + i] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const long long qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool keep = kpos < sk;
        if (causal) keep = keep && kpos <= qpos;
        if (has_window) keep = keep && kpos > qpos - window;
        ps[r * ldp + tx + 16 * j] = keep ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    {  // online softmax: four neighbouring lanes per row
      const int r = tid >> 2;
      const int part = tid & 3;
      float* pr = ps + r * ldp;
      float mx = kNegInf;
      for (int c = part; c < kBK; c += 4) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < kBK; c += 4) {
        const float p = expf(pr[c] - m_new);
        pr[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        row_c[r] = corr;
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = row_c[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
      float p[4], w[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * ldp + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        w[j] = col < dv ? vs[c * dv + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= sq) continue;
    const float l = row_m[r] == kNegInf ? static_cast<float>(sk_pad) : row_l[r];
    const float denom = fmaxf(l, 1e-20f);
    float* out = oh + static_cast<size_t>(q0 + r) * dv;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < dv) out[col] = acc[i][j] / denom;
    }
  }
}

template <int NJ>
cudaError_t launch_flash(const float* q, const float* k, const float* v, float* o, int bh,
                         int sq, int sk, int d, int dv, int causal, int has_window, int window,
                         float scale, int sk_pad, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  flash_attention_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, sq, sk, d, dv, causal, has_window, window, scale, sk_pad);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q (bh, sq, d), k (bh, sk, d), v (bh, sk, dv), o (bh, sq, dv): float32,
// contiguous. nj: accumulator columns per thread / 16 (1, 2, 4, 8 or 16,
// with dv <= 16 nj); threads and smem as the wrapper's census gives them.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         int bh, int sq, int sk, int d, int dv, int causal,
                                         int has_window, int window, float scale, int sk_pad,
                                         int nj, int threads, int smem, int device,
                                         void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1 || d < 1 || d > 256 || dv < 1 || dv > 256 ||
      sk_pad < sk)
    return cudaErrorInvalidValue;
  if (threads != repro::kThreads || dv > 16 * nj ||
      smem != repro::flash_smem_floats(d, dv) * static_cast<int>(sizeof(float)))
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(o);
  auto s = static_cast<cudaStream_t>(stream);
  switch (nj) {
    case 1:
      return repro::launch_flash<1>(qp, kp, vp, op, bh, sq, sk, d, dv, causal, has_window,
                                    window, scale, sk_pad, smem, s);
    case 2:
      return repro::launch_flash<2>(qp, kp, vp, op, bh, sq, sk, d, dv, causal, has_window,
                                    window, scale, sk_pad, smem, s);
    case 4:
      return repro::launch_flash<4>(qp, kp, vp, op, bh, sq, sk, d, dv, causal, has_window,
                                    window, scale, sk_pad, smem, s);
    case 8:
      return repro::launch_flash<8>(qp, kp, vp, op, bh, sq, sk, d, dv, causal, has_window,
                                    window, scale, sk_pad, smem, s);
    case 16:
      return repro::launch_flash<16>(qp, kp, vp, op, bh, sq, sk, d, dv, causal, has_window,
                                     window, scale, sk_pad, smem, s);
    default:
      return cudaErrorInvalidConfiguration;
  }
}
