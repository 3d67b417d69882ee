// Forward attention with an online softmax: flash_attention_fwd.
//
// Replaces src/repro/kernels/flash_attention.py: flash_attention_fwd (:81,
// pallas_call at :107, body _kernel at :32).
//
// Bound on an H100: operations. Each unmasked (query, key) pair costs 2 D
// flops for the score and 2 Dv for the weighted value; at llama3.2-3b's
// D = Dv = 128 that is about 250 flops for every byte of q, k, v and
// output. The products run on the tensor cores as TF32 `mma.sync` tiles
// (m16n8k8). One TF32 product keeps 11 significant bits, which leaves
// causal attention at D = 128 over the port's 2e-5 gate (relative to
// max|ref|; tests/test_torch_flash_attention.py shows it on the CPU, in
// an emulation of this arithmetic). So every float32 operand x is split
// into big (a TF32 value) and small = x - big (exact in float32),
// and one float32 product becomes three TF32 products, small*big +
// big*small first and big*big last, all summed in float32 accumulators.
// What is dropped, small*small and the bits of small below TF32's, is some
// 2^-21 of the product, so the result stays a float32 result (3.6e-6 of
// max|plain| at llama's shape in chip_smoke.py, inside the gate). This is
// the route PyTorch's own float32 attention takes on sm80 and later
// (OpMultiplyAddFastF32 in its memory-efficient kernel). big is x with
// its low 13 bits cleared (truncation, one AND) rather than rounded to
// nearest as cvt.rna does: small then carries the difference exactly, the
// error is of the same size, and the split, which runs once for every
// fragment element a warp reads, costs two instructions instead of four.
// The output accumulator takes each 8-key slice's three products as one
// sum from zero, added on the CUDA cores (mma_split_add): chained through
// the tensor core over every slice, it drifted with the core's truncation
// to 1.8e-5 of max|out| over 1500 keys (5.4e-6 so; on an H100, 4-7% more
// time at llama's and zamba2's shapes, 2% at whisper's encoder, none at
// its cross-attention: tools/flash_ab.py).
// The least time for the work is the flops over a third of the dense TF32
// rate (495 / 3 = 165 TFLOP/s on an H100 SXM): 0.625 ms for llama3.2-3b's
// 24 heads of 4096 causal tokens.
//
// Design: a block of 4 warps takes one (query tile, batch-head) and walks
// its key tiles of 32 keys; blocks are numbered so that the last query
// tile of every head starts first, the causal mask's heaviest. Each warp
// owns 32 query rows (two 16-row m-tiles, so each K and V fragment it
// reads and splits feeds six products), 16 where Dv > 128 (the output
// accumulator of 32 rows would not fit in registers); a query tile is
// 128 rows, or 64. Its scores for a key tile, its running max m and sum l
// and its output accumulator stay in mma fragments in registers: a lane
// holds rows g and g + 8 of each m-tile (g = lane / 4), so a row's max and
// sum take two xor shuffles and no barrier. The score fragment feeds the
// PV product as it stands: within each 8-key slice the accumulator holds
// keys 2t and 2t + 1 (t = lane % 4) where the A operand wants k-columns t
// and t + 4, so k-column t is key 2t and t + 4 is key 2t + 1, and V's B
// fragment is read in that order (rows 8j + 2t and 8j + 2t + 1); only the
// order of the sum over keys moves. Q and K fragments come from shared
// memory by ldmatrix (four 8 x 4-float matrices per instruction), V's by
// 4-byte loads. D and Dv are padded to multiples of 8 with zeros in
// shared memory, and shared rows by 4 more floats, so that 16-byte copies
// stay aligned and the fragment reads fall in 32 distinct banks. K and V
// come in with cp.async (16 bytes where the row length is a multiple of 4
// and the base aligned, else 4 bytes) into one buffer each: K of tile j+1
// loads while the softmax and PV product of tile j run, and V of tile j+1
// while the scores of tile j+1 run; two barriers per key tile. At
// D = Dv = 128 a block takes 101,376 bytes of shared memory, so two
// blocks (8 warps) share an SM.
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
//
// Query offset. Row r of q sits at position q = q_offset + r, as in the
// reference model's flash_attention (src/repro/models/attention.py:29,
// q_offset=): a context-parallel rank holds the queries of its slice of
// the sequence and every key (flash_attention_cp). The offset moves each
// row's key range, the block's tile range and the test above; positions
// are long long where the offset is added, and key ranges are clamped to
// [0, Sk) before they become ints.
#include <cuda_runtime.h>

#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace repro {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1.0e30f;

// 16-row m-tiles per warp: 2, or 1 where Dv > 128 (the output
// accumulator of two would not fit in registers).
__host__ __device__ constexpr int m_tiles(int dv) { return dv > 128 ? 1 : 2; }

// Query rows per block: 16 per m-tile of each of the 4 warps.
__host__ __device__ constexpr int query_tile(int dv) { return kWarps * 16 * m_tiles(dv); }

constexpr int kBK = 32;  // keys per tile

// Output accumulator n-tiles of 8 columns: the smallest power of two
// covering Dv (1 to 32).
__host__ __device__ constexpr int acc_tiles(int dv) {
  return dv <= 8 ? 1 : dv <= 16 ? 2 : dv <= 32 ? 4 : dv <= 64 ? 8 : dv <= 128 ? 16 : 32;
}

__host__ __device__ constexpr int flash_smem_floats(int d, int dv) {
  return (query_tile(dv) + kBK) * (round8(d) + kPad) + kBK * (round8(dv) + kPad);
}

// Starts the copy of `rows` rows of `cols` floats (row-major, from src)
// into dst with row stride ld; rows at or past `avail` are zero-filled.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, int cols,
                                          int rows, int avail, bool vec) {
  if (vec) {
    const int per_row = cols >> 2;
    for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
      const int r = i / per_row;
      const int c = (i - r * per_row) << 2;
      const bool ok = r < avail;
      cp_async16(dst + r * ld + c, ok ? src + static_cast<size_t>(r) * cols + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols;
      const int c = i - r * cols;
      const bool ok = r < avail;
      cp_async4(dst + r * ld + c, ok ? src + static_cast<size_t>(r) * cols + c : src, ok);
    }
  }
}

template <int NV>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
    const float* __restrict__ k,
    const float* __restrict__ v,
    float* __restrict__ o,
    float* __restrict__ lse,
    int n_heads,
    int sq,
    int sk,
    int d,
    int dv,
    int causal,
    int has_window,
    int window,
    long long q_offset,
    float scale,
    int sk_pad,
    int vec_qk,
    int vec_v) {
  constexpr int MT = NV > 16 ? 1 : 2;  // 16-row m-tiles per warp, m_tiles(dv)
  constexpr int BQ = kWarps * 16 * MT;
  constexpr int BK = kBK;
  constexpr int NK = BK / 8;  // 8-key slices of a key tile
  constexpr int R = 2 * MT;   // rows per lane: g + 8i of each m-tile
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d8 = round8(d);
  const int ldk = d8 + kPad;
  const int ldv = round8(dv) + kPad;
  const int nv_used = round8(dv) / 8;
  float* qs = smem;
  float* ks = qs + BQ * ldk;
  float* vs = ks + BK * ldk;

  // Block b takes query tile (last - b / n_heads) of head b % n_heads.
  const int bh = blockIdx.x % n_heads;
  const int q0 = ((sq + BQ - 1) / BQ - 1 - static_cast<int>(blockIdx.x / n_heads)) * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 * MT;
  const float* qh = q + static_cast<size_t>(bh) * sq * d;
  const float* kh = k + static_cast<size_t>(bh) * sk * d;
  const float* vh = v + static_cast<size_t>(bh) * sk * dv;
  float* oh = o + static_cast<size_t>(bh) * sq * dv;

  // Key tiles: [t_lo, t_hi) when every real row of the tile sees a key,
  // else all of them (see the note at the top of the file). Row r sits at
  // position q_offset + r (a context-parallel rank's slice of the queries).
  const long long q_first = q_offset + q0;
  const long long q_last = q_offset + min(q0 + BQ, sq) - 1;
  const bool every_row_sees_a_key =
      !has_window || (q_last - window + 1 <= sk - 1 && (!causal || window >= 1));
  int t_lo = 0;
  int t_hi = (sk + BK - 1) / BK;
  if (every_row_sees_a_key) {
    const long long lo = has_window ? max(0LL, q_first - window + 1) : 0;
    const long long hi = causal ? min(static_cast<long long>(sk - 1), q_last) : sk - 1;
    t_lo = static_cast<int>(lo / BK);
    t_hi = static_cast<int>(hi / BK) + 1;
  }

  // The keys each of this lane's rows sees: [key_lo, key_hi]. Row ri is
  // r0 + 16 (ri / 2) + g + 8 (ri % 2).
  int key_lo[R], key_hi[R];
#pragma unroll
  for (int ri = 0; ri < R; ++ri) {
    const long long qpos = q_first + r0 + 8 * ri + g;
    key_lo[ri] = has_window ? static_cast<int>(min(static_cast<long long>(INT_MAX),
                                                   max(0LL, qpos - window + 1)))
                            : 0;
    key_hi[ri] = causal ? static_cast<int>(min(static_cast<long long>(sk - 1), qpos)) : sk - 1;
  }

  zero_pad<kThreads>(qs, ldk, d, BQ);
  zero_pad<kThreads>(ks, ldk, d, BK);
  zero_pad<kThreads>(vs, ldv, dv, BK);
  load_tile(qs, ldk, qh + static_cast<size_t>(q0) * d, d, BQ, sq - q0, vec_qk);
  load_tile(ks, ldk, kh + static_cast<size_t>(t_lo) * BK * d, d, BK, sk - t_lo * BK, vec_qk);
  cp_async_commit();
  load_tile(vs, ldv, vh + static_cast<size_t>(t_lo) * BK * dv, dv, BK, sk - t_lo * BK, vec_v);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  float acc[MT][NV][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  float m[R], l[R];
#pragma unroll
  for (int ri = 0; ri < R; ++ri) {
    m[ri] = kNegInf;
    l[ri] = 0.f;
  }

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int k0 = tile * BK;
    const bool more = tile + 1 < t_hi;

    // Scores of the warp's rows against the tile's BK keys.
    float s[MT][NK][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < d8; kk += 8) {
      uint32_t a_big[MT][4], a_small[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, qs + (r0 + 16 * mt + (lane & 15)) * ldk + kk + 4 * (lane >> 4));
#pragma unroll
        for (int e = 0; e < 4; ++e) split(__uint_as_float(a[e]), a_big[mt][e], a_small[mt][e]);
      }
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        uint32_t b[4], b_big[4], b_small[4];
        ldmatrix_x4(b, ks + (8 * n + 8 * (lane >> 4) + (lane & 7)) * ldk + kk +
                           4 * ((lane >> 3) & 1));
#pragma unroll
        for (int e = 0; e < 4; ++e) split(__uint_as_float(b[e]), b_big[e], b_small[e]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t bb[2] = {b_big[2 * h], b_big[2 * h + 1]};
          const uint32_t bs[2] = {b_small[2 * h], b_small[2 * h + 1]};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_split(s[mt][n + h], a_big[mt], a_small[mt], bb, bs);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // V of this tile has landed; every warp is done with K
    if (more) {
      load_tile(ks, ldk, kh + static_cast<size_t>(k0 + BK) * d, d, BK, sk - k0 - BK, vec_qk);
      cp_async_commit();
    }

    // Mask and scale (NEG_INF, as the TPU kernel), then the online softmax
    // of each row over its quad of lanes.
    float mx[R], corr[R], sum[R];
#pragma unroll
    for (int ri = 0; ri < R; ++ri) {
      mx[ri] = kNegInf;
      sum[ri] = 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = 2 * mt + (e >> 1);
          const int kpos = k0 + 8 * n + 2 * t + (e & 1);
          const bool keep = kpos >= key_lo[ri] && kpos <= key_hi[ri];
          s[mt][n][e] = keep ? s[mt][n][e] * scale : kNegInf;
          mx[ri] = fmaxf(mx[ri], s[mt][n][e]);
        }
#pragma unroll
    for (int ri = 0; ri < R; ++ri) {
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 1));
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 2));
      const float m_new = fmaxf(m[ri], mx[ri]);
      corr[ri] = expf(m[ri] - m_new);
      m[ri] = m_new;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = 2 * mt + (e >> 1);
          s[mt][n][e] = expf(s[mt][n][e] - m[ri]);
          sum[ri] += s[mt][n][e];
        }
#pragma unroll
    for (int ri = 0; ri < R; ++ri) {
      sum[ri] += __shfl_xor_sync(0xffffffffu, sum[ri], 1);
      sum[ri] += __shfl_xor_sync(0xffffffffu, sum[ri], 2);
      l[ri] = l[ri] * corr[ri] + sum[ri];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] *= corr[2 * mt + (e >> 1)];

    // acc += P V: k-column t of slice j is key 8j + 2t, k-column t + 4 is
    // key 8j + 2t + 1.
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      uint32_t p_big[MT][4], p_small[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split(s[mt][j][0], p_big[mt][0], p_small[mt][0]);
        split(s[mt][j][2], p_big[mt][1], p_small[mt][1]);
        split(s[mt][j][1], p_big[mt][2], p_small[mt][2]);
        split(s[mt][j][3], p_big[mt][3], p_small[mt][3]);
      }
      const float* vb = vs + (8 * j + 2 * t) * ldv + g;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        if (n < nv_used) {
          uint32_t b_big[2], b_small[2];
          split(vb[8 * n], b_big[0], b_small[0]);
          split(vb[ldv + 8 * n], b_big[1], b_small[1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_split_add(acc[mt][n], p_big[mt], p_small[mt], b_big, b_small);
        }
      }
    }
    if (more) {
      cp_async_wait<0>();
      __syncthreads();  // K of the next tile has landed; every warp is done with V
      load_tile(vs, ldv, vh + static_cast<size_t>(k0 + BK) * dv, dv, BK, sk - k0 - BK, vec_v);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int ri = 0; ri < R; ++ri) {
    const int row = q0 + r0 + 8 * ri + g;
    if (row >= sq) continue;
    const float denom = fmaxf(m[ri] == kNegInf ? static_cast<float>(sk_pad) : l[ri], 1e-20f);
    // Each row's logsumexp, for the backward (m + log l; -1e30 where the
    // row sees no key), only when the caller asks: serving passes null.
    if (lse != nullptr && t == 0)
      lse[static_cast<size_t>(bh) * sq + row] = m[ri] + logf(denom);
    float* out = oh + static_cast<size_t>(row) * dv;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * n + 2 * t + c;
        if (col < dv) out[col] = acc[ri >> 1][n][2 * (ri & 1) + c] / denom;
      }
  }
}

template <int NV>
cudaError_t launch_flash(const float* q, const float* k, const float* v, float* o, float* lse,
                         int bh,
                         int sq, int sk, int d, int dv, int causal, int has_window, int window,
                         long long q_offset, float scale, int sk_pad, int vec_qk, int vec_v,
                         int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_kernel<NV>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int bq = query_tile(dv);
  const int blocks = (sq + bq - 1) / bq * bh;
  flash_attention_kernel<NV><<<blocks, kThreads, smem, stream>>>(
      q, k, v, o, lse, bh, sq, sk, d, dv, causal, has_window, window, q_offset, scale, sk_pad,
      vec_qk, vec_v);
  return cudaGetLastError();
}

template <int NV>
int occupancy(int smem) {
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_attention_kernel<NV>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_attention_kernel<NV>,
                                                        kThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
}  // namespace repro

// q (bh, sq, d), k (bh, sk, d), v (bh, sk, dv), o (bh, sq, dv): float32,
// contiguous; lse (bh, sq) float32 takes each row's logsumexp, or is null.
// Query row r sits at position q_offset + r (>= 0; the masks compare it
// with the key positions 0 .. sk - 1). nv: output accumulator n-tiles of 8
// columns, the smallest power of two covering dv; threads and smem as the
// wrapper's census gives them.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* lse, int bh, int sq, int sk, int d, int dv, int causal,
                                         int has_window, int window, long long q_offset,
                                         float scale, int sk_pad, int nv, int threads, int smem,
                                         int device, void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1 || d < 1 || d > 256 || dv < 1 || dv > 256 ||
      sk_pad < sk || q_offset < 0 || q_offset > INT_MAX ||
      static_cast<long long>((sq + 63) / 64) * bh > INT_MAX)
    return cudaErrorInvalidValue;
  if (threads != repro::kThreads || nv != repro::acc_tiles(dv) ||
      smem != repro::flash_smem_floats(d, dv) * static_cast<int>(sizeof(float)))
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(o);
  auto* lp = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  const int vec_qk = d % 4 == 0 && repro::aligned16(q) && repro::aligned16(k);
  const int vec_v = dv % 4 == 0 && repro::aligned16(v);
#define REPRO_FLASH_CASE(N)                                                                  \
  case N:                                                                                    \
    return repro::launch_flash<N>(qp, kp, vp, op, lp, bh, sq, sk, d, dv, causal, has_window, \
                                  window, q_offset, scale, sk_pad, vec_qk, vec_v, smem, s);
  switch (nv) {
    REPRO_FLASH_CASE(1)
    REPRO_FLASH_CASE(2)
    REPRO_FLASH_CASE(4)
    REPRO_FLASH_CASE(8)
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    default:
      return cudaErrorInvalidConfiguration;
  }
#undef REPRO_FLASH_CASE
}

// Blocks of the kernel instance for dv that one SM holds at once, with
// smem bytes each (from the occupancy calculator); a negative value is a
// CUDA error.
extern "C" int repro_flash_attention_occupancy(int dv, int smem, int device) {
  if (dv < 1 || dv > 256) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  switch (repro::acc_tiles(dv)) {
    case 1: return repro::occupancy<1>(smem);
    case 2: return repro::occupancy<2>(smem);
    case 4: return repro::occupancy<4>(smem);
    case 8: return repro::occupancy<8>(smem);
    case 16: return repro::occupancy<16>(smem);
    default: return repro::occupancy<32>(smem);
  }
}
