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
// three gradients. Every product runs on the tensor cores as the
// forward's do (flash_mma.cuh): TF32 mma.sync m16n8k8, each float32
// operand split into big + small and each float32 product taken as three
// TF32 products, so the gradients stay float32 results. The yardstick is
// the forward's, a third of the dense TF32 rate (165 TFLOP/s).
//
// Design: two passes, one launch of the C entry, no atomics, so the
// result is the same bits on every run (remat and a resumed run repeat
// them). Each pass keeps one tile of 64 rows resident in shared memory and
// streams the other side's tiles past it:
// * the dQ pass: a block takes 64 query rows of one batch-head (Q and dO
//   resident), writes delta for its rows (read by the second pass), and
//   walks the key tiles its rows see (K and V streamed), accumulating dQ;
// * the dK/dV pass: a block takes 64 keys (K and V resident) and walks the
//   query tiles that see them (Q, dO, lse and delta streamed),
//   accumulating dK and dV.
// Both are one kernel template (flash_bwd_kernel). With R1, R2 the
// resident tiles and C1, C2 the streamed ones, a streamed tile costs
//   T1 = R1 C1^T  (the scores: S in the dQ pass, S^T in the dK/dV pass),
//   T2 = R2 C2^T  (dP, or dP^T),
// P and dS elementwise from T1, T2, lse and delta, then
//   acc1 += dS C1 (dQ += dS K, or dK += dS^T Q),  acc2 += P C2 (dV += P^T dO).
// So the dK/dV pass computes S^T = K Q^T and dP^T = V dO^T rather than S
// and dP: P^T and dS^T then come out in the mma's accumulator layout, and
// that is the layout the next product takes as its A operand, as the
// forward's score fragment feeds its PV product (within each 8-row slice
// k-column t is streamed row 2t and t + 4 is row 2t + 1, and the B
// operand is read in that order). No tile is transposed in shared memory.
// A and the T products' B come from shared memory by ldmatrix, the
// accumulating products' B by 4-byte loads in the forward's V order.
//
// 4 warps, each owning 16 resident rows (one m-tile; a lane holds rows g
// and g + 8, g = lane / 4): T1 and T2 take 16 floats a lane at streamed
// tiles of 32 rows, acc1 and acc2 W / 2 each (W the width instance), so
// at W = 128 the two accumulators of the dK/dV pass hold 128 registers.
// At W = 256 they would not fit: there the dK/dV pass is two kernels, one
// accumulating dV (it needs only T1) and one dK, and streamed tiles are 16
// rows. Each streamed tile's accumulating products (three TF32 products for
// each 8-row slice) are summed from zero on the tensor core and that sum is
// added to the accumulator on the CUDA cores: chained through the tensor
// core over every tile, an accumulator drifts with its truncation (the
// forward's output drifted to 1.8e-5 of float64 over 1500 keys so). Those
// products run as interleaved chains over a few n-tiles at once (each
// n-tile alone is a chain of 3 NS dependent mma), as many as the registers
// take; in the dK/dV pass dS is formed from P's split halves after dV's
// product, so P and dS are never held split at once.
//
// Streamed tiles come in by cp.async into one buffer each, as the forward's
// K and V do: C2 of tile j + 1 loads while C1's products of tile j run, and
// C1 of tile j + 1 while T2 of tile j + 1 runs. The dQ pass frees C2 (V)
// after T2 and takes two barriers a tile; the dK/dV pass reads C2 (dO) again
// in acc2 and takes three. At D = Dv = 128 a block holds 101,632 bytes of
// shared memory, so two blocks (8 warps) share an SM.
//
// Masks as in the forward: causal (key <= query), the window (key > query
// - window), keys past Sk, with query row r at position q_offset + r. A row that sees no key (only with a window)
// took in the forward the mean of the padded keys' values: acc = sum of v
// over Sk keys, divided by sk_pad. Its P is then 1 / sk_pad on every real
// key and its scores get no gradient (dS = 0): dV gains dO / sk_pad there
// and dQ nothing. The dK/dV pass visits the query tiles that hold such
// rows for every key tile.
//
// Which tiles are visited: a block walks the streamed tiles any of its
// rows sees (and, in the dK/dV pass, those holding rows that see no key);
// a warp skips the products of a tile that none of its own 16 rows sees,
// which leaves some of the causal diagonal's tiles to fewer warps. The dQ
// pass takes its last query tile first and the dK/dV pass its first key
// tile, so the causal mask's heaviest blocks start first.
#include <cuda_runtime.h>

#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace repro {
namespace {

constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kRes = 16 * kBwdWarps;  // resident rows of a block

// What a block accumulates: dS C1 (acc1), P C2 (acc2), or both.
constexpr int kAccDS = 1;
constexpr int kAccP = 2;
constexpr int kAccBoth = 3;

// Streamed rows a tile at width instance w: 32, or 16 at 256.
__host__ __device__ constexpr int bwd_stream(int w) { return w > 128 ? 16 : 32; }

// Floats of each pass's shared memory at (d, dv): the resident and the
// streamed tiles in padded rows; the dK/dV pass also the streamed queries'
// lse and delta.
__host__ __device__ constexpr int bwd_dq_floats(int d, int dv, int w) {
  return (kRes + bwd_stream(w)) * (round8(d) + kPad + round8(dv) + kPad);
}
__host__ __device__ constexpr int bwd_dkdv_floats(int d, int dv, int w) {
  return bwd_dq_floats(d, dv, w) + 2 * bwd_stream(w);
}

struct BwdArgs {
  const float* q;     // (bh, sq, d)
  const float* k;     // (bh, sk, d)
  const float* v;     // (bh, sk, dv)
  const float* o;     // (bh, sq, dv)
  const float* dout;  // (bh, sq, dv)
  const float* lse;   // (bh, sq)
  float* delta;       // (bh, sq): written by the dQ pass, read by the dK/dV pass
  float* dq;
  float* dk;
  float* dv;
  int n_heads, sq, sk, d1, d2, causal, has_window, window;
  long long q_offset;  // query row r sits at position q_offset + r
  float scale, blind_p;
  int vec1, vec2;  // 16-byte copies of q and k (d1 % 4 == 0, aligned), of v and dO
};

// The keys query row q sees: [key_lo, key_hi] (lo > hi: none).
__device__ __forceinline__ int key_lo(long long q, int has_window, int window) {
  return has_window ? static_cast<int>(min(static_cast<long long>(INT_MAX),
                                           max(0LL, q - window + 1)))
                    : 0;
}
__device__ __forceinline__ int key_hi(long long q, int sk, int causal) {
  return causal ? static_cast<int>(min(static_cast<long long>(sk - 1), q)) : sk - 1;
}

// The first query row that sees no key: every row from it on does (its
// position q_offset + row is at least sk + window - 1).
__device__ __forceinline__ long long blind_from(const BwdArgs& a) {
  if (!a.has_window) return a.sq;
  if (a.causal && a.window < 1) return 0;
  return max(0LL, static_cast<long long>(a.sk) + a.window - 1 - a.q_offset);
}

// Tiles come in by cp.async, rows at or past `avail` zero-filled, in
// 16-byte chunks where `vec` (a row a multiple of 4 floats, src 16-byte
// aligned), else 4-byte ones; consecutive threads take consecutive chunks,
// and no thread divides to find its row in the loop (a division by a width
// known only at run time is some 20 instructions a chunk).
// load_rows: rows of the width instance's own width W, 16-byte chunks.
template <int W>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, int rows,
                                          int avail) {
  constexpr int kChunks = W / 4;
  for (int i = threadIdx.x; i < rows * kChunks; i += kBwdThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    const bool ok = r < avail;
    cp_async16(dst + r * ld + c, ok ? src + static_cast<size_t>(r) * W + c : src, ok);
  }
}

// load_steps: rows of `cols` floats; each thread steps its (row, chunk) by
// the block's thread count, dividing only before the loop.
__device__ __forceinline__ void load_steps(float* dst, int ld, const float* src, int cols,
                                           int rows, int avail, bool vec) {
  const int width = vec ? 4 : 1;  // floats a chunk
  const int per_row = cols / width;
  const int dr = kBwdThreads / per_row, dc = kBwdThreads - dr * per_row;
  int r = static_cast<int>(threadIdx.x) / per_row;
  int c = static_cast<int>(threadIdx.x) - r * per_row;
  for (; r < rows; r += dr, c += dc) {
    if (c >= per_row) {
      c -= per_row;
      if (++r >= rows) break;
    }
    const bool ok = r < avail;
    const float* from = ok ? src + static_cast<size_t>(r) * cols + width * c : src;
    if (vec)
      cp_async16(dst + r * ld + 4 * c, from, ok);
    else
      cp_async4(dst + r * ld + c, from, ok);
  }
}

// s[n] = A B^T for the warp's 16 rows of `a` (the A operand) against the
// 8 NS rows of `b`, over w8 columns (a multiple of 8): both by ldmatrix,
// each product in three TF32 products, summed from zero. The big*big
// products and the small terms go to separate accumulators, added at the
// end: each tensor-core add truncates relative to its running sum, and the
// small terms' sum stays small (the chained split products measured 6.5e-6
// of the plain version at llama's lane on an H100, this 3.4e-6, in the
// same time).
template <int NS>
__device__ __forceinline__ void products_t(float (&s)[NS][4], const float* a, const float* b,
                                           int ld, int w8) {
  const int lane = threadIdx.x & 31;
  float lo[NS][4];
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = 0.f;
      lo[n][e] = 0.f;
    }
#pragma unroll 2
  for (int kk = 0; kk < w8; kk += 8) {
    uint32_t r[4], a_big[4], a_small[4];
    ldmatrix_x4(r, a + (lane & 15) * ld + kk + 4 * (lane >> 4));
#pragma unroll
    for (int e = 0; e < 4; ++e) split(__uint_as_float(r[e]), a_big[e], a_small[e]);
#pragma unroll
    for (int n = 0; n < NS; n += 2) {
      uint32_t bq[4], b_big[4], b_small[4];
      ldmatrix_x4(bq, b + (8 * n + 8 * (lane >> 4) + (lane & 7)) * ld + kk +
                          4 * ((lane >> 3) & 1));
#pragma unroll
      for (int e = 0; e < 4; ++e) split(__uint_as_float(bq[e]), b_big[e], b_small[e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma_tf32(lo[n + h], a_small, b_big[2 * h], b_big[2 * h + 1]);
        mma_tf32(lo[n + h], a_big, b_small[2 * h], b_small[2 * h + 1]);
        mma_tf32(s[n + h], a_big, b_big[2 * h], b_big[2 * h + 1]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += lo[n][e];
}

// acc[n] += sum over the NS slices j of A_j B_j, B_j rows 8j .. 8j + 7 of
// `b` (the streamed tile) and its columns 8n .. 8n + 7, for the n-tiles
// below n_used. A_j is an accumulator fragment in the A operand's order
// (k-column t = row 8j + 2t of b, t + 4 = row 8j + 2t + 1), split. Each
// n-tile's products are summed from zero and added on the CUDA cores.
// The n-tiles go in groups of G whose product chains interleave, with one
// branch a group (a branch per n-tile would leave each chain of 3 NS
// dependent mma alone in its block); in the last group, n-tiles at or past
// n_used read the last column block again and their sums are never stored.
template <int NS, int NA, int G>
__device__ __forceinline__ void accumulate(float (&acc)[NA][4], const uint32_t (&a_big)[NS][4],
                                           const uint32_t (&a_small)[NS][4], const float* b,
                                           int ld, int n_used) {
  static_assert(NA % G == 0, "whole groups");
  const int lane = threadIdx.x & 31;
  const float* bl = b + 2 * (lane & 3) * ld + (lane >> 2);
#pragma unroll
  for (int n0 = 0; n0 < NA; n0 += G) {
    if (n0 < n_used) {
      int col[G];
      float part[G][4];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        col[i] = 8 * min(n0 + i, n_used - 1);
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int i = 0; i < G; ++i) {
          uint32_t b_big[2], b_small[2];
          split(bl[8 * j * ld + col[i]], b_big[0], b_small[0]);
          split(bl[(8 * j + 1) * ld + col[i]], b_big[1], b_small[1]);
          mma_split(part[i], a_big[j], a_small[j], b_big, b_small);
        }
#pragma unroll
      for (int i = 0; i < G; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + i][e] += part[i][e];
    }
  }
}

// Where accumulator element e (row g + 8 (e / 2), column 2t + e % 2) sits
// in the A operand: k-column t holds column 2t, k-column t + 4 column 2t + 1.
__device__ __forceinline__ constexpr int a_index(int e) { return ((e & 1) << 1) | (e >> 1); }

// Splits the accumulator fragment x into the A operand's order.
__device__ __forceinline__ void split_a(const float (&x)[4], uint32_t (&big)[4],
                                        uint32_t (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(x[e], big[a_index(e)], small[a_index(e)]);
}

// One pass. KEYS 0: the dQ pass (resident queries); 1: the dK/dV pass
// (resident keys). ACC: which products it accumulates (see above).
template <int W, int KEYS, int ACC>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_kernel(const BwdArgs a) {
  constexpr int BS = bwd_stream(W);
  constexpr int NS = BS / 8;  // 8-row slices of a streamed tile
  constexpr int NA = W / 8;   // accumulator n-tiles
  constexpr bool kDS = (ACC & kAccDS) != 0;
  constexpr bool kP = (ACC & kAccP) != 0;
  // n-tiles a group of accumulate's interleaved chains, as timed on an
  // H100 with no register spilled: 4 at width 64, 2 at 32 (4 spilled in
  // the dQ pass) and 128, 1 at 256.
  constexpr int G = W == 64 ? 4 : W == 256 ? 1 : 2;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld1 = round8(a.d1) + kPad, ld2 = round8(a.d2) + kPad;
  const int n1 = round8(a.d1) / 8, n2 = round8(a.d2) / 8;
  float* res1 = smem;
  float* res2 = res1 + kRes * ld1;
  float* str1 = res2 + kRes * ld2;
  float* str2 = str1 + BS * ld1;
  float* lse_s = str2 + BS * ld2;  // the dK/dV pass only
  float* delta_s = lse_s + BS;

  const int bh = blockIdx.x % a.n_heads;
  const int tile = static_cast<int>(blockIdx.x / a.n_heads);
  const int nres = KEYS ? a.sk : a.sq;
  const int nstr = KEYS ? a.sq : a.sk;
  const int row0 = (KEYS ? tile : (nres + kRes - 1) / kRes - 1 - tile) * kRes;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = 16 * warp;
  const size_t qoff = static_cast<size_t>(bh) * a.sq;
  const size_t koff = static_cast<size_t>(bh) * a.sk;
  const size_t roff = KEYS ? koff : qoff;
  const size_t soff = KEYS ? qoff : koff;
  const float* r1 = KEYS ? a.k : a.q;
  const float* r2 = KEYS ? a.v : a.dout;
  const float* s1 = KEYS ? a.q : a.k;
  const float* s2 = KEYS ? a.dout : a.v;
  const long long blind = blind_from(a);

  // The streamed rows [lo, hi] that rows [first, last] see (in the dK/dV
  // pass also every row that sees no key). Query row r sits at position
  // q_offset + r: in the dK/dV pass the first query row that sees key c
  // (causal) is c - q_offset, the last (window) c + window - 1 - q_offset.
  auto seen = [&](long long first, long long last, long long& lo, long long& hi) {
    if (first > last) {
      lo = 1;
      hi = 0;
    } else if (!KEYS) {
      lo = key_lo(first + a.q_offset, a.has_window, a.window);
      hi = key_hi(last + a.q_offset, a.sk, a.causal);
    } else {
      lo = a.causal ? max(0LL, first - a.q_offset) : 0;
      hi = a.has_window
               ? min(last + a.window - 1 - a.q_offset, static_cast<long long>(a.sq - 1))
               : static_cast<long long>(a.sq - 1);
      if (blind < a.sq) {
        lo = min(lo, blind);
        hi = a.sq - 1;
      }
    }
  };
  long long lo, hi, w_lo, w_hi;
  seen(row0, min(row0 + kRes, nres) - 1, lo, hi);
  seen(row0 + wr, min(row0 + wr + 16, nres) - 1, w_lo, w_hi);
  const int t_lo = lo <= hi ? static_cast<int>(lo / BS) : 0;
  const int t_hi = lo <= hi ? static_cast<int>(hi / BS) + 1 : 0;

  auto load = [&](float* dst, int ld, const float* src, int cols, int rows, int avail,
                  int vec) {
    if constexpr (W <= 128) {
      if (cols == W && vec) {
        load_rows<W>(dst, ld, src, rows, avail);
        return;
      }
    }
    load_steps(dst, ld, src, cols, rows, avail, vec);
  };
  auto load_str1 = [&](int c0) {
    load(str1, ld1, s1 + (soff + c0) * a.d1, a.d1, BS, nstr - c0, a.vec1);
    if (KEYS && threadIdx.x < BS) {
      const int i = threadIdx.x;
      const bool ok = c0 + i < a.sq;
      cp_async4(lse_s + i, ok ? a.lse + qoff + c0 + i : a.lse, ok);
      if (kDS) cp_async4(delta_s + i, ok ? a.delta + qoff + c0 + i : a.delta, ok);
    }
  };
  auto load_str2 = [&](int c0) {
    load(str2, ld2, s2 + (soff + c0) * a.d2, a.d2, BS, nstr - c0, a.vec2);
  };

  zero_pad<kBwdThreads>(res1, ld1, a.d1, kRes);
  zero_pad<kBwdThreads>(res2, ld2, a.d2, kRes);
  zero_pad<kBwdThreads>(str1, ld1, a.d1, BS);
  zero_pad<kBwdThreads>(str2, ld2, a.d2, BS);
  load(res1, ld1, r1 + (roff + row0) * a.d1, a.d1, kRes, nres - row0, a.vec1);
  if (kDS || !KEYS)  // the dV kernel at width 256 never reads V
    load(res2, ld2, r2 + (roff + row0) * a.d2, a.d2, kRes, nres - row0, a.vec2);
  if (t_lo < t_hi) {
    load_str1(t_lo * BS);
    load_str2(t_lo * BS);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // The lane's two rows: wr + g and wr + g + 8 of the tile. In the dQ pass
  // their visible keys, lse and delta (delta = rowsum(dO o O) a row, over
  // the warp's lanes, written for the dK/dV pass); in the dK/dV pass their
  // key positions.
  int klo[2], khi[2], key[2];
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const long long row = row0 + wr + g + 8 * ri;
    key[ri] = static_cast<int>(row);
    klo[ri] = 1;
    khi[ri] = 0;
    if (!KEYS && row < a.sq) {
      klo[ri] = key_lo(row + a.q_offset, a.has_window, a.window);
      khi[ri] = key_hi(row + a.q_offset, a.sk, a.causal);
      lse_r[ri] = a.lse[qoff + row];
    }
  }
  if (!KEYS) {
    for (int i = 0; i < 16; ++i) {
      const int row = row0 + wr + i;
      float sum = 0.f;
      if (row < a.sq) {
        const float* orow = a.o + (qoff + row) * a.d2;
        const float* drow = res2 + (wr + i) * ld2;
        for (int c = lane; c < a.d2; c += 32) sum = fmaf(drow[c], orow[c], sum);
      }
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
      if (row < a.sq && lane == 0) a.delta[qoff + row] = sum;
      if (i == g) delta_r[0] = sum;
      if (i == g + 8) delta_r[1] = sum;
    }
  }

  float acc1[NA][4], acc2[NA][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc1[n][e] = 0.f;
      acc2[n][e] = 0.f;
    }

  for (int it = t_lo; it < t_hi; ++it) {
    const int c0 = it * BS;
    const bool more = it + 1 < t_hi;
    const bool active = c0 <= w_hi && c0 + BS - 1 >= w_lo;
    float t2[NS][4];
    if (kDS && active) products_t<NS>(t2, res2 + wr * ld2, str2, ld2, 8 * n2);
    cp_async_wait<0>();
    __syncthreads();  // C1 of this tile has landed; every warp is done with T2
    if (!kP && more) {  // no acc2: C2 is free
      load_str2(c0 + BS);
      cp_async_commit();
    }

    // P and dS in the A operand's order, split. With both accumulators,
    // dS is formed from P's halves after acc2 (big + small is P exactly),
    // so the two need not be held split together.
    uint32_t p_big[NS][4], p_small[NS][4], ds_big[NS][4], ds_small[NS][4];
    uint32_t kept = 0;  // bit 4j + e: element e of slice j is unmasked
    if (active) {
      float t1[NS][4];
      products_t<NS>(t1, res1 + wr * ld1, str1, ld1, 8 * n1);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = e >> 1;
          const int col = c0 + 8 * j + 2 * t + (e & 1);  // the streamed row
          bool keep;
          float l, dl;
          bool blind_row = false;
          if (!KEYS) {
            keep = col >= klo[ri] && col <= khi[ri];
            l = lse_r[ri];
            dl = delta_r[ri];
          } else {
            const long long qpos = col + a.q_offset;
            const int lo_c = key_lo(qpos, a.has_window, a.window);
            const int hi_c = key_hi(qpos, a.sk, a.causal);
            const bool real = col < a.sq && key[ri] < a.sk;
            keep = real && key[ri] >= lo_c && key[ri] <= hi_c;
            blind_row = real && lo_c > hi_c;
            l = lse_s[col - c0];
            dl = kDS && !kP ? delta_s[col - c0] : 0.f;
          }
          kept |= static_cast<uint32_t>(keep) << (4 * j + e);
          p[e] = keep ? expf(t1[j][e] * a.scale - l) : blind_row ? a.blind_p : 0.f;
          ds[e] = kDS && !kP && keep ? p[e] * (t2[j][e] - dl) : 0.f;
        }
        if (kP) split_a(p, p_big[j], p_small[j]);
        if (kDS && !kP) split_a(ds, ds_big[j], ds_small[j]);
      }
      if (kP) {
        accumulate<NS, NA, G>(acc2, p_big, p_small, str2, ld2, n2);
        if (kDS) {
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            float ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int x = a_index(e);
              const float p = __uint_as_float(p_big[j][x]) + __uint_as_float(p_small[j][x]);
              const float dl = delta_s[8 * j + 2 * t + (e & 1)];
              ds[e] = (kept >> (4 * j + e)) & 1u ? p * (t2[j][e] - dl) : 0.f;
            }
            split_a(ds, ds_big[j], ds_small[j]);
          }
        }
      }
    }
    if (kP) {
      __syncthreads();  // every warp is done with C2
      if (more) {
        load_str2(c0 + BS);
        cp_async_commit();
      }
    }
    if (kDS && active) accumulate<NS, NA, G>(acc1, ds_big, ds_small, str1, ld1, n1);
    cp_async_wait<0>();
    __syncthreads();  // C2 of the next tile has landed; every warp is done with C1
    if (more) {
      load_str1(c0 + BS);
      cp_async_commit();
    }
  }

  // Rows g and g + 8 of the warp's m-tile, columns 8n + 2t and 8n + 2t + 1.
  float* out1 = KEYS ? a.dk + koff * a.d1 : a.dq + qoff * a.d1;
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = row0 + wr + g + 8 * ri;
    if (row >= nres) continue;
#pragma unroll
    for (int n = 0; n < NA; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * n + 2 * t + c;
        if (kDS && col < a.d1)
          out1[static_cast<size_t>(row) * a.d1 + col] = acc1[n][2 * ri + c] * a.scale;
        if (kP && col < a.d2)
          a.dv[(koff + row) * a.d2 + col] = acc2[n][2 * ri + c];
      }
  }
}

template <int W, int KEYS, int ACC>
cudaError_t launch_pass(const BwdArgs& a, int blocks, int smem, cudaStream_t stream) {
  auto kernel = flash_bwd_kernel<W, KEYS, ACC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kBwdThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The dQ pass, then the dK/dV pass (at width 256 its dV and dK kernels).
template <int W>
cudaError_t launch_bwd(const BwdArgs& a, int q_blocks, int k_blocks, int smem_dq,
                       int smem_dkdv, cudaStream_t stream) {
  cudaError_t err = launch_pass<W, 0, kAccDS>(a, q_blocks, smem_dq, stream);
  if (err != cudaSuccess) return err;
  if constexpr (W > 128) {
    err = launch_pass<W, 1, kAccP>(a, k_blocks, smem_dkdv, stream);
    if (err != cudaSuccess) return err;
    return launch_pass<W, 1, kAccDS>(a, k_blocks, smem_dkdv, stream);
  } else {
    return launch_pass<W, 1, kAccBoth>(a, k_blocks, smem_dkdv, stream);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
}  // namespace repro

// q (bh, sq, d), k (bh, sk, d), v (bh, sk, dv), o and dout (bh, sq, dv),
// lse (bh, sq): float32, contiguous. delta (bh, sq) is scratch; dq, dk, dv
// take the gradients. Query row r sits at position q_offset + r (>= 0), as
// in the forward. dm: the width instance (32, 64, 128 or 256, the smallest
// covering d and dv); threads and the two passes' shared memory as the
// wrapper's census gives them.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv_out, int bh,
                                         int sq, int sk, int d, int dv, int causal,
                                         int has_window, int window, long long q_offset,
                                         float scale, int sk_pad, int dm, int threads,
                                         int smem_dq, int smem_dkdv, int device, void* stream) {
  using repro::kRes;
  if (bh < 1 || sq < 1 || sk < 1 || d < 1 || d > 256 || dv < 1 || dv > 256 || sk_pad < sk ||
      q_offset < 0 || q_offset > INT_MAX ||
      static_cast<long long>((sq + kRes - 1) / kRes) * bh > INT_MAX ||
      static_cast<long long>((sk + kRes - 1) / kRes) * bh > INT_MAX)
    return cudaErrorInvalidValue;
  const int want = d > 128 || dv > 128 ? 256 : d > 64 || dv > 64 ? 128 : d > 32 || dv > 32 ? 64 : 32;
  if (threads != repro::kBwdThreads || dm != want ||
      smem_dq != repro::bwd_dq_floats(d, dv, dm) * static_cast<int>(sizeof(float)) ||
      smem_dkdv != repro::bwd_dkdv_floats(d, dv, dm) * static_cast<int>(sizeof(float)))
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  repro::BwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), static_cast<const float*>(o),
                   static_cast<const float*>(dout), static_cast<const float*>(lse),
                   static_cast<float*>(delta), static_cast<float*>(dq), static_cast<float*>(dk),
                   static_cast<float*>(dv_out), bh, sq, sk, d, dv, causal, has_window, window,
                   q_offset, scale, 1.f / static_cast<float>(sk_pad),
                   d % 4 == 0 && repro::aligned16(q) && repro::aligned16(k),
                   dv % 4 == 0 && repro::aligned16(v) && repro::aligned16(dout)};
  const int q_blocks = (sq + kRes - 1) / kRes * bh;
  const int k_blocks = (sk + kRes - 1) / kRes * bh;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dm) {
    case 32: return repro::launch_bwd<32>(a, q_blocks, k_blocks, smem_dq, smem_dkdv, s);
    case 64: return repro::launch_bwd<64>(a, q_blocks, k_blocks, smem_dq, smem_dkdv, s);
    case 128: return repro::launch_bwd<128>(a, q_blocks, k_blocks, smem_dq, smem_dkdv, s);
    case 256: return repro::launch_bwd<256>(a, q_blocks, k_blocks, smem_dq, smem_dkdv, s);
    default: return cudaErrorInvalidConfiguration;
  }
}
