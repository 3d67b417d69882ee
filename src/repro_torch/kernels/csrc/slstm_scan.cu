// The sLSTM recurrence over a whole sequence: slstm_scan.
//
// Replaces src/repro/kernels/slstm_scan.py: slstm_scan (:86, pallas_call at
// :98, body _kernel at :29).
//
// Bound on an H100: on paper float32 operations (2 B D^2 flops per step for
// the recurrent product: 69 GFLOP at xlstm-350m's D = 1024, B = 8,
// L = 4096) over bytes (xg read once, hs written once: 675 MB). Neither is
// reachable: step t needs all of h_{t-1}, so the L steps run one after
// another, and every step ends in a barrier across the whole grid. The
// floor this design does not beat is L of those barriers (chip_smoke times
// them alone: slstm_barriers).
//
// Design: one persistent grid of G CTAs (at most one an SM), launched
// cooperatively, so that all of it is resident or the launch is refused.
// - Shard by unit. Under the head-major wiring of the reference
//   (models/xlstm.py::_slstm_step) gate g of unit u is
//   h[b, g hd : (g+1) hd] . wr[g][:, u]. CTA j owns `units` consecutive
//   units with all four gates of each and keeps wr[g][:, its units] in
//   shared memory for the whole sequence, transposed (one row of ws
//   elements a (g, u)), converted once to double where that fits (64 KB at
//   D = 1024, G = 128), else in float32 (D = 2048: 128 KB). So wr crosses
//   HBM once a call. Where neither fits (D = 4096: 512 KB in float32) the
//   CTA reads its slice through the read-only path every step (the global
//   route).
// - All batch rows in each CTA, products on the tensor cores in double. A
//   step's products are, for each gate, a (B x hd) by (hd x units) matrix
//   product: mma.sync m8n8k4 f64 tiles of 8 batch rows x 8 units, each warp
//   one tile over one half of K in four chains. A float32 chain of fmaf a
//   thread (the one-block-per-row kernel this file replaced) was bound by
//   shared memory: a float4 load costs 4 of its cycles whatever the
//   broadcast, 2 loads for 4 fmaf. The double sums are rounded to float32
//   once, so the products are closer to float64 than that chain, and not
//   bit for bit the same.
// - One grid barrier a step, h through L2. Step t reads h_{t-1} from
//   hs[:, t-1, :], which it wrote anyway, through __ldcg (L2, never the
//   read-only or L1 path: other SMs wrote it in this launch), each thread
//   its float4s from offsets found once a batch group (integer division on
//   a step's path cost more than the loads). The barrier is a monotonic
//   64-bit count that the wrapper zeroes each call: after __syncthreads one
//   thread adds 1 with release semantics and polls with acquire loads until
//   the count reaches G (step + 1). xg of the next step does not depend on
//   the recurrence: it is loaded into registers while the products run and
//   stored to shared memory once the gates have read this step's. A wait
//   of over ~10 s traps, so a fault ends the launch with an error and does
//   not hang the card.
// - c, n and m of the owned (b, u) pairs stay in shared memory, so any
//   batch fits the same code; batches whose rows, with the slice, do not
//   fit run in groups of `rows`, one after another, each over all L steps.
//   m0 = -inf gives f = exp(-inf) = 0 and no NaN, as in the reference.
// - A second instance (kSave; the same entry, given gates, cs, ns and ms)
//   also writes each step's gate pre-activations and c, n, m after it:
//   what the backward (slstm_scan_bwd.cu) reads, so that its steps need no
//   forward product.
//
// Rejected:
// - One thread-block cluster holding wr in distributed shared memory:
//   16 CTAs x 227 KB = 3.6 MB, less than the 4 MiB of wr at D = 1024, on
//   16 of 132 SMs; it could not hold D = 2048 at all.
// - One block per batch row, even with wr in shared memory: B copies of
//   the read of wr on B SMs (the kernel this file replaced streamed all of
//   wr through L2 into each of B SMs every step: 88 us a step).
// - h into shared memory by TMA bulk copies issued by one thread, and one
//   flag a CTA polled by a warp in place of the count: both slower on the
//   card (PERF.md section 6).
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "slstm_grid.cuh"

namespace repro {
namespace {

constexpr int kHeads = 4;
constexpr int kThreads = 256;  // a CTA's threads
constexpr int kWarps = kThreads / 32;
// A thread's loads a step from offsets computed once a group (runtime
// divisions on a step's path cost more than the loads): float4s of h (8 x
// 256 = 32 KB, all of h at B 8, D 1024) and xg values prefetched a step
// ahead. The rest, where a step has more, go through load_h and load_x;
// REPRO_SLSTM_SLOTS=0 (a build of the CPU emulator's tests) sends all there.
#ifndef REPRO_SLSTM_SLOTS
#define REPRO_SLSTM_SLOTS 1
#endif
constexpr int kHSlots = 8 * REPRO_SLSTM_SLOTS;
constexpr int kXSlots = REPRO_SLSTM_SLOTS;
constexpr long long kSmemLimit = 232448;  // 227 KB a block

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Elements between consecutive rows of h and of the transposed wr slice in
// shared memory: hd rounded up to 4, plus 4, so that the rows of a warp's
// loads start in distinct banks.
__host__ __device__ inline int row_stride(int hd) { return (hd + 3) / 4 * 4 + 4; }

// Where a CTA keeps its slice of wr: read from device memory every step,
// or held in shared memory in float32 or, converted once, in double.
enum Route { kGlobal = 0, kSmemF32 = 1, kSmemF64 = 2 };

// Shared memory of a CTA, in floats, in this order: the wr slice (4 units
// rows of ws, in float32 or double; none on the global route), h (4 rows
// rows of ws), the two halves of the gate products over K (2 x 4 rows
// units doubles), the gate inputs xg (4 rows units), the bias (4 units) and
// the state c, n, m (each rows units). kernels/slstm_scan.py's slstm_grid
// computes the same.
__host__ __device__ inline long long smem_floats(int hd, int units, int rows, int route) {
  const long long ws = row_stride(hd);
  return 4LL * route * units * ws + 4LL * rows * ws + 20LL * rows * units + 4LL * units +
         3LL * rows * units;
}

struct ScanArgs {
  const float* xg;    // (batch, len, 4 d)
  const float* wr;    // (4, hd, d)
  const float* bias;  // (4 d)
  const float* c0;    // (batch, d), and n0, h0, m0
  const float* n0;
  const float* h0;
  const float* m0;
  float* hs;          // (batch, len, d)
  float* cf;          // (batch, d), and nf, hf, mf
  float* nf;
  float* hf;
  float* mf;
  // What the backward (slstm_scan_bwd.cu) reads, written by the saving
  // instance only: each step's gate pre-activations, bias included
  // (batch, len, 4 d), and c, n, m after it (batch, len, d) each.
  float* gates;
  float* cs;
  float* ns;
  float* ms;
  unsigned long long* count;  // the grid barrier's count, 0 at launch
  int batch, len, d, units, rows;
};

// Element i of a step's h (in units of V, float4 where hd allows it):
// batch row b = r / 4, gate g = r % 4 for r = i / (hd / kV), so that
// consecutive threads read consecutive addresses. Its offset from the
// group's first row (rows `stride` floats apart) and into h_s, where gate
// g's quarter of row b is row g rows + b of ws floats.
template <class V>
__device__ __forceinline__ void h_offsets(int i, int hd, size_t stride, int rows, int ws,
                                          long long& src, int& dst) {
  constexpr int kV = sizeof(V) / sizeof(float);
  const int per = hd / kV;
  const int r = i / per, q = i - r * per, b = r / kHeads, g = r - b * kHeads;
  src = static_cast<long long>(b) * stride + g * hd + q * kV;
  dst = (g * rows + b) * ws + q * kV;
}

// Elements first, first + kThreads, ... of a step's h into h_s, through L2
// (__ldcg: other SMs wrote it in this launch), 8 a thread in flight.
template <class V>
__device__ __forceinline__ void load_h(float* h_s, const float* src, size_t stride, int nb,
                                       int rows, int hd, int ws, int first) {
  constexpr int kLoads = 8;
  const int total = kHeads * nb * (hd * static_cast<int>(sizeof(float)) / static_cast<int>(sizeof(V)));
  for (int base = first + threadIdx.x; base < total; base += kLoads * kThreads) {
    V v[kLoads];
    int dst[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
      if (base + j * kThreads < total) {
        long long off;
        h_offsets<V>(base + j * kThreads, hd, stride, rows, ws, off, dst[j]);
        v[j] = __ldcg(reinterpret_cast<const V*>(src + off));
      }
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
      if (base + j * kThreads < total) *reinterpret_cast<V*>(h_s + dst[j]) = v[j];
  }
}

// Element o of a step's xg for the CTA's pairs of a group of nb rows: gate
// g = o / (nb cnt), then batch row b and unit uu. Its offset from the
// group's step 0 and into x_s, laid out as the products:
// (g rows + b) units + uu.
__device__ __forceinline__ void x_offsets(int o, int nb, int cnt, const ScanArgs& a, int u0,
                                          long long& src, int& dst) {
  const int per_gate = nb * cnt;
  const int g = o / per_gate, p = o - g * per_gate, b = p / cnt, uu = p - b * cnt;
  src = static_cast<long long>(b) * a.len * kHeads * a.d + g * a.d + u0 + uu;
  dst = (g * a.rows + b) * a.units + uu;
}

// Elements first, first + kThreads, ... of step t's xg for rows
// b0 .. b0+nb-1 into x_s.
__device__ __forceinline__ void load_x(float* x_s, const ScanArgs& a, int b0, int nb, int t,
                                       int u0, int cnt, int first) {
  const float* src = a.xg + (static_cast<size_t>(b0) * a.len + t) * kHeads * a.d;
  for (int o = first + threadIdx.x; o < kHeads * nb * cnt; o += kThreads) {
    long long off;
    int dst;
    x_offsets(o, nb, cnt, a, u0, off, dst);
    x_s[dst] = __ldg(src + off);
  }
}

// A warp's item of the products: an 8 x 8 tile (batch rows 8 mt .. of
// units 8 nt .. of gate g) over one half of K. Rows and units past the edge
// repeat the last one and are not stored. Per lane: A's row b and B's
// column uu, and the output it holds (row bo, units uo and uo + 1).
struct Item {
  int g, half, b, uu, bo, uo;
};

__device__ __forceinline__ Item item_of(int item, int nb, int cnt) {
  const int mts = (nb + 7) / 8, nts = (cnt + 7) / 8;
  const int lane = threadIdx.x % 32, grp = lane / 4, tig = lane % 4;
  const int tile = item / 2, g = tile / (mts * nts);
  const int mt = tile / nts - g * mts, nt = tile - (tile / nts) * nts;
  return {g, item % 2, min(8 * mt + grp, nb - 1), min(8 * nt + grp, cnt - 1), 8 * mt + grp,
          8 * nt + 2 * tig};
}

template <int kRoute, int kSave>
__global__ void __launch_bounds__(kThreads) slstm_scan_kernel(ScanArgs a) {
  using W = std::conditional_t<kRoute == kSmemF64, double, float>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = a.d, len = a.len, units = a.units, rows = a.rows;
  const int hd = d / kHeads;
  const int ws = row_stride(hd);
  const int kq = (hd + 3) / 4;  // steps of 4 along K
  const int u0 = blockIdx.x * units;
  const int cnt = min(units, d - u0);  // the last CTA may own fewer
  const int tid = threadIdx.x, warp = tid / 32, tig = tid % 4;
  W* w_s = reinterpret_cast<W*>(smem);
  float* h_s = smem + kRoute * kHeads * units * ws;
  double* part_s = reinterpret_cast<double*>(h_s + kHeads * rows * ws);  // 16-byte aligned
  float* x_s = reinterpret_cast<float*>(part_s + 2 * kHeads * rows * units);
  float* bias_s = x_s + kHeads * rows * units;
  float* c_s = bias_s + kHeads * units;
  float* n_s = c_s + rows * units;
  float* m_s = n_s + rows * units;

  // The wr slice, transposed: w_s[(g units + uu) ws + kk] = wr[g][kk][u0 + uu];
  // consecutive threads on consecutive units.
  if constexpr (kRoute != kGlobal) {
    for (int i = tid; i < kHeads * hd * cnt; i += kThreads) {
      const int r = i / cnt;  // g hd + kk
      const int uu = i - r * cnt;
      const int g = r / hd;
      w_s[(g * units + uu) * ws + r - g * hd] = a.wr[static_cast<size_t>(r) * d + u0 + uu];
    }
  }
  // K runs in steps of 4: the columns hd .. ws - 5 of the rows of h and wr
  // stay 0 for the whole sequence.
  const int pad = ws - 4 - hd;
  for (int i = tid; i < kHeads * (rows + (kRoute != kGlobal ? units : 0)) * pad; i += kThreads) {
    const int r = i / pad, k = hd + i - r * pad;
    if (r < kHeads * rows)
      h_s[r * ws + k] = 0.f;
    else
      w_s[(r - kHeads * rows) * ws + k] = 0;
  }
  for (int i = tid; i < kHeads * cnt; i += kThreads) {
    const int g = i / cnt;
    bias_s[g * units + i - g * cnt] = a.bias[g * d + u0 + i - g * cnt];
  }
  const bool h0_vec = hd % 4 == 0 && reinterpret_cast<uintptr_t>(a.h0) % 16 == 0;
  const bool hs_vec = hd % 4 == 0;  // hs rows start on float4s (d % 4 == 0)
  const size_t hs_stride = static_cast<size_t>(len) * d;
  const size_t xg_step = static_cast<size_t>(kHeads) * d;
  const int groups = (a.batch + rows - 1) / rows;
  const long long steps = static_cast<long long>(groups) * len;
  long long step = 0;

  for (int grp = 0; grp < groups; ++grp) {
    const int b0 = grp * rows;
    const int nb = min(rows, a.batch - b0);
    const int pairs = nb * cnt;
    const int xs = kHeads * pairs;  // xg values a step
    const int hs4 = hs_vec ? kHeads * nb * (hd / 4) : 0;  // float4s of h a step
    const int items = 2 * kHeads * ((nb + 7) / 8) * ((cnt + 7) / 8);
    // What this thread does every step of the group, found once.
    long long h_src[kHSlots > 0 ? kHSlots : 1], x_src[kXSlots > 0 ? kXSlots : 1];
    int h_dst[kHSlots > 0 ? kHSlots : 1], x_dst[kXSlots > 0 ? kXSlots : 1];
#pragma unroll
    for (int j = 0; j < kHSlots; ++j)
      if (tid + j * kThreads < hs4)
        h_offsets<float4>(tid + j * kThreads, hd, hs_stride, rows, ws, h_src[j], h_dst[j]);
#pragma unroll
    for (int j = 0; j < kXSlots; ++j)
      if (tid + j * kThreads < xs) x_offsets(tid + j * kThreads, nb, cnt, a, u0, x_src[j], x_dst[j]);
    const Item first = item_of(warp, nb, cnt);
    const int pb = tid / cnt, pu = tid - pb * cnt;  // the first pair's row and unit

    for (int p = tid; p < pairs; p += kThreads) {
      const int b = p / cnt, uu = p - b * cnt;
      const size_t s = static_cast<size_t>(b0 + b) * d + u0 + uu;
      c_s[b * units + uu] = a.c0[s];
      n_s[b * units + uu] = a.n0[s];
      m_s[b * units + uu] = a.m0[s];
    }
    load_x(x_s, a, b0, nb, 0, u0, cnt, 0);

    for (int t = 0; t < len; ++t) {
      // h_{t-1}: h0 at t = 0, else hs[:, t-1, :], which every CTA wrote.
      if (t == 0) {
        const float* src = a.h0 + static_cast<size_t>(b0) * d;
        if (h0_vec)
          load_h<float4>(h_s, src, d, nb, rows, hd, ws, 0);
        else
          load_h<float>(h_s, src, d, nb, rows, hd, ws, 0);
      } else {
        const float* src = a.hs + (static_cast<size_t>(b0) * len + t - 1) * d;
        if (hs_vec) {
          float4 v[kHSlots > 0 ? kHSlots : 1];
#pragma unroll
          for (int j = 0; j < kHSlots; ++j)
            if (tid + j * kThreads < hs4) v[j] = __ldcg(reinterpret_cast<const float4*>(src + h_src[j]));
#pragma unroll
          for (int j = 0; j < kHSlots; ++j)
            if (tid + j * kThreads < hs4) *reinterpret_cast<float4*>(h_s + h_dst[j]) = v[j];
          load_h<float4>(h_s, src, hs_stride, nb, rows, hd, ws, kHSlots * kThreads);
        } else {
          load_h<float>(h_s, src, hs_stride, nb, rows, hd, ws, 0);
        }
      }
      __syncthreads();

      // xg of the next step, into registers until x_s is free.
      float xn[kXSlots > 0 ? kXSlots : 1];
      const float* x_next = a.xg + (static_cast<size_t>(b0) * len + t + 1) * xg_step;
#pragma unroll
      for (int j = 0; j < kXSlots; ++j)
        if (t + 1 < len && tid + j * kThreads < xs) xn[j] = __ldg(x_next + x_src[j]);

      // The recurrent products on the tensor cores, in double: a warp runs
      // items warp, warp + 8, ..., four chains of mma over its half of K.
      for (int item = warp; item < items; item += kWarps) {
        const Item it = item == warp ? first : item_of(item, nb, cnt);
        const float* hp = h_s + (it.g * rows + it.b) * ws + tig;
        const int q1 = it.half ? kq : kq / 2;
        int q = it.half ? kq / 2 : 0;
        double c[4][2] = {};
        if constexpr (kRoute != kGlobal) {
          const W* wp = w_s + (it.g * units + it.uu) * ws + tig;
          for (; q + 3 < q1; q += 4)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_m8n8k4(c[j][0], c[j][1], hp[4 * q + 4 * j], wp[4 * q + 4 * j]);
          for (; q < q1; ++q) mma_m8n8k4(c[0][0], c[0][1], hp[4 * q], wp[4 * q]);
        } else {
          const float* wp = a.wr + static_cast<size_t>(it.g) * hd * d + u0 + it.uu;
          const auto w = [&](int qq) {
            const int k = 4 * qq + tig;
            return k < hd ? __ldg(wp + static_cast<size_t>(k) * d) : 0.f;
          };
          for (; q + 3 < q1; q += 4)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_m8n8k4(c[j][0], c[j][1], hp[4 * q + 4 * j], w(q + j));
          for (; q < q1; ++q) mma_m8n8k4(c[0][0], c[0][1], hp[4 * q], w(q));
        }
        double* out = part_s + (it.half * kHeads * rows + it.g * rows + it.bo) * units + it.uo;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (it.bo < nb && it.uo + j < cnt) out[j] = (c[0][j] + c[1][j]) + (c[2][j] + c[3][j]);
      }
      __syncthreads();

      // The gates of each owned pair, as the reference's step.
      for (int p = tid; p < pairs; p += kThreads) {
        const int b = p == tid ? pb : p / cnt;
        const int uu = p == tid ? pu : p - b * cnt;
        float x[kHeads], r[kHeads];
#pragma unroll
        for (int g = 0; g < kHeads; ++g) {
          const int o = (g * rows + b) * units + uu;
          x[g] = x_s[o];
          r[g] = static_cast<float>(part_s[o] + part_s[kHeads * rows * units + o]);
        }
        const int s = b * units + uu;
        float c = c_s[s], n = n_s[s], m = m_s[s];
        const float it = (x[0] + r[0]) + bias_s[uu];
        const float ft = (x[1] + r[1]) + bias_s[units + uu];
        const float zt = (x[2] + r[2]) + bias_s[2 * units + uu];
        const float ot = (x[3] + r[3]) + bias_s[3 * units + uu];
        const float log_f = log_sigmoid(ft);
        const float m_new = fmaxf(log_f + m, it);
        const float i_sc = expf(it - m_new);
        const float f_sc = expf(log_f + m - m_new);
        c = f_sc * c + i_sc * tanhf(zt);
        n = f_sc * n + i_sc;
        m = m_new;
        const float h = sigmoid(ot) * c / fmaxf(n, 1e-6f);
        c_s[s] = c;
        n_s[s] = n;
        m_s[s] = m;
        const size_t row = static_cast<size_t>(b0 + b);
        a.hs[(row * len + t) * d + u0 + uu] = h;
        if constexpr (kSave) {
          const size_t o = row * len + t;
          float* gp = a.gates + o * kHeads * d + u0 + uu;
          gp[0] = it;
          gp[d] = ft;
          gp[2 * d] = zt;
          gp[3 * d] = ot;
          a.cs[o * d + u0 + uu] = c;
          a.ns[o * d + u0 + uu] = n;
          a.ms[o * d + u0 + uu] = m;
        }
        if (t == len - 1) {
          const size_t f = row * d + u0 + uu;
          a.cf[f] = c;
          a.nf[f] = n;
          a.hf[f] = h;
          a.mf[f] = m;
        }
      }
      if (++step == steps) return;
      __syncthreads();  // hs of this step stored; x_s, part_s and the state read
      grid_arrive(a.count);
      if (t + 1 < len) {
#pragma unroll
        for (int j = 0; j < kXSlots; ++j)
          if (tid + j * kThreads < xs) x_s[x_dst[j]] = xn[j];
        load_x(x_s, a, b0, nb, t + 1, u0, cnt, kXSlots * kThreads);
      }
      grid_wait(a.count, static_cast<unsigned long long>(gridDim.x) * step);
    }
  }
}

// L grid barriers and nothing else, on the scan's grid: the floor of its
// per-step time.
__global__ void __launch_bounds__(kThreads)
slstm_barrier_kernel(unsigned long long* count, int steps) {
  for (int s = 1; s <= steps; ++s) {
    __syncthreads();
    grid_arrive(count);
    grid_wait(count, static_cast<unsigned long long>(gridDim.x) * s);
  }
}

using ScanKernel = void (*)(ScanArgs);

template <int kSave>
ScanKernel scan_instance(int route) {
  return route == kSmemF64 ? slstm_scan_kernel<kSmemF64, kSave>
         : route == kSmemF32 ? slstm_scan_kernel<kSmemF32, kSave>
                             : slstm_scan_kernel<kGlobal, kSave>;
}

ScanKernel scan_kernel(int route, bool save = false) {
  return save ? scan_instance<1>(route) : scan_instance<0>(route);
}

// The geometry the host computed (slstm_grid) must cover d once and match
// the shared memory this file lays out.
bool valid_geometry(int batch, int d, int ctas, int units, int threads, int rows, int route,
                    int smem) {
  if (batch < 1 || d < kHeads || d % kHeads != 0 || units < 1 || ctas < 1 || rows < 1 ||
      rows > batch || route < kGlobal || route > kSmemF64)
    return false;
  if (static_cast<long long>(ctas) * units < d || static_cast<long long>(ctas - 1) * units >= d)
    return false;
  if (threads != kThreads) return false;
  const long long bytes = 4 * smem_floats(d / kHeads, units, rows, route);
  return bytes == smem && bytes <= kSmemLimit;
}

}  // namespace
}  // namespace repro

namespace repro {
namespace {

const float* in(const void* p) { return static_cast<const float*>(p); }
float* out(void* p) { return static_cast<float*>(p); }

}  // namespace
}  // namespace repro

// xg (batch, len, 4d); wr (4, d/4, d); bias (4d); c0, n0, h0, m0 and the
// final states (batch, d); hs (batch, len, d); all float32, contiguous;
// count one zeroed uint64. gates (batch, len, 4d), each step's
// pre-activations with the bias, and cs, ns, ms (batch, len, d), the state
// after each step, are what slstm_scan_bwd.cu reads: all four null, or all
// four set, which launches the saving instance. ctas CTAs of `units` units
// and `threads` threads, batch rows in groups of `rows`, wr's slice where
// `route` (Route) says; smem bytes as smem_floats gives them.
extern "C" int repro_slstm_scan(const void* xg, const void* wr, const void* bias, const void* c0,
                                const void* n0, const void* h0, const void* m0, void* hs,
                                void* cf, void* nf, void* hf, void* mf, void* gates, void* cs,
                                void* ns, void* ms, void* count, int batch, int len, int d,
                                int ctas, int units, int threads, int rows, int route, int smem,
                                int device, void* stream) {
  using repro::in;
  using repro::out;
  const bool save = gates != nullptr;
  // A geometry slstm_grid did not give is an invalid value; a grid the card
  // cannot hold at once is the cooperative launch's own error.
  if (len < 1 || (cs != nullptr) != save || (ns != nullptr) != save ||
      (ms != nullptr) != save ||
      !repro::valid_geometry(batch, d, ctas, units, threads, rows, route, smem))
    return cudaErrorInvalidValue;
  const repro::ScanArgs args{in(xg), in(wr), in(bias), in(c0), in(n0), in(h0), in(m0), out(hs),
                             out(cf), out(nf), out(hf), out(mf), out(gates), out(cs), out(ns),
                             out(ms), static_cast<unsigned long long*>(count), batch, len, d,
                             units, rows};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto kernel = repro::scan_kernel(route, save);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return repro::launch_cooperative(kernel, ctas, threads, smem, static_cast<cudaStream_t>(stream),
                                   args);
}

// Blocks of the scan kernel of `route` that one SM holds at `threads`
// threads and `smem` bytes (from the occupancy calculator); a negative
// value is a CUDA error.
extern "C" int repro_slstm_occupancy(int threads, int smem, int route, int device) {
  if (threads != repro::kThreads || smem < 0 || smem > repro::kSmemLimit)
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const auto kernel = repro::scan_kernel(route);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// `steps` grid barriers on ctas CTAs of `threads` threads, cooperatively
// launched as the scan is; count one zeroed uint64. For timing only.
extern "C" int repro_slstm_barriers(void* count, int ctas, int threads, int steps, int device,
                                    void* stream) {
  if (ctas < 1 || steps < 1 || threads != repro::kThreads)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return repro::launch_cooperative(repro::slstm_barrier_kernel, ctas, threads, 0,
                                   static_cast<cudaStream_t>(stream),
                                   static_cast<unsigned long long*>(count), steps);
}
