// The sLSTM recurrence's backward over a whole sequence: slstm_scan_bwd.
//
// No TPU kernel: the reference differentiates its lax.scan over
// _slstm_step (src/repro/models/xlstm.py:272) by XLA. This is the reverse
// of slstm_scan.cu's recurrence, on the same grid.
//
// What it computes: given what the saving forward wrote (each step's gate
// pre-activations, bias included, and c, n, m after it), the initial
// states, the cotangent dhs (B, L, D) of hs and those of the four final
// states, it writes dxg (B, L, 4D), the gradient of the gate inputs, and
// the initial states' gradients dc0, dn0, dh0, dm0: those of autograd of
// kernels/slstm_scan.py's slstm_scan_plain, through the stabiliser m, the
// log-sigmoid and the clamp n >= 1e-6, with a tie of max(log f + m, i)
// split in half as torch.maximum and jnp.maximum split it. m0 = -inf gives
// finite gradients: f = exp(-inf) = 0 multiplies only finite values, and
// the max's gradient is selected, never multiplied by a 0 weight. dwr and
// dbias are off the serial chain: the wrapper forms them from dxg with one
// batched product and one sum.
//
// Bound on an H100: 2 B L D^2 flops (the transposed recurrent product: 69
// GFLOP at B 8, L 4096, D 1024) over the FP64 tensor cores' 67 TFLOP/s,
// 1.03 ms; bytes: dhs, the gates and c, n, m read once, dxg written once,
// 12 B L D floats, 0.48 ms. As in the forward, L grid barriers are the
// floor (slstm_barriers): each step needs all of the next step's gate
// gradients.
//
// Design: slstm_scan.cu's grid (kernels/slstm_scan.py's slstm_grid: at
// most one CTA an SM, each owning `units` consecutive units), run from
// t = L-1 down to 0 with one grid barrier a step:
// - (a) The elementwise step, for each owned (b, u): dh = dhs[b, t, u] +
//   the recurrent part (the final state's cotangent at t = L-1), the
//   step's gates recomputed from its saved pre-activations and the saved
//   c, n, m of step t-1 (the initial state at t = 0), and the carries dc,
//   dn, dm in shared memory, as the forward keeps c, n, m. The four gate
//   gradients go to dxg[b, t, g D + u]. What does not depend on the
//   carries (the saved values, the step's gates recomputed, their
//   derivatives) a thread forms for its next step while the grid waits on
//   the barrier (Pre).
// - (b) The grid barrier of slstm_grid.cuh.
// - (c) The transposed product. Head k's slice of h feeds only gate block
//   k (the head-major wiring), so for u = k hd + r the recurrent part of
//   dh_{t-1}[b, u] is sum_u' dg_t[b, block k, u'] wr[k][r, u'], and wr's
//   row (k, r) is row u of wr read as (D, D). Each CTA reads block k of
//   the step's gate gradients (B x D floats from L2; two blocks where its
//   units straddle two heads) into shared memory and multiplies it by its
//   units' rows of wr, held in shared memory in double for the whole
//   sequence where they fit (64 KB at D 1024, 128 CTAs), else in float32,
//   else read every step (the global route, D 4096). The products run on
//   the FP64 tensor cores (mma.sync m8n8k4): tiles of 8 batch rows x 8
//   units, K = D cut in kSplits parts, one warp an item, the parts summed
//   in double and rounded once.
// One barrier a step suffices: the units a CTA owns in (a) are the ones
// it produces in (c). After step 0 one more product gives dh0. Batches
// whose rows do not fit run in groups of `rows`, each over all L steps.
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
constexpr int kSplits = kWarps;  // parts of K a tile's product is cut into
constexpr long long kSmemLimit = 232448;  // 227 KB a block

// Where a CTA keeps its rows of wr, as slstm_scan.cu's Route.
enum Route { kGlobal = 0, kSmemF32 = 1, kSmemF64 = 2 };

// Elements between consecutive rows of wr and of the gate gradients in
// shared memory: D plus 4, so that the rows of a warp's loads start in
// distinct banks. D is a multiple of 4, so K needs no padding.
__host__ __device__ inline int bwd_row_stride(int d) { return d + 4; }

// Heads the units u0 .. u0+cnt-1 belong to: the blocks of gate gradients
// the CTA reads.
__host__ __device__ inline int heads_spanned(int d, int u0, int cnt) {
  const int hd = d / kHeads;
  return (u0 + cnt - 1) / hd - u0 / hd + 1;
}

// The most heads a CTA of `units` units spans.
int most_heads_spanned(int d, int units) {
  int most = 1;
  for (int u0 = 0; u0 < d; u0 += units) most = max(most, heads_spanned(d, u0, min(units, d - u0)));
  return most;
}

// Shared memory of a CTA, in floats, in this order: the rows of wr (units
// rows of ws, in float32 or double; none on the global route), the gate
// gradients (span x rows rows of ws), the products' kSplits parts (rows x
// units doubles each) and the carries dc, dn, dm (rows x units each).
// kernels/slstm_scan.py's slstm_bwd_grid computes the same.
__host__ __device__ inline long long bwd_smem_floats(int d, int units, int rows, int route,
                                                     int span) {
  const long long ws = bwd_row_stride(d);
  return static_cast<long long>(route) * units * ws + static_cast<long long>(span) * rows * ws +
         2LL * kSplits * rows * units + 3LL * rows * units;
}

struct BwdArgs {
  const float* gates;  // (batch, len, 4 d): pre-activations, bias included
  const float* cs;     // (batch, len, d): c, n, m after each step
  const float* ns;
  const float* ms;
  const float* wr;     // (4, hd, d)
  const float* c0;     // (batch, d), and n0, m0
  const float* n0;
  const float* m0;
  const float* dhs;    // (batch, len, d)
  const float* dcf;    // (batch, d): the final states' cotangents
  const float* dnf;
  const float* dhf;
  const float* dmf;
  float* dxg;          // (batch, len, 4 d)
  float* dc0;          // (batch, d), and dn0, dh0, dm0
  float* dn0;
  float* dh0;
  float* dm0;
  unsigned long long* count;  // the grid barrier's count, 0 at launch
  int batch, len, d, units, rows;
};

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// What step t of a pair's backward needs that depends on the saved
// forward alone: its saved c and n, those of step t-1, dhs, and the step's
// gates recomputed as slstm_scan.cu computes them. Formed while the grid
// waits on the barrier before the step.
struct Pre {
  float c, n, cp, np;  // after step t and after step t-1 (the initial state at t = 0)
  float dh;            // dhs[b, t, u]
  float i_sc, f_sc, tz, so, ncl;
  float hn;            // h / max(n, 1e-6)
  float dlsig;         // log-sigmoid's derivative at f, sigmoid(-f), as torch forms it
  int order;           // of log f + m_{t-1} against i: 1 above, 0 a tie, -1 below
};

__device__ __forceinline__ Pre prepare(const BwdArgs& a, size_t row, int t, int u) {
  const int d = a.d;
  const size_t o = row * a.len + t;
  const float* gp = a.gates + o * kHeads * d + u;
  const float ig = __ldg(gp), fg = __ldg(gp + d), zg = __ldg(gp + 2 * d), og = __ldg(gp + 3 * d);
  Pre p;
  p.c = __ldg(a.cs + o * d + u);
  p.n = __ldg(a.ns + o * d + u);
  float mp;
  if (t > 0) {
    p.cp = __ldg(a.cs + (o - 1) * d + u);
    p.np = __ldg(a.ns + (o - 1) * d + u);
    mp = __ldg(a.ms + (o - 1) * d + u);
  } else {
    p.cp = __ldg(a.c0 + row * d + u);
    p.np = __ldg(a.n0 + row * d + u);
    mp = __ldg(a.m0 + row * d + u);
  }
  p.dh = __ldg(a.dhs + o * d + u);
  const float log_f = log_sigmoid(fg);
  const float am = log_f + mp;
  const float m = fmaxf(am, ig);
  p.i_sc = expf(ig - m);
  p.f_sc = expf(am - m);
  p.tz = tanhf(zg);
  p.so = sigmoid(og);
  p.ncl = fmaxf(p.n, 1e-6f);
  p.hn = (p.so * p.c / p.ncl) / p.ncl;
  const float z = expf(-fabsf(fg));
  p.dlsig = fg < 0.f ? 1.f - z / (1.f + z) : z / (1.f + z);
  p.order = am > ig ? 1 : am == ig ? 0 : -1;
  return p;
}

// One pair's step backward, as autograd runs kernels/slstm_scan.py's
// slstm_step backward: dh is dh_t, (dc, dn, dm) the carries into step t;
// on return they hold the carries into step t-1 and dg the gate gradients.
// m0 = -inf gives f_sc = 0 and order -1, so no 0 x inf is formed.
__device__ __forceinline__ void step_backward(const Pre& p, float dh, float& dc, float& dn,
                                              float& dm, float (&dg)[kHeads]) {
  // h = (so c) / max(n, 1e-6)
  const float q = dh / p.ncl;
  const float dso = q * p.c;
  const float dc_t = dc + q * p.so;
  const float dn_t = dn + (p.n >= 1e-6f ? -dh * p.hn : 0.f);
  // c = f_sc cp + i_sc tanh(z), n = f_sc np + i_sc
  const float e_i = (dc_t * p.tz + dn_t) * p.i_sc;  // of i - m
  const float e_f = (dc_t * p.cp + dn_t * p.np) * p.f_sc;  // of log f + m_{t-1} - m
  // m = max(log f + m_{t-1}, i): the whole gradient to the larger, half each on a tie
  const float dm_t = dm - e_i - e_f;
  const float half = 0.5f * dm_t;
  const float da = e_f + (p.order > 0 ? dm_t : p.order == 0 ? half : 0.f);
  dg[0] = e_i + (p.order < 0 ? dm_t : p.order == 0 ? half : 0.f);
  dg[1] = da * p.dlsig;
  dg[2] = dc_t * p.i_sc * (1.f - p.tz * p.tz);
  dg[3] = dso * (1.f - p.so) * p.so;
  dc = dc_t * p.f_sc;
  dn = dn_t * p.f_sc;
  dm = da;
}

// A warp's item of the product: an 8 x 8 tile (batch rows 8 mt .., units
// 8 nt ..) over part `split` of K. Rows and units past the edge repeat the
// last one and are not stored. Per lane: A's row b and B's column uu, the
// output it holds (row bo, units uo and uo + 1), and the heads of the
// tile's first and last units.
struct BwdItem {
  int split, b, uu, bo, uo, k_lo, k_hi;
};

__device__ __forceinline__ BwdItem bwd_item(int item, int nb, int cnt, int u0, int hd) {
  const int nts = (cnt + 7) / 8;
  const int lane = threadIdx.x % 32, grp = lane / 4, tig = lane % 4;
  const int tile = item / kSplits, mt = tile / nts, nt = tile - mt * nts;
  return {item - tile * kSplits, min(8 * mt + grp, nb - 1), min(8 * nt + grp, cnt - 1),
          8 * mt + grp, 8 * nt + 2 * tig, (u0 + 8 * nt) / hd, (u0 + min(8 * nt + 7, cnt - 1)) / hd};
}

// A thread's loads of the gate gradients a step from offsets found once a
// group (runtime divisions on a step's path cost more than the loads):
// float4s of one head's block at B 8, D 1024 are 8 a thread. The rest,
// where a step has more, take the general path; REPRO_SLSTM_SLOTS=0 (a
// build of the CPU emulator's tests) sends all there.
#ifndef REPRO_SLSTM_SLOTS
#define REPRO_SLSTM_SLOTS 1
#endif
constexpr int kGSlots = 8 * REPRO_SLSTM_SLOTS;

template <int kRoute>
__global__ void __launch_bounds__(kThreads) slstm_scan_bwd_kernel(BwdArgs a) {
  using W = std::conditional_t<kRoute == kSmemF64, double, float>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = a.d, len = a.len, units = a.units, rows = a.rows;
  const int hd = d / kHeads;
  const int ws = bwd_row_stride(d);
  const int kq = d / 4;  // steps of 4 along one head's block of K
  const int u0 = blockIdx.x * units;
  const int cnt = min(units, d - u0);  // the last CTA may own fewer
  const int k0 = u0 / hd;              // the first head of the CTA's units
  const int span = heads_spanned(d, u0, cnt);
  const int tid = threadIdx.x, warp = tid / 32, tig = tid % 4;
  // Pairs go to the last threads first, so that thread 0, which polls the
  // grid barrier, forms the next step's values last or not at all.
  const int lead = kThreads - 1 - tid;
  W* w_s = reinterpret_cast<W*>(smem);
  float* g_s = smem + kRoute * units * ws;
  double* part_s = reinterpret_cast<double*>(g_s + span * rows * ws);  // 16-byte aligned
  float* dc_s = reinterpret_cast<float*>(part_s + kSplits * rows * units);
  float* dn_s = dc_s + rows * units;
  float* dm_s = dn_s + rows * units;

  // The CTA's rows of wr: row uu is wr read as (D, D) at row u0 + uu.
  if constexpr (kRoute != kGlobal) {
    for (int i = tid; i < cnt * d; i += kThreads) {
      const int uu = i / d;
      w_s[uu * ws + i - uu * d] = a.wr[static_cast<size_t>(u0) * d + i];
    }
  }
  const size_t xg_row = static_cast<size_t>(len) * kHeads * d;  // dxg between batch rows
  const int groups = (a.batch + rows - 1) / rows;
  long long step = 0;

  for (int grp = 0; grp < groups; ++grp) {
    const int b0 = grp * rows;
    const int nb = min(rows, a.batch - b0);
    const int pairs = nb * cnt;
    const int items = kSplits * ((nb + 7) / 8) * ((cnt + 7) / 8);
    const int pb = lead / cnt, pu = lead - pb * cnt;  // the first pair's row and unit
    const bool mine = lead < pairs;
    const int total = span * nb * kq;  // float4s of gate gradients a step
    // Element i of a step's gate gradients for the CTA: head k0 + h, batch
    // row b, float4 qq; its offset from the group's row b0 at the step and
    // into g_s.
    const auto g_offsets = [&](int i, long long& src, int& dst) {
      const int r = i / kq, qq = i - r * kq, h = r / nb, b = r - h * nb;
      src = static_cast<long long>(b) * xg_row + static_cast<long long>(h) * d + 4 * qq;
      dst = (h * rows + b) * ws + 4 * qq;
    };
    long long g_src[kGSlots > 0 ? kGSlots : 1];
    int g_dst[kGSlots > 0 ? kGSlots : 1];
#pragma unroll
    for (int j = 0; j < kGSlots; ++j)
      if (tid + j * kThreads < total) g_offsets(tid + j * kThreads, g_src[j], g_dst[j]);

    // g_s <- the gate gradients of step t for the CTA's heads, then the
    // recurrent part of dh_{t-1} for every owned pair into part_s.
    const auto product = [&](int t) {
      const float* src = a.dxg + (static_cast<size_t>(b0) * len + t) * kHeads * d +
                         static_cast<size_t>(k0) * d;
      {
        float4 v[kGSlots > 0 ? kGSlots : 1];
#pragma unroll
        for (int j = 0; j < kGSlots; ++j)
          if (tid + j * kThreads < total) v[j] = __ldcg(reinterpret_cast<const float4*>(src + g_src[j]));
#pragma unroll
        for (int j = 0; j < kGSlots; ++j)
          if (tid + j * kThreads < total) *reinterpret_cast<float4*>(g_s + g_dst[j]) = v[j];
      }
      constexpr int kLoads = 8;
      for (int base = kGSlots * kThreads + tid; base < total; base += kLoads * kThreads) {
        float4 v[kLoads];
        int dst[kLoads];
#pragma unroll
        for (int j = 0; j < kLoads; ++j)
          if (base + j * kThreads < total) {
            long long off;
            g_offsets(base + j * kThreads, off, dst[j]);
            v[j] = __ldcg(reinterpret_cast<const float4*>(src + off));
          }
#pragma unroll
        for (int j = 0; j < kLoads; ++j)
          if (base + j * kThreads < total) *reinterpret_cast<float4*>(g_s + dst[j]) = v[j];
      }
      __syncthreads();
      for (int item = warp; item < items; item += kWarps) {
        const BwdItem it = bwd_item(item, nb, cnt, u0, hd);
        const int ku = (u0 + it.uu) / hd;  // the lane's unit's head
        // This split's part of the tile's K: the blocks of heads k_lo .. k_hi.
        const int nq = (it.k_hi - it.k_lo + 1) * kq;
        const int per = (nq + kSplits - 1) / kSplits;
        const int qa = min(nq, it.split * per), qb = min(nq, qa + per);
        double c[4][2] = {};
        for (int k = it.k_lo; k <= it.k_hi; ++k) {
          const int lo = (k - it.k_lo) * kq;
          int q = max(qa, lo) - lo;
          const int q1 = min(qb, lo + kq) - lo;
          const float* gp = g_s + ((k - k0) * rows + it.b) * ws + tig;
          const bool own = ku == k;  // B is 0 where the lane's unit is of another head
          if constexpr (kRoute != kGlobal) {
            const W* wp = w_s + it.uu * ws + tig;
            const auto w = [&](int qq) { return own ? static_cast<double>(wp[4 * qq]) : 0.0; };
            for (; q + 3 < q1; q += 4)
#pragma unroll
              for (int j = 0; j < 4; ++j) mma_m8n8k4(c[j][0], c[j][1], gp[4 * (q + j)], w(q + j));
            for (; q < q1; ++q) mma_m8n8k4(c[0][0], c[0][1], gp[4 * q], w(q));
          } else {
            const float* wp = a.wr + static_cast<size_t>(u0 + it.uu) * d + tig;
            const auto w = [&](int qq) { return own ? static_cast<double>(__ldg(wp + 4 * qq)) : 0.0; };
            for (; q + 3 < q1; q += 4)
#pragma unroll
              for (int j = 0; j < 4; ++j) mma_m8n8k4(c[j][0], c[j][1], gp[4 * (q + j)], w(q + j));
            for (; q < q1; ++q) mma_m8n8k4(c[0][0], c[0][1], gp[4 * q], w(q));
          }
        }
        double* out = part_s + (it.split * rows + it.bo) * units + it.uo;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (it.bo < nb && it.uo + j < cnt) out[j] = (c[0][j] + c[1][j]) + (c[2][j] + c[3][j]);
      }
      __syncthreads();
    };
    // The recurrent part of dh for pair (b, uu), summed over the parts.
    const auto recurrent = [&](int b, int uu) {
      double s = 0.0;
#pragma unroll
      for (int j = 0; j < kSplits; ++j) s += part_s[(j * rows + b) * units + uu];
      return static_cast<float>(s);
    };

    for (int p = lead; p < pairs; p += kThreads) {
      const int b = p / cnt, uu = p - b * cnt;
      const size_t f = static_cast<size_t>(b0 + b) * d + u0 + uu;
      dc_s[b * units + uu] = a.dcf[f];
      dn_s[b * units + uu] = a.dnf[f];
      dm_s[b * units + uu] = a.dmf[f];
    }
    Pre next{};
    if (mine) next = prepare(a, b0 + pb, len - 1, u0 + pu);

    for (int t = len - 1; t >= 0; --t) {
      if (t < len - 1) product(t + 1);
      else __syncthreads();  // the carries stored
      const Pre first = next;
      for (int p = lead; p < pairs; p += kThreads) {
        const int b = p == lead ? pb : p / cnt;
        const int uu = p == lead ? pu : p - b * cnt;
        const size_t row = static_cast<size_t>(b0 + b);
        const Pre pre = p == lead ? first : prepare(a, row, t, u0 + uu);
        const float rec = t == len - 1 ? a.dhf[row * d + u0 + uu] : recurrent(b, uu);
        const int o = b * units + uu;
        float dc = dc_s[o], dn = dn_s[o], dm = dm_s[o], dg[kHeads];
        step_backward(pre, pre.dh + rec, dc, dn, dm, dg);
        dc_s[o] = dc;
        dn_s[o] = dn;
        dm_s[o] = dm;
        float* gp = a.dxg + (row * len + t) * kHeads * d + u0 + uu;
#pragma unroll
        for (int g = 0; g < kHeads; ++g) gp[g * d] = dg[g];
      }
      __syncthreads();  // dxg of this step stored; part_s and the carries read
      grid_arrive(a.count);
      if (t > 0 && mine) next = prepare(a, b0 + pb, t - 1, u0 + pu);
      grid_wait(a.count, static_cast<unsigned long long>(gridDim.x) * ++step);
    }
    // dh0 from step 0's gate gradients, and the carries out of step 0.
    product(0);
    for (int p = lead; p < pairs; p += kThreads) {
      const int b = p / cnt, uu = p - b * cnt;
      const size_t f = static_cast<size_t>(b0 + b) * d + u0 + uu;
      const int o = b * units + uu;
      a.dh0[f] = recurrent(b, uu);
      a.dc0[f] = dc_s[o];
      a.dn0[f] = dn_s[o];
      a.dm0[f] = dm_s[o];
    }
    __syncthreads();  // part_s and the carries read before the next group
  }
}

using BwdKernel = void (*)(BwdArgs);

BwdKernel bwd_kernel(int route) {
  return route == kSmemF64 ? slstm_scan_bwd_kernel<kSmemF64>
         : route == kSmemF32 ? slstm_scan_bwd_kernel<kSmemF32>
                             : slstm_scan_bwd_kernel<kGlobal>;
}

// The geometry the host computed (slstm_bwd_grid) must cover d once and
// match the shared memory this file lays out.
bool valid_bwd_geometry(int batch, int d, int ctas, int units, int threads, int rows, int route,
                        int smem) {
  if (batch < 1 || d < kHeads || d % kHeads != 0 || units < 1 || ctas < 1 || rows < 1 ||
      rows > batch || route < kGlobal || route > kSmemF64)
    return false;
  if (static_cast<long long>(ctas) * units < d || static_cast<long long>(ctas - 1) * units >= d)
    return false;
  if (threads != kThreads) return false;
  const long long bytes = 4 * bwd_smem_floats(d, units, rows, route, most_heads_spanned(d, units));
  return bytes == smem && bytes <= kSmemLimit;
}

}  // namespace
}  // namespace repro

// gates (batch, len, 4d), cs, ns, ms (batch, len, d): what
// repro_slstm_scan's saving instance wrote; wr (4, d/4, d); c0, n0, m0,
// dcf, dnf, dhf, dmf, dc0, dn0, dh0, dm0 (batch, d); dhs (batch, len, d);
// dxg (batch, len, 4d); all float32, contiguous; count one zeroed uint64. The grid as
// slstm_bwd_grid gives it; smem bytes as bwd_smem_floats.
extern "C" int repro_slstm_scan_bwd(const void* gates, const void* cs, const void* ns,
                                    const void* ms, const void* wr, const void* c0,
                                    const void* n0, const void* m0, const void* dhs,
                                    const void* dcf, const void* dnf, const void* dhf,
                                    const void* dmf, void* dxg, void* dc0, void* dn0, void* dh0,
                                    void* dm0, void* count, int batch, int len, int d, int ctas,
                                    int units, int threads, int rows, int route, int smem,
                                    int device, void* stream) {
  // A geometry slstm_bwd_grid did not give is an invalid value; a grid the
  // card cannot hold at once is the cooperative launch's own error.
  if (len < 1 || !repro::valid_bwd_geometry(batch, d, ctas, units, threads, rows, route, smem))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto kernel = repro::bwd_kernel(route);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto g = [](void* p) { return static_cast<float*>(p); };
  const repro::BwdArgs args{f(gates), f(cs), f(ns), f(ms), f(wr), f(c0), f(n0), f(m0), f(dhs),
                            f(dcf), f(dnf), f(dhf), f(dmf), g(dxg), g(dc0), g(dn0), g(dh0),
                            g(dm0), static_cast<unsigned long long*>(count), batch, len, d,
                            units, rows};
  return repro::launch_cooperative(kernel, ctas, threads, smem,
                                   static_cast<cudaStream_t>(stream), args);
}

// Blocks of the backward kernel of `route` that one SM holds at `threads`
// threads and `smem` bytes (from the occupancy calculator); a negative
// value is a CUDA error.
extern "C" int repro_slstm_bwd_occupancy(int threads, int smem, int route, int device) {
  if (threads != repro::kThreads || smem < 0 || smem > repro::kSmemLimit)
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const auto kernel = repro::bwd_kernel(route);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
