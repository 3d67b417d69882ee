// The register-pass Stockham panel of the radix-4 fft_fused and rfft_fused
// kernels (fft_fused.cu): rows of n = 2^log_n values that fit one block.
//
// Replaces the in-VMEM radix-4 panel of src/repro/kernels/fft_radix2.py
// (_stockham_panel_r4) for those two kernels; stockham.cuh's stage-at-a-time
// panel stays for the others.
//
// A row is factored into passes of 16 values: 16 * 16 * ... * r, with the
// last pass taking what is left (r = 8: one radix-2 and one radix-4 layer,
// 4: one radix-4, 2: one radix-2); a row shorter than 16 is one pass of
// radix n. In a pass of radix R over span l (the product of the earlier
// radices), group t of a line holds
//   a_j = in[t + j n/R] * W_{R l}^{j k},  k = t mod l,  q = t / l,
// runs the R-point DFT in registers as two layers of radix 4 (or 2) with
// the inner twiddles W_R as compile-time constants, and writes output c to
// the Stockham position q R l + c l + k. Each thread holds 16 values: one
// group of 16, or 16/R groups of a smaller radix. So a pass costs one read
// and one write of the block's values, where a stage-at-a-time radix-4
// panel costs one of each per two butterfly layers.
//
// The first pass loads from HBM (l = 1: no twiddles, so the ROM is not read
// before the first barrier); fft_fused's last pass stores to HBM, at
// t + c n/R, coalesced (rfft_fused's recombines first, fft_fused.cu).
// Between passes the values go through shared memory in place: read,
// barrier, compute, write, barrier.
//
// Shared-memory layout. With 8-byte accesses a half-warp touches 16 bank
// pairs (slot mod 16). Every read of a pass (t + j n/R) and every write at
// l >= 16 covers 16 consecutive values, which fall in 16 bank pairs in a
// plain layout. Only the first pass writes at stride R = 16 values (l = 1),
// so its output is padded: value i at slot(i) = i + i/16, stride 17 slots.
// The second pass reads that, and, in place after its barrier, writes the
// lines back plain; later passes stay plain. The twiddle ROM is padded too.
// So every exchange is free of bank conflicts, and so are the mirrored
// runs z[m - k] that rfft_fused reads after two or more passes
// (tests/test_torch_fft_regpass.py holds a numpy model of these accesses).
#pragma once

#include <cuda_runtime.h>

#include "stockham.cuh"

namespace repro {
namespace regs {

constexpr int kValues = 16;  // complex values each thread holds

__host__ __device__ constexpr int padded(int v) { return v + (v >> 4); }

__device__ __forceinline__ int slot(int i) { return i + (i >> 4); }

// rom[slot(j)] = W_{2 half}^j for j < half. A twiddle W_{2 half}^e with
// e < 2 half is rom[e mod half], negated when e >= half.
__device__ __forceinline__ void build_rom(float2* rom, int half) {
  for (int j = threadIdx.x; j < half; j += blockDim.x) {
    float s, c;
    sincospif(-static_cast<float>(j) / static_cast<float>(half), &s, &c);
    rom[slot(j)] = make_float2(c, s);
  }
}

__device__ __forceinline__ float2 rom_twiddle(const float2* rom, int e, int half) {
  const float2 w = rom[slot(e & (half - 1))];
  return (e & half) ? make_float2(-w.x, -w.y) : w;
}

// cos and sin of 2 pi p / 16.
constexpr float kC1 = 0.923879532511286756f;  // cos(pi/8)
constexpr float kS1 = 0.382683432365089772f;  // sin(pi/8)
constexpr float kC2 = 0.707106781186547524f;  // cos(pi/4)

__host__ __device__ constexpr float cos16(int p) {
  constexpr float c[16] = {1.f, kC1, kC2, kS1, 0.f, -kS1, -kC2, -kC1,
                           -1.f, -kC1, -kC2, -kS1, 0.f, kS1, kC2, kC1};
  return c[p & 15];
}

__host__ __device__ constexpr float sin16(int p) { return cos16(p - 4); }

// W_16^P as a constant.
template <int P>
__device__ __forceinline__ float2 w16() {
  return make_float2(cos16(P), -sin16(P));
}

// a * W_16^p, W_16 = exp(-2 pi i / 16): quarter turns are swaps, eighth
// turns two products.
template <int P>
__device__ __forceinline__ float2 mul_w16(float2 a) {
  constexpr int p = P & 15;
  if constexpr (p == 0) {
    return a;
  } else if constexpr (p == 4) {
    return make_float2(a.y, -a.x);
  } else if constexpr (p == 8) {
    return make_float2(-a.x, -a.y);
  } else if constexpr (p == 12) {
    return make_float2(-a.y, a.x);
  } else if constexpr (p == 2) {
    return make_float2(kC2 * (a.x + a.y), kC2 * (a.y - a.x));
  } else if constexpr (p == 6) {
    return make_float2(kC2 * (a.y - a.x), -kC2 * (a.x + a.y));
  } else {
    constexpr float c = cos16(p), s = sin16(p);
    return make_float2(a.x * c + a.y * s, a.y * c - a.x * s);
  }
}

__device__ __forceinline__ void bfly2(float2& a0, float2& a1) {
  const float2 t = a0;
  a0 = cadd(t, a1);
  a1 = csub(t, a1);
}

__device__ __forceinline__ void bfly4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 s02 = cadd(a0, a2), d02 = csub(a0, a2);
  const float2 s13 = cadd(a1, a3), d13 = csub(a1, a3);
  a0 = cadd(s02, s13);
  a1 = make_float2(d02.x + d13.y, d02.y - d13.x);
  a2 = csub(s02, s13);
  a3 = make_float2(d02.x - d13.y, d02.y + d13.x);
}

// The R-point DFT of v[0..R) in registers. R = A B with j = B j1 + j2 and
// c = c1 + A c2: A-point DFTs over j1, the inner twiddle W_R^{j2 c1}, then
// B-point DFTs over j2. Output c is left in v[out_reg<R>(c)].
template <int R>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 2) {
    bfly2(v[0], v[1]);
  } else if constexpr (R == 4) {
    bfly4(v[0], v[1], v[2], v[3]);
  } else if constexpr (R == 8) {  // A = 4, B = 2: y[j2][c1] in v[2 c1 + j2]
#pragma unroll
    for (int j2 = 0; j2 < 2; ++j2) bfly4(v[j2], v[2 + j2], v[4 + j2], v[6 + j2]);
    v[3] = mul_w16<2>(v[3]);
    v[5] = mul_w16<4>(v[5]);
    v[7] = mul_w16<6>(v[7]);
#pragma unroll
    for (int c1 = 0; c1 < 4; ++c1) bfly2(v[2 * c1], v[2 * c1 + 1]);
  } else if constexpr (R == 16) {  // A = B = 4: y[j2][c1] in v[4 c1 + j2]
#pragma unroll
    for (int j2 = 0; j2 < 4; ++j2) bfly4(v[j2], v[4 + j2], v[8 + j2], v[12 + j2]);
    v[5] = mul_w16<1>(v[5]);
    v[6] = mul_w16<2>(v[6]);
    v[7] = mul_w16<3>(v[7]);
    v[9] = mul_w16<2>(v[9]);
    v[10] = mul_w16<4>(v[10]);
    v[11] = mul_w16<6>(v[11]);
    v[13] = mul_w16<3>(v[13]);
    v[14] = mul_w16<6>(v[14]);
    v[15] = mul_w16<9>(v[15]);
#pragma unroll
    for (int c1 = 0; c1 < 4; ++c1) bfly4(v[4 * c1], v[4 * c1 + 1], v[4 * c1 + 2], v[4 * c1 + 3]);
  }
}

template <int R>
__host__ __device__ constexpr int out_reg(int c) {
  return R == 16 ? 4 * (c & 3) + (c >> 2) : R == 8 ? 2 * (c & 3) + (c >> 2) : c;
}

// Passes over a line of 2^log_n values: passes of 16, the last taking what
// is left; a line of at most 16 values is one pass.
__host__ __device__ constexpr int pass_count(int log_n) { return log_n <= 4 ? 1 : (log_n + 3) / 4; }

__host__ __device__ constexpr int last_log_radix(int log_n) {
  return log_n <= 4 ? log_n : log_n - 4 * (pass_count(log_n) - 1);
}

// Where a pass reads its inputs and writes its outputs. Each holds the
// block's lines; read<R, S> fills v[0..R) from elements t + j S of a line,
// write<R, L> puts v[out_reg<R>(c)] at element pos + c L. The strides are
// compile-time constants, so each run of R accesses is one address and
// immediate offsets.

// Shared memory, value i of line `line` at slot(line n + i) when PADDED,
// else at line n + i. A run of stride S (a multiple of 16) has stride
// padded(S) when padded; a run of stride 1 stays inside one aligned group
// of 16 (R | 16, pos a multiple of R).
template <int LOG_N, bool PADDED>
struct SmemLines {
  static constexpr bool kShared = true;
  float2* buf;

  static __device__ __forceinline__ int at(int i) { return PADDED ? slot(i) : i; }

  template <int R, int S>
  __device__ __forceinline__ void read(int line, int t, float2* v, bool ok) const {
    static_assert(S % 16 == 0, "shared-memory reads run over aligned groups of 16");
    if (!ok) line = t = 0;  // a group past the block's values (blocks under 16 values)
    const float2* p = buf + at((line << LOG_N) + t);
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = p[j * (PADDED ? padded(S) : S)];
  }

  template <int R, int L>
  __device__ __forceinline__ void write(int line, int pos, const float2* v, bool ok) const {
    static_assert(L % 16 == 0 || L == 1, "shared-memory writes run over aligned groups");
    if (!ok) return;
    float2* p = buf + at((line << LOG_N) + pos);
#pragma unroll
    for (int c = 0; c < R; ++c) p[c * (L == 1 || !PADDED ? L : padded(L))] = v[out_reg<R>(c)];
  }
};

// Rows in HBM: row row0 + line at x / y + row n; rows past the batch read
// as zero and are not written. Conjugated on the way in and out and scaled
// on the way out when `conj` (the inverse by the forward panel).
template <int LOG_N>
struct HbmRows {
  static constexpr bool kShared = false;
  const float2* x;
  float2* y;
  long long row0;
  int batch;
  int conj;
  float scale;

  template <int R, int S>
  __device__ __forceinline__ void read(int line, int t, float2* v, bool ok) const {
    ok = ok && row0 + line < batch;
    const float2* p = x + ((row0 + line) << LOG_N) + t;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float2 a = ok ? p[j * S] : make_float2(0.f, 0.f);
      v[j] = conj ? cconj(a) : a;
    }
  }

  template <int R, int L>
  __device__ __forceinline__ void write(int line, int pos, const float2* v, bool ok) const {
    if (!ok || row0 + line >= batch) return;
    float2* p = y + ((row0 + line) << LOG_N) + pos;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const float2 a = v[out_reg<R>(c)];
      p[c * L] = make_float2(a.x * scale, (conj ? -a.y : a.y) * scale);
    }
  }
};

// One register pass of radix 2^LR over span 2^LOG_L on the block's lines of
// 2^LOG_N values (P values in all; groups g = threadIdx.x + i blockDim.x).
// Group t of a line reads in[t + j n/R], multiplies by W_{R l}^{j k} from
// the ROM (W_{2^(LOG_HALF+1)}^j, j < 2^LOG_HALF), runs the R-point DFT and
// writes out[q R l + c l + k]. A pass that reads and writes shared memory
// does it in place: it synchronises between its reads and its writes.
template <int LOG_N, int LR, int LOG_L, int LOG_HALF, class Src, class Dst>
__device__ __forceinline__ void pass(int P, const float2* rom, const Src& src, const Dst& dst) {
  constexpr int R = 1 << LR;
  constexpr int G = kValues / R;
  constexpr int LOG_S = LOG_N - LR;  // n/R groups per line
  constexpr int S = 1 << LOG_S;
  constexpr int L = 1 << LOG_L;
  const int groups = P >> LR;
  float2 v[kValues];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int g = threadIdx.x + i * blockDim.x;
    src.template read<R, S>(g >> LOG_S, g & (S - 1), v + i * R, g < groups);
  }
  if constexpr (Src::kShared && Dst::kShared) __syncthreads();
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int g = threadIdx.x + i * blockDim.x;
    const int t = g & (S - 1);
    const int k = t & (L - 1);
    if constexpr (LOG_L > 0) {
      // W_{R l}^{j k} = W_{2 half}^{j e1}, e1 = k << shift
      constexpr int kShift = LOG_HALF + 1 - LR - LOG_L;
      const int e1 = k << kShift;
#pragma unroll
      for (int j = 1; j < R; ++j)
        v[i * R + j] = cmul(v[i * R + j], rom_twiddle(rom, j * e1, 1 << LOG_HALF));
    }
    dft<R>(v + i * R);
    dst.template write<R, L>(g >> LOG_S, ((t >> LOG_L) << (LOG_L + LR)) + k, v + i * R,
                             g < groups);
  }
}

// The layout the last pass of a line of 2^LOG_N values reads: padded after
// the first pass only (a line of two passes), plain after a middle pass.
template <int LOG_N>
using LastLines = SmemLines<LOG_N, pass_count(LOG_N) == 2>;

// Every pass but the last (a line of more than 16 values): src -> first
// pass -> padded shared memory -> middle passes of 16 in place, the first
// of them rewriting the lines unpadded, ending on a barrier, so that the
// last pass may read LastLines. The caller writes the ROM before the call:
// it is read only after the first barrier.
template <int LOG_N, int LOG_HALF, class Src>
__device__ __forceinline__ void panel_head(float2* buf, int P, const float2* rom, const Src& src) {
  constexpr int NP = pass_count(LOG_N);
  static_assert(NP >= 2 && NP <= 4, "lines of 2^5 to 2^16 values");
  const SmemLines<LOG_N, true> padded_lines{buf};
  const SmemLines<LOG_N, false> lines{buf};
  pass<LOG_N, 4, 0, LOG_HALF>(P, rom, src, padded_lines);
  if constexpr (NP >= 3) {
    __syncthreads();
    pass<LOG_N, 4, 4, LOG_HALF>(P, rom, padded_lines, lines);
  }
  if constexpr (NP >= 4) {
    __syncthreads();
    pass<LOG_N, 4, 8, LOG_HALF>(P, rom, lines, lines);
  }
  __syncthreads();
}

// The whole panel over the block's lines: src -> passes -> dst (src -> dst
// when one pass does the line). With dst in shared memory (rfft_fused) the
// last pass is in place too, and the caller synchronises before reading the
// result: unpadded after two or more passes, padded after a single one.
template <int LOG_N, int LOG_HALF, class Src, class Dst>
__device__ __forceinline__ void panel(float2* buf, int P, const float2* rom, const Src& src,
                                      const Dst& dst) {
  constexpr int NP = pass_count(LOG_N);
  if constexpr (NP == 1) {
    pass<LOG_N, LOG_N, 0, LOG_HALF>(P, rom, src, dst);
  } else {
    panel_head<LOG_N, LOG_HALF>(buf, P, rom, src);
    pass<LOG_N, last_log_radix(LOG_N), 4 * (NP - 1), LOG_HALF>(P, rom, LastLines<LOG_N>{buf},
                                                               dst);
  }
}

// Two-for-one recombination Y = Xe + w Xo from z = Z[k] and zm = conj Z[m-k]
// (stockham.cuh's rfft_recombine on values already read).
__device__ __forceinline__ float2 recombine(float2 z, float2 zm, float2 w) {
  const float2 xe = make_float2(0.5f * (z.x + zm.x), 0.5f * (z.y + zm.y));
  const float2 d = csub(z, zm);
  const float2 xo = make_float2(0.5f * d.y, -0.5f * d.x);
  return make_float2(xe.x + w.x * xo.x - w.y * xo.y, xe.y + w.x * xo.y + w.y * xo.x);
}

// ------------------------------ host side -------------------------------

// The host census of the register-pass kernels: the thread contract of
// geometry_ok, and room for P values and a ROM of rom_len, each padded by
// one slot per 16.
inline bool geometry_ok(int P, int threads, int smem, int rom_len) {
  const int need = (padded(P) + padded(rom_len)) * static_cast<int>(sizeof(float2));
  return smem >= need && repro::geometry_ok(P, threads, need, 0);
}

}  // namespace regs
}  // namespace repro
