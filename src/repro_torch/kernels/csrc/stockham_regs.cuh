// The register-pass Stockham panel of every FFT kernel, at both radices:
// rows of n = 2^log_n values that fit one block (fft_fused, rfft_fused and
// irfft_fused, fft_fused.cu); the lines of the cluster kernel
// (fft_cluster.cu); both passes of the two-pass kernels (fft_two_pass.cu);
// over a frame's rows and its columns, fft2_fused, rfft2_fused and
// irfft2_fused (the "whole frames" section below); and, over a panel of
// columns of a frame in HBM, fft2_columns (fft2_columns.cu). The radix-4
// kernels run two radix-4 layers a pass, the radix-2 ones four radix-2
// Stockham stages (r2_layers below).
//
// Replaces the in-VMEM Stockham panels of src/repro/kernels/fft_radix2.py,
// the radix-4 one and the radix-2 one.
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
// panel costs one of each per two butterfly layers. The radix-2 kernels run
// the same passes with the pass's log2 R radix-2 Stockham stages in
// registers in place of the DFT and its input twiddles (r2_layers).
//
// The first pass loads from HBM (l = 1: no twiddles, so the ROM is not read
// before the first barrier; irfft_fused's untangle takes its twiddles from
// sincospif, w_2m; a radix-2 first pass reads its constant twiddles from the
// ROM after a barrier that follows its loads); fft_fused's last pass stores
// to HBM, at t + c n/R, coalesced (rfft_fused's recombines first,
// fft_fused.cu).
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

#include <utility>

#include "fft_common.cuh"

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

// cos(2 pi p / 32) for |p| <= 16.
__host__ __device__ constexpr float cos32(int p) {
  constexpr float c[17] = {1.f, 0.980785280403230431f, kC1, 0.831469612302545236f, kC2,
                           0.555570233019602289f, kS1, 0.195090322016128331f, 0.f,
                           -0.195090322016128331f, -kS1, -0.555570233019602289f, -kC2,
                           -0.831469612302545236f, -kC1, -0.980785280403230431f, -1.f};
  return c[p < 0 ? -p : p];
}

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
// block's lines; read<R>(line, t, s, ...) fills v[0..R) from elements
// t + j s of a line, write<R>(line, pos, l, ...) puts v[out_reg<R>(c)] at
// element pos + c l. The one-block and cluster kernels pass compile-time
// constants for s and l, which fold into immediate offsets: each run of R
// accesses is one address.

// Shared memory, value i of line `line` at slot(line n + i) when PADDED,
// else at line n + i. A run of stride s (a multiple of 16) has stride
// padded(s) when padded; a run of stride 1 stays inside one aligned group
// of 16 (R | 16, pos a multiple of R).
template <int LOG_N, bool PADDED>
struct SmemLines {
  static constexpr bool kShared = true;
  float2* buf;

  static __device__ __forceinline__ int at(int i) { return PADDED ? slot(i) : i; }

  template <int R>
  __device__ __forceinline__ void read(int line, int t, int s, float2* v, bool ok) const {
    if (!ok) line = t = 0;  // a group past the block's values (blocks under 16 values)
    const float2* p = buf + at((line << LOG_N) + t);
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = p[j * (PADDED ? padded(s) : s)];
  }

  template <int R>
  __device__ __forceinline__ void write(int line, int pos, int l, const float2* v, bool ok) const {
    if (!ok) return;
    float2* p = buf + at((line << LOG_N) + pos);
#pragma unroll
    for (int c = 0; c < R; ++c) p[c * (l == 1 || !PADDED ? l : padded(l))] = v[out_reg<R>(c)];
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

  // The conjugation is a product by -1 or 1, not a select on `conj`, which
  // ptxas split into two copies of a first pass's loads: the 16384-point
  // rows' instances then spilled under their 64 registers.
  template <int R>
  __device__ __forceinline__ void read(int line, int t, int s, float2* v, bool ok) const {
    ok = ok && row0 + line < batch;
    const float2* p = x + ((row0 + line) << LOG_N) + t;
    const float sign = conj ? -1.f : 1.f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float2 a = ok ? p[j * s] : make_float2(0.f, 0.f);
      v[j] = make_float2(a.x, a.y * sign);
    }
  }

  template <int R>
  __device__ __forceinline__ void write(int line, int pos, int l, const float2* v, bool ok) const {
    if (!ok || row0 + line >= batch) return;
    float2* p = y + ((row0 + line) << LOG_N) + pos;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const float2 a = v[out_reg<R>(c)];
      p[c * l] = make_float2(a.x * scale, (conj ? -a.y : a.y) * scale);
    }
  }
};

// Which thread takes which group of a pass (groups g = threadIdx.x + i
// blockDim.x). Over lines that are rows (COLS false) consecutive threads
// take consecutive groups of a line. Over the columns of a frame of rows of
// w values (fft2_fused.cu, rfft2_fused.cu) they take consecutive columns at
// the same group t, so that every access of a half-warp covers consecutive
// columns of one row, or, in a frame narrower than 16, the whole width of
// consecutive rows: the column panel reads and writes runs of consecutive
// values, its twiddle reads are broadcasts, and the corner turn is this
// mapping alone.
template <bool COLS>
struct Lanes {
  int log_w;  // the frame's row length (COLS: its lines are the w columns)

  __device__ __forceinline__ void split(int g, int log_s, int& line, int& t) const {
    if (COLS) {
      line = g & ((1 << log_w) - 1);
      t = g >> log_w;
    } else {
      line = g >> log_s;
      t = g & ((1 << log_s) - 1);
    }
  }
};

// The lowest `bits` bits of v in reverse order.
__host__ __device__ constexpr int bit_reverse(int v, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((v >> b) & 1) << (bits - 1 - b);
  return r;
}

// bit_reverse as a compile-time constant.
template <int V, int BITS>
constexpr int kBitReverse = bit_reverse(V, BITS);

// The butterflies of stage S of r2_layers at top bits H: the values whose
// register indices differ by D = R/2^(S+1) are paired, a +- W b, W =
// W_{2l'}^{k'} at l' = l 2^S and k' = k + l C, C the bit reversal of H (the
// group's outputs of the earlier stages). Every register index and C are
// template constants.
template <int LR, int S, int H>
__device__ __forceinline__ void r2_butterflies(float2* v, int k, int log_l, int log_half,
                                               const float2* rom) {
  constexpr int D = (1 << LR) >> (S + 1);
  constexpr int C = kBitReverse<H, S>;
  const bool one = C == 0 && log_l == 0;  // W = 1
  // e = (k + l C) half / l' = ek + ec: where ec is a multiple of 16, slot(e)
  // = slot(ek) + padded(ec), one address a stage and a constant offset.
  const int ek = k << (log_half - log_l - S);
  const int ec = C << (log_half - S);
  const float2 w = one ? make_float2(1.f, 0.f)
                       : rom[(ec & 15) == 0 ? slot(ek) + padded(ec) : slot(ek + ec)];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float2& a = v[2 * D * H + j];
    float2& b = v[2 * D * H + j + D];
    const float2 tb = one ? b : cmul(b, w);
    b = csub(a, tb);
    a = cadd(a, tb);
  }
}

// Stages S ... LR-1 of r2_layers, stage S's 2^S twiddles one H each.
template <int LR, int S, int... H>
__device__ __forceinline__ void r2_stages(float2* v, int k, int log_l, int log_half,
                                          const float2* rom, std::integer_sequence<int, H...>) {
  (r2_butterflies<LR, S, H>(v, k, log_l, log_half, rom), ...);
  if constexpr (S + 1 < LR)
    r2_stages<LR, S + 1>(v, k, log_l, log_half, rom, std::make_integer_sequence<int, 2 << S>{});
}

// Output c from register bit_reverse(c) to out_reg<R>(c).
template <int LR, int... C>
__device__ __forceinline__ void r2_reorder(float2* v, std::integer_sequence<int, C...>) {
  const float2 o[] = {v[kBitReverse<C, LR>]...};
  ((v[out_reg<1 << LR>(C)] = o[C]), ...);
}

// The radix-2 arithmetic of a pass: the LR radix-2 Stockham stages over
// half-spans l, 2l, ..., l R/2 of the Pallas radix-2 panel, done on group
// t's R values in registers (r2_butterflies): stage S takes 2^S twiddles,
// 15 in a pass of 16. The same butterflies with the same twiddles in the
// same stage order as that panel, which runs one stage at a time; only
// where each value sits between stages differs. The
// twiddles are the ROM's, W_{2 half}^e at e = k' half / l' (never past the
// half turn), none where W = 1; a first pass (l = 1, k = 0) reads the same
// constants for every group, one broadcast each, after the barrier that
// follows its loads (pass). Output c ends in register bit_reverse(c); it is
// moved to out_reg<R>(c), where `write` takes it (renaming registers, no
// instruction).
template <int LR>
__device__ __forceinline__ void r2_layers(float2* v, int k, int log_l, int log_half,
                                          const float2* rom) {
  if constexpr (LR > 0) {
    r2_stages<LR, 0>(v, k, log_l, log_half, rom, std::make_integer_sequence<int, 1>{});
    r2_reorder<LR>(v, std::make_integer_sequence<int, 1 << LR>{});
  }
}

// One register pass of radix 2^LR over span 2^log_l on the block's lines of
// 2^log_n values (P values in all), the groups mapped to threads by
// `lanes`. Group t of a line reads in[t + j n/R]; at RADIX 4 it multiplies
// by W_{R l}^{j k} from the ROM (W_{2 half}^j, j < half = 2^log_half) and
// runs the R-point DFT, at RADIX 2 it runs r2_layers; then it writes
// out[q R l + c l + k]. A pass that reads and writes shared memory does it
// in place: it synchronises between its reads and its writes, and so does
// a radix-2 first pass of more than one layer, which reads the ROM. The
// one-block and cluster kernels pass compile-time geometry; the frame
// kernels' may be runtime values. `lanes` is a Lanes<COLS> or any mapping
// with its split (fft_two_pass.cu's first row pass).
template <int LR, int RADIX = 4, class L, class Src, class Dst>
__device__ __forceinline__ void pass(int P, int log_n, int log_l, int log_half, const L& lanes,
                                     const float2* rom, const Src& src, const Dst& dst) {
  static_assert(RADIX == 2 || RADIX == 4, "radix-2 or radix-4 layers");
  constexpr int R = 1 << LR;
  constexpr int G = kValues / R;
  const int log_s = log_n - LR;  // n/R groups per line
  const int groups = P >> LR;
  float2 v[kValues];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int g = threadIdx.x + i * blockDim.x;
    int line, t;
    lanes.split(g, log_s, line, t);
    src.template read<R>(line, t, 1 << log_s, v + i * R, g < groups);
  }
  // In place, or (radix 2) a first pass, whose twiddles are the ROM's
  // constants: the ROM is written before the panel and read after this.
  if constexpr (Src::kShared && Dst::kShared) {
    __syncthreads();
  } else if constexpr (RADIX == 2 && LR > 1) {
    if (log_l == 0) __syncthreads();
  }
  const int l = 1 << log_l;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int g = threadIdx.x + i * blockDim.x;
    int line, t;
    lanes.split(g, log_s, line, t);
    const int k = t & (l - 1);
    if constexpr (RADIX == 2) {
      r2_layers<LR>(v + i * R, k, log_l, log_half, rom);
    } else {
      if (log_l > 0) {
        // W_{R l}^{j k} = W_{2 half}^{j e1}, e1 = k << (log_half + 1 - LR - log_l)
        const int e1 = k << (log_half + 1 - LR - log_l);
#pragma unroll
        for (int j = 1; j < R; ++j)
          v[i * R + j] = cmul(v[i * R + j], rom_twiddle(rom, j * e1, 1 << log_half));
      }
      dft<R>(v + i * R);
    }
    dst.template write<R>(line, ((t >> log_l) << (log_l + LR)) + k, l, v + i * R, g < groups);
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
// it is read only after the first barrier. RADIX: the passes' layers
// (pass).
template <int LOG_N, int LOG_HALF, int RADIX = 4, class Src>
__device__ __forceinline__ void panel_head(float2* buf, int P, const float2* rom, const Src& src) {
  constexpr int NP = pass_count(LOG_N);
  static_assert(NP >= 2 && NP <= 4, "lines of 2^5 to 2^16 values");
  const SmemLines<LOG_N, true> padded_lines{buf};
  const SmemLines<LOG_N, false> lines{buf};
  const Lanes<false> rows{};
  pass<4, RADIX>(P, LOG_N, 0, LOG_HALF, rows, rom, src, padded_lines);
  if constexpr (NP >= 3) {
    __syncthreads();
    pass<4, RADIX>(P, LOG_N, 4, LOG_HALF, rows, rom, padded_lines, lines);
  }
  if constexpr (NP >= 4) {
    __syncthreads();
    pass<4, RADIX>(P, LOG_N, 8, LOG_HALF, rows, rom, lines, lines);
  }
  __syncthreads();
}

// The whole panel over the block's lines: src -> passes -> dst (src -> dst
// when one pass does the line). With dst in shared memory (rfft_fused) the
// last pass is in place too, and the caller synchronises before reading the
// result: unpadded after two or more passes, padded after a single one.
template <int LOG_N, int LOG_HALF, int RADIX = 4, class Src, class Dst>
__device__ __forceinline__ void panel(float2* buf, int P, const float2* rom, const Src& src,
                                      const Dst& dst) {
  constexpr int NP = pass_count(LOG_N);
  if constexpr (NP == 1) {
    pass<LOG_N, RADIX>(P, LOG_N, 0, LOG_HALF, Lanes<false>{}, rom, src, dst);
  } else {
    panel_head<LOG_N, LOG_HALF, RADIX>(buf, P, rom, src);
    pass<last_log_radix(LOG_N), RADIX>(P, LOG_N, 4 * (NP - 1), LOG_HALF, Lanes<false>{}, rom,
                                       LastLines<LOG_N>{buf}, dst);
  }
}

// ------------------------------ whole frames ------------------------------
//
// fft2_fused and rfft2_fused (fft2_fused.cu, rfft2_fused.cu) hold a frame of
// h rows of w values in shared memory and run the passes over its rows
// (Lanes<false>), then over its columns (Lanes<true>); irfft2_fused over its
// columns, then its rows. One instance serves
// every frame the census admits, so the line length, span and strides of a
// pass may be runtime values; the radix stays a compile-time constant, so
// that a pass's 16 values live in registers. The layouts are those of
// `panel`: the first pass of each panel writes the padded layout (value i
// of the frame at slot(i)), the second reads it and writes the plain one,
// later passes stay plain.

// The frame in shared memory, its lines the rows (element i of row `line` at
// line w + i) or the columns (element i of column `line` at i w + line), in
// the padded layout or the plain one. A run of R elements i0 + j step has
// uniform slots where the layout is plain, where step is a multiple of 16
// (padded step: padded(step)), or where step is 1 (a pass's stride-1 runs
// stay inside one aligned group of 16: R | 16, pos a multiple of R); other
// padded runs (frames under 16 wide or of under 256 values) take the slot of
// each element.
template <bool COLS>
struct SmemFrame {
  static constexpr bool kShared = true;
  float2* buf;
  int log_w;
  bool padded;

  __device__ __forceinline__ int index(int line, int i) const {
    return COLS ? (i << log_w) + line : (line << log_w) + i;
  }

  __device__ __forceinline__ int at(int i) const { return padded ? slot(i) : i; }

  // f(j, pointer to element i0 + j step) for j < R; step in elements of a line.
  template <int R, class F>
  __device__ __forceinline__ void run(int line, int i, int step, F f) const {
    const int i0 = index(line, i);
    const int st = COLS ? step << log_w : step;
    if (!padded || st == 1 || (st & 15) == 0) {
      float2* p = buf + at(i0);
      const int ps = padded && st != 1 ? regs::padded(st) : st;
#pragma unroll
      for (int j = 0; j < R; ++j) f(j, p + j * ps);
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) f(j, buf + slot(i0 + j * st));
    }
  }

  template <int R>
  __device__ __forceinline__ void read(int line, int t, int s, float2* v, bool ok) const {
    if (!ok) line = t = 0;
    run<R>(line, t, s, [&](int j, const float2* p) { v[j] = *p; });
  }

  template <int R>
  __device__ __forceinline__ void write(int line, int pos, int l, const float2* v, bool ok) const {
    if (!ok) return;
    run<R>(line, pos, l, [&](int c, float2* p) { *p = v[out_reg<R>(c)]; });
  }
};

// The frame's rows in HBM (x points at the frame), read by the row panel's
// first pass; the imaginary parts times `sign` (-1 conjugates on the way
// in). The loads are unpredicated, a group past the frame's values (frames
// under 16 values) reading value 0, and their offsets 32-bit, so that each
// address costs one instruction just before its load.
struct HbmFrameRows {
  static constexpr bool kShared = false;
  const float2* x;
  int log_w;
  float sign;

  template <int R>
  __device__ __forceinline__ void read(int line, int t, int s, float2* v, bool ok) const {
    if (!ok) line = t = 0;
    const float2* p = x + static_cast<unsigned>((line << log_w) + t);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float2 a = p[static_cast<unsigned>(j * s)];
      v[j] = make_float2(a.x, a.y * sign);
    }
  }
};

// The frame in HBM (y points at it), written by a panel's last pass: its
// rows (COLS false, element i of row `line` at y[line w + i]) or its columns
// (element i of column `line` at y[i w + line]), times (scale, yscale): the
// inverse conjugates and scales (yscale = -scale). 32-bit offsets.
template <bool COLS>
struct HbmFrameOut {
  static constexpr bool kShared = false;
  float2* y;
  int log_w;
  float scale;
  float yscale;

  template <int R>
  __device__ __forceinline__ void write(int line, int pos, int l, const float2* v, bool ok) const {
    if (!ok) return;
    float2* p = y + static_cast<unsigned>(COLS ? (pos << log_w) + line : (line << log_w) + pos);
    const int step = COLS ? l << log_w : l;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const float2 a = v[out_reg<R>(c)];
      p[static_cast<unsigned>(c * step)] = make_float2(a.x * scale, a.y * yscale);
    }
  }
};

// A panel of neighbouring columns of one frame in HBM (fft2_columns.cu),
// read by the column panel's first pass and written by its last: the
// frame's rows hold `stride` values (W, or the W/2+1 of a half spectrum),
// and element i of panel column `line` is x[i stride + c0 + line] (x and y
// point at the frame; they may be the same frame). Consecutive lines are
// consecutive columns, so a half-warp's accesses are runs of consecutive
// values of one row. Columns at or past `stride` (the last panel of a width
// that is not a multiple of the panel's) read the frame's last column, and
// their results are not written: the loads stay unpredicated, which kept
// the radix-2 instance from spilling (a select a load had cost registers
// under the 64 that 1024 threads allow). Reads take the imaginary parts
// times `sign` (-1 conjugates on the way in); writes times (scale,
// yscale), as HbmFrameOut. 32-bit offsets: a frame holds fewer than 2^31
// values.
struct HbmColumns {
  static constexpr bool kShared = false;
  const float2* x;
  float2* y;
  int stride;
  int c0;
  float sign;
  float scale;
  float yscale;

  template <int R>
  __device__ __forceinline__ void read(int line, int t, int s, float2* v, bool ok) const {
    if (!ok) line = t = 0;  // a group past the block's values (panels under 16 values)
    const int c = min(c0 + line, stride - 1);
    const float2* p = x + static_cast<unsigned>(t * stride + c);
    const unsigned step = static_cast<unsigned>(s * stride);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float2 a = p[j * step];
      v[j] = make_float2(a.x, a.y * sign);
    }
  }

  template <int R>
  __device__ __forceinline__ void write(int line, int pos, int l, const float2* v, bool ok) const {
    if (!ok || c0 + line >= stride) return;
    float2* p = y + static_cast<unsigned>(pos * stride + c0 + line);
    const unsigned step = static_cast<unsigned>(l * stride);
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const float2 a = v[out_reg<R>(c)];
      p[c * step] = make_float2(a.x * scale, a.y * yscale);
    }
  }
};

// pass at the radix 2^lr of a runtime value (a line of 1 to 16 values is
// one pass of its own length; the last pass of a longer one is 2 to 16),
// with RADIX's layers.
template <int RADIX = 4, class L, class Src, class Dst>
__device__ __forceinline__ void pass_r(int lr, int P, int log_n, int log_l, int log_half,
                                       const L& lanes, const float2* rom, const Src& src,
                                       const Dst& dst) {
  switch (lr) {
    case 0: pass<0, RADIX>(P, log_n, log_l, log_half, lanes, rom, src, dst); break;
    case 1: pass<1, RADIX>(P, log_n, log_l, log_half, lanes, rom, src, dst); break;
    case 2: pass<2, RADIX>(P, log_n, log_l, log_half, lanes, rom, src, dst); break;
    case 3: pass<3, RADIX>(P, log_n, log_l, log_half, lanes, rom, src, dst); break;
    default: pass<4, RADIX>(P, log_n, log_l, log_half, lanes, rom, src, dst); break;
  }
}

// The panel over the frame's lines of 2^log_n values (rows of w = 2^log_w
// values, or its columns): src -> first pass -> padded frame -> middle passes
// in place, the first rewriting it plain -> last pass -> dst. One pass where a
// line holds at most 16 values. The caller synchronises before a shared src
// is read and after a shared dst is written; the ROM is read only after the
// first barrier. RADIX: the passes' layers (pass); at 2 each pass runs
// r2_layers over its runtime span, and a first pass of more than one layer
// reads the ROM after the barrier that follows its loads.
template <bool COLS, int RADIX = 4, class Src, class Dst>
__device__ __forceinline__ void frame_panel(float2* buf, int P, int log_w, int log_n, int log_half,
                                            const float2* rom, const Src& src, const Dst& dst) {
  const Lanes<COLS> lanes{log_w};
  const int np = pass_count(log_n);
  if (np == 1) {
    pass_r<RADIX>(log_n, P, log_n, 0, log_half, lanes, rom, src, dst);
    return;
  }
  pass<4, RADIX>(P, log_n, 0, log_half, lanes, rom, src, SmemFrame<COLS>{buf, log_w, true});
  __syncthreads();
  for (int p = 1; p < np - 1; ++p) {
    pass<4, RADIX>(P, log_n, 4 * p, log_half, lanes, rom, SmemFrame<COLS>{buf, log_w, p == 1},
                   SmemFrame<COLS>{buf, log_w, false});
    __syncthreads();
  }
  pass_r<RADIX>(last_log_radix(log_n), P, log_n, 4 * (np - 1), log_half, lanes, rom,
                SmemFrame<COLS>{buf, log_w, np == 2}, dst);
}

// Two-for-one recombination Y = Xe + w Xo from z = Z[k] and zm = conj Z[m-k]
// (fft_common.cuh's rfft_recombine on values already read).
__device__ __forceinline__ float2 recombine(float2 z, float2 zm, float2 w) {
  const float2 xe = make_float2(0.5f * (z.x + zm.x), 0.5f * (z.y + zm.y));
  const float2 d = csub(z, zm);
  const float2 xo = make_float2(0.5f * d.y, -0.5f * d.x);
  return make_float2(xe.x + w.x * xo.x - w.y * xo.y, xe.y + w.x * xo.y + w.y * xo.x);
}

// W_{2m}^k = exp(-pi i k / m) by sincospif: the ROM's entry bit for bit (the
// same float argument), for a first pass, which runs before the first
// barrier and so before the ROM is built, and for the radix-2 rfft_fused's
// recombination.
__device__ __forceinline__ float2 w_2m(int k, int m) {
  float s, c;
  sincospif(-static_cast<float>(k) / static_cast<float>(m), &s, &c);
  return make_float2(c, s);
}

// W_{2m}^k for element k = t + j m/R of a first pass's group t: wt =
// W_{2m}^t times W_{2R}^j = W_32^{16 j / R}, a constant once the caller's
// loop over j (< R <= 16) is unrolled.
template <int R>
__device__ __forceinline__ float2 untangle_twiddle(float2 wt, int j) {
  const int p = (16 / R) * j;
  return j == 0 ? wt : cmul(wt, make_float2(cos32(p), -cos32(p - 8)));
}

// The inverse real transform's input to the forward panel at bin k (the
// inverse by conjugation): conj z[k], z[k] = Xe + i Xo untangled from
// yk = Y[k] and ym = Y[m-k] (fft_common.cuh's irfft_untangle), w = W_{2m}^k.
__device__ __forceinline__ float2 untangle(float2 yk, float2 ym, float2 w) {
  return cconj(irfft_untangle(yk, cconj(ym), cconj(w)));
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
