// The fused decode GEMV of row 1 (folded W4, w4_matmul.cu, M <= 16) and row
// 22 (W8, w8_matmul.cu, M <= 8): one body, instantiated with a weight policy.
//
//   y = rope([rms_norm(x)] @ W)  [+ residual]
//   W4 folded: sum_g s_g * (x_g . q_g) - zs_g * sum(x_g), q exact in bf16
//   W8:        sum_k x_k bf16(q8_k * s_k) - sum_g zs_g * sum(x_g)
//
// Bound on the H100: bytes (W4 0.5 B a weight, W8 1 B, plus 8 B of f32 scale
// and zs per column per group); at M <= 16 the products are ~2 M flops a
// weight byte, far below the card's ~295.
//
// Design (rows 24 / 25's GEMV, w4_elem.cuh, with what a probe of that GEMV
// on the card showed: a copy-only build of it on the same grid took half
// its time, x read from registers 10% less, a contiguous weight stream and
// a ring of 8 stages against 4 nothing):
//  * The tensor cores through mma.sync m16n8k16, computed transposed, y^T =
//    w^T x^T: the weight (dequantized in registers by the policy) is the A
//    operand, 16 weight columns x 16 K rows; x's rows are the B operand, one
//    n8 product for rows 0-7 and a second on the same A fragment for rows
//    8-15, so the row count costs little.
//  * A block is 4 warps over 128 columns, each warp its own 32 columns and
//    its own ring of STAGES stages (a 64-row unit of its columns' weight
//    rows plus the unit's scale and zs rows), filled by its lanes' cp.async
//    pieces: a warp waits only for its own copies (__syncwarp), never for
//    the block, so the four warps' latencies overlap.
//  * x is staged once a block in shared memory: the rows of the block's K
//    range arrive by cp.async, issued before the weight ring's first stages
//    (the probe's prologue, each thread's x loads one after another, cost
//    up to a third of the call), then each warp normalizes and rounds its
//    units and rearranges them in place into the order the B fragments take
//    (one 8-byte load a slab and row half), with each unit's per-row sum(x);
//    the K range goes in passes of XU units where it is longer.
//  * K split over the blocks of a cluster (gridDim.y = split <= 8, the
//    wrapper's plan, ops/w4_tile.py), on 64-row units: a split that cuts a
//    quantization group is exact in the folded algebra (each rank folds its
//    part of the group, s * acc_part - zs * sum(x_part); the parts add to
//    the group's fold). The RMSNorm's sum of squares is exchanged through
//    distributed shared memory: every rank sums the ranks' partials in rank
//    order, so 1 / rms is identical in every rank. The ranks' f32 partial
//    tiles are summed the same way, each rank a share of the columns, the
//    RoPE partner of a column (n ^ 1 interleaved, n +- hd / 2 half) summed
//    by the same rank in the same order: bit-equal across launches, one
//    launch, no workspace, no atomics.
//  * Epilogue: RoPE in f32 on the summed column and its partner, the cast to
//    bf16, then the residual added in bf16 (the TPU kernels' op order).
//  * The pieces (a warp's ring, Ring; x staging, load_x and rearrange; a
//    unit's products, unit_products; the group fold, fold; the walk over a
//    K range, walk_units) take their column tile and K range as arguments,
//    so the fused W4 decode FFN (ffn_fused.cu), a persistent kernel, walks
//    many (tile, K range) items with them; walk_units_rows is its walk at M
//    > 16 (rows in passes of 16 over each staged unit). This kernel shares
//    Ring, load_x and stage_of, and keeps its pass (the rearrangement and
//    the unit loop, the same arithmetic as rearrange and walk_units) inline:
//    behind those calls it compiled 2-4% slower at row 22's 7B wo and w2
//    (PERF.md, the fused FFN's finding).
// What bounds it now (throwaway builds, not kept): the copy loop alone runs
// within about 1.2x of a plain read of the same bytes; the rest is the x
// prologue with a norm (every column block normalizes and rearranges the
// same x for its K range) and the dequant and products, which the stream
// hides only in part. PERF.md rows 1 and 22 hold the times, measured by
// chip_smoke.py.

#pragma once

#include <cooperative_groups.h>

#include "w4_tile.cuh"

namespace qgemv {

constexpr int BN = 128;          // columns a block
constexpr int THREADS = 128;     // 4 warps, 32 columns each
constexpr int UNIT = 64;         // K rows a stage
constexpr int MAX_SPLIT = 8;     // blocks of a cluster (the portable most)
constexpr int XU = 32;           // units of x staged a pass at M <= 8 (half at M <= 16)

struct Args {
  const bf16* x;
  long long x_stride;            // elements between x rows
  int M, Kx;                     // rows (<= 16); K rows of x, a multiple of 64
  const void* w;                 // W4: packed (K/8, N) words; W8: (K, N) int8 rows of q - 128
  const float* scales;           // (>= Kx/gs, N)
  const float* zs;               // (>= Kx/gs, N): folded zs = z * s, or W8 (z - 128) * s
  int N, gs;
  const float* norm;             // (Kx,) or null
  float eps;
  const bf16* residual;          // (M, N) or null
  const float* cos_row;          // (N,) or null
  const float* sin_row;
  int rope_style, rope_hd;       // 0 none, 1 interleaved, 2 half
  bf16* out;                     // (M, N)
  int units;                     // Kx / 64
  const int* gate;               // null, or an int on the card: 0 -> zeros out, no weight read
};

// Row 1: the folded W4 weight. A unit is 8 word rows (a word row: 8 K rows
// of a column); slab j of a unit is word rows 2j (B fragment k 0..7) and
// 2j + 1 (k 8..15), and thread t's pair in each is nibbles (t, t + 4): the x
// pair it meets is (x[16j + t], x[16j + t + 4]), (x[16j + 8 + t], x[16j +
// 12 + t]). The product of a group is accumulated on its own, then folded.
struct W4Folded {
  static constexpr bool SCALED = false;    // the scale is applied at the fold
  static constexpr int STAGES = 4;         // a warp's ring
  static constexpr int ROWS = 8;           // weight rows of a unit
  static constexpr int ROW_BYTES = 128;    // a warp's 32 columns of a row
  static constexpr int ROW_LD = 128;       // its stride in the ring
  // x position of K value k8 (0..7) of an 8-row chunk: lane t = k8 % 4, half e = k8 / 4
  __device__ static __forceinline__ int x_lane(int k8) { return k8 & 3; }
  __device__ static __forceinline__ int x_half(int k8) { return k8 >> 2; }
  // weight row r of unit 0 at column col; a unit further on is unit_bytes on
  __device__ static __forceinline__ const char* row_src(const void* w, int N, int r, int col) {
    return reinterpret_cast<const char*>(w) + ((size_t)r * N + col) * 4;
  }
  __device__ static __forceinline__ size_t unit_bytes(int N) { return (size_t)N * 32; }
  __device__ static __forceinline__ int row_slot(int r) { return r; }
  // weight fragments of slab j: b[nt][0] k rows (t, t + 4) of word row 2j,
  // b[nt][1] of word row 2j + 1, for the thread's columns nb + nt
  __device__ static __forceinline__ void convert(const unsigned char* ws, int c4, int j, int t,
                                                 const float (&)[4], uint32_t b[4][2]) {
    const uint4 w0 = *reinterpret_cast<const uint4*>(ws + (2 * j) * ROW_LD + 4 * c4);
    const uint4 w1 = *reinterpret_cast<const uint4*>(ws + (2 * j + 1) * ROW_LD + 4 * c4);
    const uint32_t a0[4] = {w0.x, w0.y, w0.z, w0.w}, a1[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      b[nt][0] = w4tile::q_pair(a0[nt], t);
      b[nt][1] = w4tile::q_pair(a1[nt], t);
    }
  }
};

// q8 byte e of w (already XORed with 0x80) times s: q8 exact from the float
// pattern 0x4B000000 | (q8 + 128) less 2^23 + 128, one f32 product
__device__ __forceinline__ float w8_value(uint32_t w, int e, float s) {
  return __fmul_rn(__fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | e)),
                             8388736.f),
                   s);
}

// Row 22: the W8 weight, each value bf16(q8 * s) in registers. A unit is 64
// int8 rows; slab j's B fragment k 2t, 2t + 1 and 2t + 8, 2t + 9 are K rows
// 16j + 2t .. in order: the x pair is (x[16j + 2t], x[16j + 2t + 1]). A row
// of the warp's 32 columns is 32 bytes, row r at slot r ^ ((r >> 2) & 1) of
// the ring, so that the four rows a load instruction reads (16j + 2t, t =
// 0..3) fall in distinct banks.
struct W8 {
  static constexpr bool SCALED = true;
  static constexpr int STAGES = 3;   // (a 4th kept a 32-unit pass from 3 blocks an SM)
  static constexpr int ROWS = 64;
  static constexpr int ROW_BYTES = 32;
  static constexpr int ROW_LD = 32;
  __device__ static __forceinline__ int row_slot(int r) { return r ^ ((r >> 2) & 1); }
  __device__ static __forceinline__ int x_lane(int k8) { return k8 >> 1; }
  __device__ static __forceinline__ int x_half(int k8) { return k8 & 1; }
  __device__ static __forceinline__ const char* row_src(const void* w, int N, int r, int col) {
    return reinterpret_cast<const char*>(w) + (size_t)r * N + col;
  }
  __device__ static __forceinline__ size_t unit_bytes(int N) { return (size_t)N * UNIT; }
  __device__ static __forceinline__ void convert(const unsigned char* ws, int c4, int j, int t,
                                                 const float (&s)[4], uint32_t b[4][2]) {
    // rows 16j + 2t, + 1, + 8, + 9 all sit at their row ^ (t >> 1)
    const int x = t >> 1;
    const unsigned char* p = ws + (16 * j + 2 * t) * ROW_LD + c4;
    const uint32_t r0 = *reinterpret_cast<const uint32_t*>(p + x * ROW_LD) ^ 0x80808080u;
    const uint32_t r1 = *reinterpret_cast<const uint32_t*>(p + (1 - x) * ROW_LD) ^ 0x80808080u;
    const uint32_t r2 = *reinterpret_cast<const uint32_t*>(p + (8 + x) * ROW_LD) ^ 0x80808080u;
    const uint32_t r3 = *reinterpret_cast<const uint32_t*>(p + (9 - x) * ROW_LD) ^ 0x80808080u;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      b[nt][0] = pack_bf16x2(w8_value(r0, nt, s[nt]), w8_value(r1, nt, s[nt]));
      b[nt][1] = pack_bf16x2(w8_value(r2, nt, s[nt]), w8_value(r3, nt, s[nt]));
    }
  }
};

template <class P>
struct Shape {
  static constexpr int W_BYTES = P::ROWS * P::ROW_LD;
  static constexpr int WARP_STAGE = W_BYTES + 2 * 128;   // + the unit's scale and zs rows
  static constexpr int RING = P::STAGES * 4 * WARP_STAGE;
  static_assert(RING >= 16 * BN * 4, "the ring holds the partial tile");
};

// shared memory past the ring, for R x rows a unit and xu units a pass: x (a
// unit's raw rows, then in place its B fragments), the norm weights of the
// pass's 64 xu K rows, and each (unit, row)'s sum
__host__ __device__ constexpr int x_bytes(int rows, int xu) { return xu * rows * 128; }
__host__ __device__ constexpr int smem_bytes(int ring, int rows, int xu) {
  return ring + x_bytes(rows, xu) + xu * UNIT * 4 + xu * rows * 4;
}
__host__ __device__ constexpr int pass_units(int h, int per_rank) {
  return per_rank < XU / h ? per_rank : XU / h;
}

// The body's pieces, which take their column tile and K range as arguments
// (the fused W4 decode FFN, ffn_fused.cu, a persistent kernel that walks many
// (tile, K range) items; row 1's and row 22's kernel below shares Ring,
// load_x and stage_of).

// A weight operand: W4 packed (K/8, N) words or W8 (K, N) bytes, with its
// (>= K/gs, N) scale and zs rows.
struct Weights {
  const void* w;
  const float* scales;
  const float* zs;
  int N, gs;
};

// One warp's share of a block's weight ring: the cp.async pieces of a stage
// (a 64-row unit of the warp's 32 columns from wn0, then the unit's scale
// and zs rows, columns past N as zeros). Lane l copies pieces l, l + 32, ..:
// their sources in unit 0, their offsets in the stage and whether their
// columns lie inside N are computed once (a unit moves the weight rows by
// unit_bytes, the coefficient rows by a group every gs / 64 units).
template <class P, int VEC>
struct Ring {
  static constexpr int WP = P::ROW_BYTES / VEC, CP = 128 / VEC;   // pieces a weight / coef row
  static constexpr int NW = P::ROWS * WP, NPIECE = NW + 2 * CP, NQ = (NPIECE + 31) / 32;
  const char* psrc[NQ];
  int poff[NQ];
  bool pon[NQ];
  size_t wstride, cstride;
  int gs;

  __device__ __forceinline__ Ring(const Weights& wt, int wn0, int lane)
      : wstride(P::unit_bytes(wt.N)), cstride((size_t)wt.N * 4), gs(wt.gs) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = lane + 32 * q;
      int col;
      if (c < NW) {
        const int r = c / WP, p = c % WP;
        col = wn0 + p * VEC * 32 / P::ROW_BYTES;
        psrc[q] = P::row_src(wt.w, wt.N, r, col);
        poff[q] = P::row_slot(r) * P::ROW_LD + p * VEC;
      } else {
        const int r = (c - NW) / CP, p = (c - NW) % CP;
        col = wn0 + p * VEC / 4;
        psrc[q] = reinterpret_cast<const char*>((r == 0 ? wt.scales : wt.zs) + col);
        poff[q] = Shape<P>::W_BYTES + r * 128 + p * VEC;
      }
      pon[q] = c < NPIECE && col < wt.N;
    }
  }

  // unit u's pieces into the warp's stage st (the commit is the caller's)
  __device__ __forceinline__ void load(unsigned char* st, int u, int lane) const {
    const size_t wofs = (size_t)u * wstride, cofs = (size_t)(u * UNIT / gs) * cstride;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if (q * 32 + 32 <= NPIECE || lane + 32 * q < NPIECE) {
        const char* src = psrc[q] + (lane + 32 * q < NW ? wofs : cofs);
        cp_async<VEC>(st + poff[q], pon[q] ? src : psrc[0], pon[q] ? VEC : 0);
      }
    }
  }
};

// warp's stage of the it-th unit of its block's range
template <class P>
__device__ __forceinline__ unsigned char* stage_of(unsigned char* ring, int it, int warp) {
  return ring + ((it % P::STAGES) * 4 + warp) * Shape<P>::WARP_STAGE;
}

// nu units of x from unit u (R rows a unit, rows past M as zeros; unit ul at
// xraw + ul * R * 128) and, with a norm, their norm weights into nrm, by
// cp.async.cg (through L2 only: x may have been written by other SMs in the
// same launch) by the block's NT threads; one commit group
template <int R, int NT = THREADS>
__device__ __forceinline__ void load_x(unsigned char* xraw, float* nrm, const bf16* x,
                                       long long x_stride, int M, int u, int nu,
                                       const float* norm, int tid) {
  for (int i = tid; i < nu * R * 8; i += NT) {
    const int c = i & 7, r = (i >> 3) % R, ul = (i >> 3) / R;
    const bool on = r < M;
    const bf16* src = x + (size_t)r * x_stride + (size_t)(u + ul) * UNIT + 8 * c;
    cp_async<16>(xraw + ul * (R * 128) + r * 128 + c * 16, on ? src : x, on ? 16 : 0);
  }
  if (norm != nullptr) {
    const float* src = norm + (size_t)u * UNIT;
    if ((reinterpret_cast<uintptr_t>(norm) & 15) == 0)   // 16-byte pieces
      for (int i = 4 * tid; i < nu * UNIT; i += 4 * NT) cp_async<16>(nrm + i, src + i, 16);
    else
      for (int i = tid; i < nu * UNIT; i += NT) cp_async<4>(nrm + i, src + i, 4);
  }
  cp_async_commit();
}

// Each of the NW warps normalizes and rounds its units of the pass (warp w:
// units w, w + NW, ..; the RMSNorm where rinv is given) and rearranges them in place
// into the order the B fragments take, with each (unit, row)'s sum (MP > 1:
// each (unit, 32-row half, row)'s, [unit][half][row]). A unit's
// R = 8 H MP rows go in MP row passes of 8 H (the rows one product pass
// meets): pass p's raw rows are the unit's bytes [p, p + 1) * 8H * 128, and
// so are its fragments, [slab][row half][lane].
template <class P, int H, int MP, int NW = 4>
__device__ __forceinline__ void rearrange(unsigned char* xraw, int nu, const float* nrm,
                                          const float* rinv, int M, float* usum, int warp,
                                          int lane) {
  constexpr int RP = 8 * H, R = RP * MP;
  constexpr int PER = RP * 8 / 32;   // (row, chunk) tasks a lane: a chunk is 8 K rows
  for (int ul = warp; ul < nu; ul += NW) {
#pragma unroll 1
    for (int pp = 0; pp < MP; ++pp) {
      unsigned char* blk = xraw + (ul * R + pp * RP) * 128;
      uint4 raw[PER];
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int task = lane + 32 * q;
        raw[q] = *reinterpret_cast<const uint4*>(blk + (task >> 3) * 128 + (task & 7) * 16);
      }
      __syncwarp();   // every lane has read the pass's raw rows
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int task = lane + 32 * q, rl = task >> 3, c = task & 7, r = pp * RP + rl;
        // the chunk's 8 values as bf16 bits, two a word (value 2i low, 2i + 1
        // high); with a norm each pair normalized and rounded by one
        // cvt.rn.bf16x2
        uint32_t w[4] = {raw[q].x, raw[q].y, raw[q].z, raw[q].w};
        if (rinv != nullptr && r < M) {
          const float4 n0 = *reinterpret_cast<const float4*>(nrm + ul * UNIT + 8 * c);
          const float4 n1 = *reinterpret_cast<const float4*>(nrm + ul * UNIT + 8 * c + 4);
          const float nw[8] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
          const float ri = rinv[r];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            w[i] = pack_bf16x2((__uint_as_float(w[i] << 16) * ri) * nw[2 * i],
                               (__uint_as_float(w[i] & 0xffff0000u) * ri) * nw[2 * i + 1]);
        }
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sum += __uint_as_float(w[i] << 16);
          sum += __uint_as_float(w[i] & 0xffff0000u);
        }
        // the B fragments' pairs (values e, e1 of lane x_lane(e)) by byte permutes
        uint32_t pairs[4];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (P::x_half(e) == 0) {
            int e1 = 0;   // the value sharing lane x_lane(e)'s register, upper half
#pragma unroll
            for (int q2 = 0; q2 < 8; ++q2)
              if (P::x_lane(q2) == P::x_lane(e) && P::x_half(q2) == 1) e1 = q2;
            pairs[P::x_lane(e)] = __byte_perm(w[e >> 1], w[e1 >> 1],
                                              (e & 1 ? 0x32 : 0x10) | (e1 & 1 ? 0x7600 : 0x5400));
          }
        // the (unit, row)'s sum over its 8 chunks (lanes 8m .. 8m + 7), in a fixed order
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if constexpr (MP == 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, 4);
          if (c == 0) usum[ul * R + r] = sum;
        } else if ((c & 3) == 0) {   // each 32-row half's (walk_units_rows folds per half)
          usum[(ul * 2 + (c >> 2)) * R + r] = sum;
        }
        // slab c / 2, register c % 2 of lane (row % 8, x_lane) in row half rl / 8
        uint32_t* dst = reinterpret_cast<uint32_t*>(blk + ((c >> 1) * H + (rl >> 3)) * 256);
#pragma unroll
        for (int l = 0; l < 4; ++l) dst[((rl & 7) * 4 + l) * 2 + (c & 1)] = pairs[l];
      }
    }
  }
}

// The products of one staged unit (warp stage ws; x fragments of pass unit
// ul, 8 H rows): slab j's weight fragments (the policy's dequant) are the A
// operand, 16 columns x 16 K rows, the x rows' fragments the B operand, one
// n8 product a row half, into the group's chain j % 2. The thread's columns
// are c4 .. c4 + 3 of the warp's 32.
template <class P, int H>
__device__ __forceinline__ void unit_products(const unsigned char* ws, const uint2* xs, int ul,
                                              int c4, int t, int lane,
                                              float (&gacc)[2][H][2][4]) {
  const float* coef = reinterpret_cast<const float*>(ws + Shape<P>::W_BYTES);
  float sc[4] = {0.f, 0.f, 0.f, 0.f};
  if (P::SCALED) {
    const float4 s4 = *reinterpret_cast<const float4*>(coef + c4);
    sc[0] = s4.x, sc[1] = s4.y, sc[2] = s4.z, sc[3] = s4.w;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint2 xf[H];
#pragma unroll
    for (int h = 0; h < H; ++h) xf[h] = xs[((ul * 4 + j) * H + h) * 32 + lane];
    uint32_t b[4][2];
    P::convert(ws, c4, j, t, sc, b);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t af[4] = {b[2 * i][0], b[2 * i + 1][0], b[2 * i][1], b[2 * i + 1][1]};
#pragma unroll
      for (int h = 0; h < H; ++h) mma_bf16_16816(gacc[i][h][j & 1], af, xf[h].x, xf[h].y);
    }
  }
}

// A group's part ends: acc += s * (the group's products) - zs * sum(x of the
// part) (W8: the products carry their scale), chains and sums cleared
template <class P, int H>
__device__ __forceinline__ void fold(const unsigned char* ws, int c4, float (&gacc)[2][H][2][4],
                                     float (&xg)[H][2], float (&acc)[2][H][4]) {
  const float* coef = reinterpret_cast<const float*>(ws + Shape<P>::W_BYTES);
  const float4 s4 = *reinterpret_cast<const float4*>(coef + c4);
  const float4 z4 = *reinterpret_cast<const float4*>(coef + 32 + c4);
  const float s_[4] = {s4.x, s4.y, s4.z, s4.w}, z_[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = gacc[i][h][0][e] + gacc[i][h][1][e];
        const int col = 2 * i + (e >> 1);
        acc[i][h][e] += (P::SCALED ? p : s_[col] * p) - z_[col] * xg[h][e & 1];
        gacc[i][h][0][e] = gacc[i][h][1][e] = 0.f;
      }
#pragma unroll
  for (int h = 0; h < H; ++h) xg[h][0] = xg[h][1] = 0.f;
}

// The warp's walk over the units [c0, c0 + nu) of its block's range [u0, u0
// + nunits) whose x pass is staged and rearranged: wait for the unit's
// stage, issue the stage STAGES - 1 on (one commit group a stage, empty past
// the range), multiply, and fold where the group's part ends (at a group
// boundary or the range's end).
template <class P, int H, int VEC>
__device__ __forceinline__ void walk_units(const Ring<P, VEC>& ring, unsigned char* ringmem,
                                           const uint2* xs, const float* usum, int u0,
                                           int nunits, int c0, int nu, int gs, int warp,
                                           int lane, float (&acc)[2][H][4],
                                           float (&gacc)[2][H][2][4], float (&xg)[H][2]) {
  constexpr int R = 8 * H;
  const int t = lane & 3, c4 = 4 * (lane >> 2);
  for (int it = c0; it < c0 + nu; ++it) {
    cp_async_wait<P::STAGES - 2>();   // this lane's pieces of unit it landed
    __syncwarp();                  // the warp's; every lane is done with unit it - 1
    if (it + P::STAGES - 1 < nunits)
      ring.load(stage_of<P>(ringmem, it + P::STAGES - 1, warp), u0 + it + P::STAGES - 1, lane);
    cp_async_commit();
    const unsigned char* ws = stage_of<P>(ringmem, it, warp);
    const int ul = it - c0;
    unit_products<P, H>(ws, xs, ul, c4, t, lane, gacc);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float2 u2 = *reinterpret_cast<const float2*>(usum + ul * R + 8 * h + 2 * t);
      xg[h][0] += u2.x;
      xg[h][1] += u2.y;
    }
    const int u = u0 + it;
    if (((u + 1) * UNIT) % gs == 0 || it == nunits - 1)   // the group's part ends
      fold<P, H>(ws, c4, gacc, xg, acc);
  }
}

// Rows in MP passes of 16 over each staged unit (M > 16; the folded W4
// policy): a 32-row half of the unit at a time, its two slabs dequantized
// once into registers, then each pass's products on them, folded at the
// half's end (s * acc_half - zs * sum(x_half): exact in the folded algebra,
// as a K split is) into acc[pass]. WG warp groups share each stage: warp w <
// 4 copies it, and with WG = 2 warp w + 4 takes the second half of the passes
// (a named barrier a unit and warp pair), so no thread holds more than
// MP / WG passes' sums (at MP = 8 one warp's 128 rows spilled).
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

template <class P, int MP, int WG, int VEC>
__device__ __forceinline__ void walk_units_rows(const Ring<P, VEC>& ring, unsigned char* ringmem,
                                                const uint2* xs, const float* usum, int u0,
                                                int nunits, int c0, int nu, int warp, int lane,
                                                float (&acc)[MP / WG][2][2][4]) {
  static_assert(!P::SCALED, "the half fold applies the scale");
  static_assert(WG == 1 || WG == 2, "one or two warp groups");
  constexpr int R = 16 * MP, PW = MP / WG;
  const int t = lane & 3, c4 = 4 * (lane >> 2), sw = warp & 3, p0 = (warp >> 2) * PW;
  const float sc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int it = c0; it < c0 + nu; ++it) {
    if (warp < 4) {
      cp_async_wait<P::STAGES - 2>();
      __syncwarp();
    }
    if constexpr (WG == 2) pair_sync(1 + sw);   // unit it landed; both are done with it - 1
    if (warp < 4) {
      if (it + P::STAGES - 1 < nunits)
        ring.load(stage_of<P>(ringmem, it + P::STAGES - 1, sw), u0 + it + P::STAGES - 1, lane);
      cp_async_commit();
    }
    const unsigned char* ws = stage_of<P>(ringmem, it, sw);
    const int ul = it - c0;
    const float* coef = reinterpret_cast<const float*>(ws + Shape<P>::W_BYTES);
    const float4 s4 = *reinterpret_cast<const float4*>(coef + c4);
    const float4 z4 = *reinterpret_cast<const float4*>(coef + 32 + c4);
    const float s_[4] = {s4.x, s4.y, s4.z, s4.w}, z_[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      uint32_t b[2][4][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) P::convert(ws, c4, 2 * hf + jj, t, sc, b[jj]);
#pragma unroll
      for (int pp = 0; pp < PW; ++pp) {
        float g[2][2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) g[i][h][e] = 0.f;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * hf + jj;
          uint2 xf[2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            xf[h] = xs[(((ul * MP + p0 + pp) * 4 + j) * 2 + h) * 32 + lane];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const uint32_t af[4] = {b[jj][2 * i][0], b[jj][2 * i + 1][0], b[jj][2 * i][1],
                                    b[jj][2 * i + 1][1]};
#pragma unroll
            for (int h = 0; h < 2; ++h) mma_bf16_16816(g[i][h], af, xf[h].x, xf[h].y);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 u2 = *reinterpret_cast<const float2*>(
              usum + (ul * 2 + hf) * R + (p0 + pp) * 16 + 8 * h + 2 * t);
          const float xsum[2] = {u2.x, u2.y};
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 2 * i + (e >> 1);
              acc[pp][i][h][e] += s_[col] * g[i][h][e] - z_[col] * xsum[e & 1];
            }
        }
      }
    }
  }
}

// One block: 128 columns over the units of its rank's K range. H: row
// halves (1: M <= 8, 2: M <= 16); VEC: bytes a cp.async piece (16, or 4 / 8
// where the operands are not 16-byte aligned).
template <class P, int H, int VEC>
__global__ void __launch_bounds__(THREADS) kernel(const Args a) {
  using S = Shape<P>;
  constexpr int R = 8 * H;   // rows staged
  namespace cg = cooperative_groups;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[THREADS];
  __shared__ float rss[16], rinv[16];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, wn0 = n0 + 32 * warp;   // the warp's first column
  const int rank = blockIdx.y, split = gridDim.y;   // the cluster spans the split
  const int u0 = (int)((long long)rank * a.units / split);
  const int nunits = (int)((long long)(rank + 1) * a.units / split) - u0;
  const int xu = pass_units(H, (a.units + split - 1) / split);
  // a gated-off launch (a MoE expert no row chose, decided on the card): the
  // output is zeros, whatever the residual, and no weight byte is read; every
  // rank reads the same flag before its first cluster barrier
  if (a.gate != nullptr && __ldg(a.gate) == 0) {
    for (int q = rank * THREADS + tid; q < a.M * (BN / 4); q += split * THREADS) {
      const int m = q / (BN / 4), n = n0 + 4 * (q % (BN / 4));
      if (n < a.N) *reinterpret_cast<uint2*>(a.out + (size_t)m * a.N + n) = make_uint2(0u, 0u);
    }
    return;
  }
  unsigned char* ring = smem;
  // x's B fragments [unit][slab][half][lane], the norm weights [unit][64],
  // the sums [unit][row]
  unsigned char* xraw = smem + S::RING;
  const uint2* xs = reinterpret_cast<const uint2*>(xraw);
  float* nrm = reinterpret_cast<float*>(smem + S::RING + x_bytes(R, xu));
  float* usum = nrm + xu * UNIT;
  cg::cluster_group cluster = cg::this_cluster();
  const Ring<P, VEC> wring(Weights{a.w, a.scales, a.zs, a.N, a.gs}, wn0, lane);

  // x goes in passes of up to xu units; the first pass's copies go out before
  // the weight ring's, so they do not queue behind them
  const int nu0 = min(xu, nunits);
  load_x<R>(xraw, nrm, a.x, a.x_stride, a.M, u0, nu0, a.norm, tid);
#pragma unroll
  for (int s = 0; s < P::STAGES - 1; ++s) {
    if (s < nunits) wring.load(stage_of<P>(ring, s, warp), u0 + s, lane);
    cp_async_commit();
  }
  cp_async_wait<P::STAGES - 1>();   // the first pass's x; the ring's stages may be in flight
  __syncthreads();

  // the RMSNorm: each row's sum of squares over the rank's K range (thread:
  // row tid % R, every QS-th 8-column chunk), from the staged rows and, past
  // the first pass, from global memory (four chunks' loads in flight at
  // once), summed in a fixed order, then over the cluster's ranks in rank
  // order
  constexpr int QS = THREADS / R, BATCH = 4;
  if (a.norm != nullptr) {
    const int r = tid % R;
    float ss = 0.f;
#pragma unroll 4
    for (int i = tid / R; i < nu0 * 8; i += QS) {   // each chunk's squares, then the chunks'
      const uint4 raw =
          *reinterpret_cast<const uint4*>(xraw + (i >> 3) * (H * 1024) + r * 128 + (i & 7) * 16);
      const uint32_t wv[4] = {raw.x, raw.y, raw.z, raw.w};
      float c8 = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float lo = __uint_as_float(wv[k] << 16), hi = __uint_as_float(wv[k] & 0xffff0000u);
        c8 = fmaf(lo, lo, c8);
        c8 = fmaf(hi, hi, c8);
      }
      ss += c8;
    }
    const int nch = nunits * 8;
    if (r < a.M) {
      const bf16* xr = a.x + (size_t)r * a.x_stride + (size_t)u0 * UNIT;
      for (int c0 = nu0 * 8 + tid / R; c0 < nch; c0 += BATCH * QS) {
        uint4 raw[BATCH];
#pragma unroll
        for (int b = 0; b < BATCH; ++b)
          raw[b] = c0 + b * QS < nch ? *reinterpret_cast<const uint4*>(xr + 8 * (c0 + b * QS))
                                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          const bf16* v = reinterpret_cast<const bf16*>(&raw[b]);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float f = bf2f(v[e]);
            ss += f * f;
          }
        }
      }
    }
    red[tid] = ss;
    __syncthreads();
    if (tid < R) {
      float s = 0.f;
      for (int q = 0; q < QS; ++q) s += red[tid + q * R];
      rss[tid] = s;
    }
    cluster.sync();   // every rank's partial sums are written
    if (tid < R) {
      float s = 0.f;
      for (int rk = 0; rk < split; ++rk) s += cluster.map_shared_rank(rss, rk)[tid];
      rinv[tid] = 1.f / sqrtf(s / (float)a.Kx + a.eps);
    }
  }

  const int c4 = 4 * (lane >> 2), t = lane & 3;   // the thread's first column: wn0 + c4
  float acc[2][H][4];
  float gacc[2][H][2][4];   // the group's products, two chains (slab parity)
  float xg[H][2];           // sum(x) of the group's part so far, x rows 8h + 2t, + 1
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][h][e] = 0.f;
        gacc[i][h][0][e] = gacc[i][h][1][e] = 0.f;
      }
#pragma unroll
  for (int h = 0; h < H; ++h) xg[h][0] = xg[h][1] = 0.f;

  for (int c0 = 0; c0 < nunits; c0 += xu) {
    const int nu = min(xu, nunits - c0);
    if (c0 > 0) {
      __syncthreads();   // every warp is done with the last pass's x
      load_x<R>(xraw, nrm, a.x, a.x_stride, a.M, u0 + c0, nu, a.norm, tid);
      cp_async_wait<0>();
    }
    __syncthreads();   // the pass's raw rows (and rinv) are in place
    // warp w rearranges units w, w + 4, ..: lane task (row, chunk) = 8 K rows
    for (int ul = warp; ul < nu; ul += 4) {
      unsigned char* blk = xraw + ul * (H * 1024);
      constexpr int PER = R * 8 / 32;   // tasks a lane
      uint4 raw[PER];
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int task = lane + 32 * q;
        raw[q] = *reinterpret_cast<const uint4*>(blk + (task >> 3) * 128 + (task & 7) * 16);
      }
      __syncwarp();   // every lane has read the unit's raw rows
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int task = lane + 32 * q, r = task >> 3, c = task & 7;
        // the chunk's 8 values as bf16 bits, two a word (value 2i low, 2i + 1
        // high); with a norm each pair normalized and rounded by one
        // cvt.rn.bf16x2
        uint32_t w[4] = {raw[q].x, raw[q].y, raw[q].z, raw[q].w};
        if (a.norm != nullptr && r < a.M) {
          const float4 n0 = *reinterpret_cast<const float4*>(nrm + ul * UNIT + 8 * c);
          const float4 n1 = *reinterpret_cast<const float4*>(nrm + ul * UNIT + 8 * c + 4);
          const float nw[8] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
          const float ri = rinv[r];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            w[i] = pack_bf16x2((__uint_as_float(w[i] << 16) * ri) * nw[2 * i],
                               (__uint_as_float(w[i] & 0xffff0000u) * ri) * nw[2 * i + 1]);
        }
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sum += __uint_as_float(w[i] << 16);
          sum += __uint_as_float(w[i] & 0xffff0000u);
        }
        // the B fragments' pairs (values e, e1 of lane x_lane(e)) by byte permutes
        uint32_t pairs[4];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (P::x_half(e) == 0) {
            int e1 = 0;   // the value sharing lane x_lane(e)'s register, upper half
#pragma unroll
            for (int q2 = 0; q2 < 8; ++q2)
              if (P::x_lane(q2) == P::x_lane(e) && P::x_half(q2) == 1) e1 = q2;
            pairs[P::x_lane(e)] = __byte_perm(w[e >> 1], w[e1 >> 1],
                                              (e & 1 ? 0x32 : 0x10) | (e1 & 1 ? 0x7600 : 0x5400));
          }
        // the (unit, row)'s sum over its 8 chunks (lanes 8m .. 8m + 7), in a fixed order
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        if (c == 0) usum[ul * R + r] = sum;
        // slab c / 2, register c % 2 of lane (row % 8, x_lane) in row half r / 8
        uint32_t* dst = reinterpret_cast<uint32_t*>(blk + ((c >> 1) * H + (r >> 3)) * 256);
#pragma unroll
        for (int l = 0; l < 4; ++l) dst[((r & 7) * 4 + l) * 2 + (c & 1)] = pairs[l];
      }
    }
    __syncthreads();
    for (int it = c0; it < c0 + nu; ++it) {
      cp_async_wait<P::STAGES - 2>();   // this lane's pieces of unit it landed
      __syncwarp();                  // the warp's; every lane is done with unit it - 1
      if (it + P::STAGES - 1 < nunits)
        wring.load(stage_of<P>(ring, it + P::STAGES - 1, warp), u0 + it + P::STAGES - 1, lane);
      cp_async_commit();
      const unsigned char* ws = ring + ((it % P::STAGES) * 4 + warp) * S::WARP_STAGE;
      const float* coef = reinterpret_cast<const float*>(ws + S::W_BYTES);
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
      if (P::SCALED) {
        const float4 s4 = *reinterpret_cast<const float4*>(coef + c4);
        sc[0] = s4.x, sc[1] = s4.y, sc[2] = s4.z, sc[3] = s4.w;
      }
      const int ul = it - c0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint2 xf[H];
#pragma unroll
        for (int h = 0; h < H; ++h) xf[h] = xs[((ul * 4 + j) * H + h) * 32 + lane];
        uint32_t b[4][2];
        P::convert(ws, c4, j, t, sc, b);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t af[4] = {b[2 * i][0], b[2 * i + 1][0], b[2 * i][1], b[2 * i + 1][1]};
#pragma unroll
          for (int h = 0; h < H; ++h) mma_bf16_16816(gacc[i][h][j & 1], af, xf[h].x, xf[h].y);
        }
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float2 u2 = *reinterpret_cast<const float2*>(usum + ul * R + 8 * h + 2 * t);
        xg[h][0] += u2.x;
        xg[h][1] += u2.y;
      }
      const int u = u0 + it;
      if (((u + 1) * UNIT) % a.gs == 0 || it == nunits - 1) {   // the group's part ends
        const float4 s4 = *reinterpret_cast<const float4*>(coef + c4);
        const float4 z4 = *reinterpret_cast<const float4*>(coef + 32 + c4);
        const float s_[4] = {s4.x, s4.y, s4.z, s4.w}, z_[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < H; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = gacc[i][h][0][e] + gacc[i][h][1][e];
              const int col = 2 * i + (e >> 1);
              acc[i][h][e] += (P::SCALED ? p : s_[col] * p) - z_[col] * xg[h][e & 1];
              gacc[i][h][0][e] = gacc[i][h][1][e] = 0.f;
            }
#pragma unroll
        for (int h = 0; h < H; ++h) xg[h][0] = xg[h][1] = 0.f;
      }
    }
  }

  // the block's partial tile [x row][column] in the (now idle) ring, then the
  // ranks sum the cluster's tiles
  cp_async_wait<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int col = 32 * warp + c4 + 2 * i, row = 8 * h + 2 * t;
      part[row * BN + col] = acc[i][h][0];
      part[(row + 1) * BN + col] = acc[i][h][1];
      part[row * BN + col + 1] = acc[i][h][2];
      part[(row + 1) * BN + col + 1] = acc[i][h][3];
    }
  cluster.sync();   // every block's partial tile is written
  // every rank sums its share of the tile, 4 columns a thread, over the
  // ranks' partials in rank order (the same order whichever rank sums);
  // with half-style RoPE also the partner columns, in the same order
  const int half = a.rope_hd / 2;
  for (int q = rank * THREADS + tid; q < a.M * (BN / 4); q += split * THREADS) {
    const int m = q / (BN / 4), c = 4 * (q % (BN / 4)), n = n0 + c;
    if (n >= a.N) continue;
    float v[4] = {0.f, 0.f, 0.f, 0.f}, pv[4] = {0.f, 0.f, 0.f, 0.f};
    for (int rk = 0; rk < split; ++rk) {
      const float* pr = cluster.map_shared_rank(part, rk) + m * BN;
      const float4 p4 = *reinterpret_cast<const float4*>(pr + c);
      v[0] += p4.x;
      v[1] += p4.y;
      v[2] += p4.z;
      v[3] += p4.w;
      if (a.rope_style == 2) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ce = c + e;
          pv[e] += pr[(ce % a.rope_hd) < half ? ce + half : ce - half];
        }
      }
    }
    if (a.rope_style == 1) {
      pv[0] = v[1];
      pv[1] = v[0];
      pv[2] = v[3];
      pv[3] = v[2];
    }
    bf16 o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float y = a.rope_style != 0 ? v[e] * a.cos_row[n + e] + pv[e] * a.sin_row[n + e]
                                        : v[e];
      o[e] = f2bf(y);
      if (a.residual != nullptr)
        o[e] = f2bf(bf2f(a.residual[(size_t)m * a.N + n + e]) + bf2f(o[e]));
    }
    uint2 ov;
    ov.x = pack_bf16_pair(o[0], o[1]);
    ov.y = pack_bf16_pair(o[2], o[3]);
    *reinterpret_cast<uint2*>(a.out + (size_t)m * a.N + n) = ov;
  }
  cluster.sync();   // the partial tiles outlive the other ranks' reads
}

template <class P, int H, int VEC>
cudaError_t launch_one(const Args& a, int split, cudaStream_t st) {
  using S = Shape<P>;
  const int per_rank = (a.units + split - 1) / split;
  const int smem = smem_bytes(S::RING, 8 * H, pass_units(H, per_rank));
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel<P, H, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(S::RING, 8 * H, XU / H));
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + BN - 1) / BN, split, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = split;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel<P, H, VEC>, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Requires 1 <= M <= 16 (P = W8: <= 8), Kx % 64 == 0, gs % 64 == 0, x rows
// 16-byte aligned (x_stride % 8 == 0), 1 <= split <= min(MAX_SPLIT, units),
// N % 4 == 0 (W8: N % 8 == 0), and with half-style RoPE whole heads in the
// 128-column tile (128 % rope_hd == 0, rope_hd even); vec: the copy pieces' bytes
// (16 where the weight, scale and zs rows are 16-byte aligned; else W4 4,
// W8 8).
template <class P>
cudaError_t launch(const Args& a, int split, int vec, cudaStream_t st) {
  if (a.M < 1 || a.M > (P::SCALED ? 8 : 16) || a.Kx <= 0 || a.Kx % UNIT != 0 ||
      a.gs % UNIT != 0 || a.N <= 0 || a.N % 4 != 0 || a.x_stride % 8 != 0 || split < 1 ||
      split > MAX_SPLIT || split > a.units)
    return cudaErrorInvalidValue;
  if ((a.rope_style != 0 && (a.cos_row == nullptr || a.sin_row == nullptr)) ||
      (a.rope_style == 2 && (a.rope_hd <= 0 || a.rope_hd % 2 != 0 || BN % a.rope_hd != 0)))
    return cudaErrorInvalidValue;
  if constexpr (P::SCALED) {
    if (vec == 16) return launch_one<P, 1, 16>(a, split, st);
    if (vec == 8) return launch_one<P, 1, 8>(a, split, st);
  } else {
    const bool two = a.M > 8;   // a second n8 product for rows 8-15
    if (vec == 16)
      return two ? launch_one<P, 2, 16>(a, split, st) : launch_one<P, 1, 16>(a, split, st);
    if (vec == 4)
      return two ? launch_one<P, 2, 4>(a, split, st) : launch_one<P, 1, 4>(a, split, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace qgemv
