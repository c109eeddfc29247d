// The many-row W4 mainloop shared by row 1's fused tile (w4_matmul.cu, the
// folded layout, M > 16) and the std / magic tile (w4_elem.cuh, M > 8): one
// pipeline, instantiated with a weight-operand policy.
//
//   y[m0:m0+BM, n0:n0+128] = sum over the block's K steps of x (bf16) @ w
//
// Policies (each a struct with: COEF_ROWS, FOLDED; unit_base, chunk_off
// and coef_stride for the copies (a stage's x chunk c lies at K row
// unit_base + chunk_off(c), its coefficient row r in group unit_base / gs +
// r * coef_stride); stage_ctx (registers a stage shares), slab_raw (one
// 16-deep slab's raw weight operand) and convert (the bf16 weight fragments)):
//  * folded (row 1): the weight is the exact q in bf16; each quantization
//    group's product is accumulated in f32 on its own, then s * acc - zs *
//    sum(x) is added to the output accumulator (the zero point folded out, as
//    planes_qmm_plain does). sum(x) per (row, group) comes from the row-prep
//    pass and arrives with its stage.
//  * elem (rows 24 / 25): the weight of the Layout policy (std or magic)
//    rounded to bf16; one f32 accumulator over all of K.
//
// Bound on the H100: from about 83 rows on a product does more than the
// card's ~295 bf16 operations per weight byte (nibbles plus f32 scales), so
// the prefill shapes are bound by operations. The tiles it replaces spent
// ~3.5 us per 64-deep K step, mostly waiting: plain loads, then a barrier,
// then the products; an int -> float convert per nibble; scales read from
// global memory inside the loop; 32-40 blocks on 132 SMs at 128 rows. What
// this design does about each, and what its measurements taught:
//  * The tensor cores through wgmma: the product is computed transposed,
//    y^T = w^T x^T, so the weight (dequantized in registers) is wgmma's
//    register operand A (64 weight columns of an m64nBMk16) and the x tile
//    its shared-memory operand B. An mma.sync m16n8k16 form of this tile
//    was bound by issuing its mma.sync instructions (a build with the copies
//    and the dequant taken out was barely faster), and the dequant and the
//    copies added to that instead of hiding behind it; one wgmma issues the
//    work of 32 of them and runs asynchronously: slab j's products run
//    while slab j + 1 is dequantized.
//  * A ring of STAGES = 4 stages filled by bulk copies (cp.async.bulk, one
//    thread, an mbarrier counting the bytes in): a stage is the x tile (one
//    contiguous copy: the row-prep pass stores x in the order the stages
//    read it, wgmma's 8-row x 16-byte core matrices), 8 rows of raw words
//    (64 K rows, a quarter of a bf16 tile) and the stage's scales / zeros
//    (and sum(x) for folded). Per-thread 16-byte copies (cp.async) cost
//    more issue slots in address arithmetic than the dequant did.
//  * The weight dequantized in registers just before its product, by the
//    bf16 bit pattern 0x4300 | q = 128 + q (one lop3 and one bf16x2
//    subtraction give exact q) or the policy's own value, never by an int ->
//    float convert; a thread's four weight columns are adjacent, so one
//    16-byte shared load brings the words of all four.
//  * A grid that fills the card: where the output tiles are too few for the
//    132 SMs, the wrapper's plan (ops/w4_tile.py) splits K over blocks
//    (gridDim.z). Each split writes its f32 partial tile to a workspace, and
//    reduce_kernel, in the same C call, sums the partials in split order
//    (deterministic: no atomics) and runs the epilogue once.
// What bounds it now: at TinyLlama's w13 with 512 rows it runs at about a
// quarter of the bf16 peak on an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md,
// rows 1, 24 and 25, measured by chip_smoke.py); a build with the copies and
// the dequant taken out was still well above the operations bound (64-wide
// wgmma tiles; 704 tiles fill 1.3 waves of the blocks the card holds).
//
// A block is one warpgroup (4 warps): BM x rows (wgmma's N: 64) x 128 weight
// columns (two m64 products a slab). Epilogue (both routes): RoPE in f32
// with its column partner (interleaved n ^ 1, half n +- hd / 2; a 128-column
// tile holds whole heads), the cast to bf16, then the residual added in bf16.

#pragma once

#include "hopper.cuh"

namespace w4tile {

using hopper::bulk_copy;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::reg_fence;
using hopper::smem_addr;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

constexpr int BN = 128;          // weight columns per block: two wgmma M = 64 a warpgroup
constexpr int THREADS = BN;      // one warpgroup per 128 weight columns
constexpr int BM = 64;           // x rows per block (wgmma N)
constexpr int BK = 64;           // K rows per stage (8 packed word rows)
constexpr int STAGES = 4;
constexpr int C_LD = BN + 4;     // f32 per row of the epilogue tile
constexpr int RED_ROWS = 8;      // rows per block of reduce_kernel
constexpr int RED_BN = 128;      // columns per block of reduce_kernel (whole heads)
// the x tile of a stage in K-major core matrices (8 rows x 16 bytes): core
// matrix (row group r / 8, chunk c) at byte ((r / 8) * 8 + c) * 128
constexpr int CORE_LBO = 128;    // bytes to the next core matrix along K
constexpr int CORE_SBO = 1024;   // bytes to the next 8-row group

struct TileArgs {
  const bf16* x;                 // x rows (read by the row-prep pass)
  long long x_stride;            // elements between x rows
  int M, Kx;                     // rows; x columns (K rows at or past Kx read 0)
  bf16* xt;                      // the prepared x: (Mpad / BM, steps, BM x 64 core-matrix tile)
  const float* norm;             // folded: RMSNorm weight (Kx,) or null
  float eps;
  const uint32_t* packed;        // (K/8, N) words
  const float* scales;           // (>= K/gs, N)
  const float* zs;               // folded zs, std zeros, magic zeros_plus
  float* xsum;                   // folded: (Kx/gs + 1, Mpad) sum(x) per group, 1 / rms
  int N, gs, tk, Mpad;
  int granules;                  // K granules: folded groups, elem 64-row units
  int granule_steps;             // K steps per granule
  int split;                     // K splits (gridDim.z)
  float* ws;                     // (split, M, N) f32 partials when split > 1
  bf16* out;                     // (M, N)
  const bf16* residual;          // (M, N) or null
  const float* cos_row;          // (N,) or null
  const float* sin_row;
  int rope_style, rope_hd;       // 0 none, 1 interleaved, 2 half
};

// a use of r the compiler cannot see through: r's registers stay unchanged
// until here
__device__ __forceinline__ void reg_keep(const uint32_t (&r)[2][4]) {
  asm volatile("" ::"r"(r[0][0]), "r"(r[0][1]), "r"(r[0][2]), "r"(r[0][3]), "r"(r[1][0]),
               "r"(r[1][1]), "r"(r[1][2]), "r"(r[1][3])
               : "memory");
}

// shared-memory matrix descriptor: K-major, no swizzle
__device__ __forceinline__ uint64_t desc_kmajor(const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((CORE_LBO >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((CORE_SBO >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 bits_bf162(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// (a & mask) | bits in one lop3 (the compiler would spend two on two
// immediates)
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t mask, uint32_t bits) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(mask), "r"(bits));
  return d;
}

// Nibbles i and i + 4 of w as the exact bf16 pair (q_i, q_i+4): 0x4300 | q
// is 128 + q, and one bf16x2 subtraction leaves q.
__device__ __forceinline__ uint32_t q_pair(uint32_t w, int i) {
  const uint32_t magic = and_or(w >> (4 * i), 0x000F000Fu, 0x43004300u);
  return bf162_bits(__hsub2(bits_bf162(magic), bits_bf162(0x43004300u)));
}

// Output of 4 adjacent columns c..c+3 (tile-local; n = n0 + c) of one row
// from its f32 row in shared memory: RoPE in f32, cast, residual in bf16.
__device__ __forceinline__ void finish4(const float* rowbuf, int c, int row, int n,
                                        const TileArgs& a) {
  bf16 o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int cc = c + e;
    float v = rowbuf[cc];
    if (a.rope_style != 0) {
      const int half = a.rope_hd / 2;
      const int pc = a.rope_style == 1 ? (cc ^ 1)
                                       : ((cc % a.rope_hd) < half ? cc + half : cc - half);
      v = v * a.cos_row[n + e] + rowbuf[pc] * a.sin_row[n + e];
    }
    o[e] = f2bf(v);
  }
  if (a.residual != nullptr) {
    const uint2 rr = *reinterpret_cast<const uint2*>(a.residual + (size_t)row * a.N + n);
    const bf16* rv = reinterpret_cast<const bf16*>(&rr);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = f2bf(bf2f(rv[e]) + bf2f(o[e]));
  }
  uint2 ov;
  ov.x = pack_bf16_pair(o[0], o[1]);
  ov.y = pack_bf16_pair(o[2], o[3]);
  *reinterpret_cast<uint2*>(a.out + (size_t)row * a.N + n) = ov;
}

// Row prep: the tile's x operand into xt, in the order the stages read it
// (for each BM-row tile, each K step its BM x 64 core-matrix tile: one
// contiguous bulk copy a stage), with the layout's chunk order (magic: the
// unit's four segments); K rows at or past Kx and rows past M are zero.
// Folded also: the RMSNorm (1 / rms over the Kx columns, rms_kernel; the
// normalized x rounded to bf16), each 8-column chunk stored in the order
// (0, 4, 1, 5, 2, 6, 3, 7) that its nibble pairs take (P::PAIRED; the W8
// tile of w8_matmul.cu, whose zero point is folded out too, keeps K order),
// and sum(x) per group of the stored values into xsum (Kx / gs, Mpad), so no
// tile block re-reads whole rows.
constexpr int PREP_THREADS = 256;

__device__ __forceinline__ float prep_value(float f, float rinv, const float* norm, int k) {
  return norm != nullptr ? round_bf16((f * rinv) * norm[k]) : f;
}

// Folded with a norm: 1 / rms of each row into the row after the group sums
// (xsum + G * Mpad), one warp a row.
template <class P>
__global__ void __launch_bounds__(PREP_THREADS) rms_kernel(const TileArgs a) {
  const int lane = threadIdx.x & 31, row = blockIdx.x * 8 + (threadIdx.x >> 5);
  float ss = 0.f;
  if (row < a.M) {
    const bf16* xr = a.x + (size_t)row * a.x_stride;
    for (int k = lane * 8; k < a.Kx; k += 256) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + k);
      const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float f = bf2f(v[j]);
        ss += f * f;
      }
    }
    ss = warp_sum(ss);
  }
  if (lane == 0) a.xsum[(size_t)(a.Kx / a.gs) * a.Mpad + row] = 1.f / sqrtf(ss / (float)a.Kx + a.eps);
}

// One block a (group of 8 rows, K granule): the granule's chunks of the 8
// rows as contiguous 1 KB stores; folded also the rows' sums over the
// granule's group (warp w: row 8 * blockIdx.x + w).
template <class P>
__global__ void __launch_bounds__(PREP_THREADS) prep_kernel(const TileArgs a) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * 8, gr = blockIdx.y;
  const int steps = a.granules * a.granule_steps, st0 = gr * a.granule_steps;
  bf16* xt = a.xt + (size_t)(row0 / BM) * steps * (BM * BK) + ((row0 % BM) >> 3) * 512;
  const float* norm = P::FOLDED ? a.norm : nullptr;
  const float* rinv_rows = a.xsum + (size_t)(a.Kx / a.gs) * a.Mpad + row0;   // folded + norm
  for (int i = tid; i < a.granule_steps * 64; i += PREP_THREADS) {   // (step, chunk, row)
    const int r = i & 7, c = (i >> 3) & 7, st = st0 + (i >> 6), row = row0 + r;
    const int k = P::unit_base(st, a.tk) + P::chunk_off(c, a.tk);
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (row < a.M && k < a.Kx) {
      o = *reinterpret_cast<const uint4*>(a.x + (size_t)row * a.x_stride + k);
      if constexpr (P::FOLDED) {
        const bf16* v = reinterpret_cast<const bf16*>(&o);
        const float rinv = norm != nullptr ? rinv_rows[r] : 1.f;
        float f[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = prep_value(bf2f(v[j]), rinv, norm, k + j);
        if constexpr (P::PAIRED) {
          o.x = pack_bf16x2(f[0], f[4]);
          o.y = pack_bf16x2(f[1], f[5]);
          o.z = pack_bf16x2(f[2], f[6]);
          o.w = pack_bf16x2(f[3], f[7]);
        } else {
          o.x = pack_bf16x2(f[0], f[1]);
          o.y = pack_bf16x2(f[2], f[3]);
          o.z = pack_bf16x2(f[4], f[5]);
          o.w = pack_bf16x2(f[6], f[7]);
        }
      }
    }
    *reinterpret_cast<uint4*>(xt + (size_t)st * (BM * BK) + c * 64 + r * 8) = o;
  }
  if constexpr (P::FOLDED) {   // the granule is group gr
    const int row = row0 + warp;
    float sum = 0.f;
    if (row < a.M) {
      const bf16* xr = a.x + (size_t)row * a.x_stride;
      const float rinv = norm != nullptr ? rinv_rows[warp] : 1.f;
      for (int k = gr * a.gs + 2 * lane; k < (gr + 1) * a.gs; k += 64) {
        const uint32_t raw = *reinterpret_cast<const uint32_t*>(xr + k);
        sum += prep_value(__uint_as_float(raw << 16), rinv, norm, k) +
               prep_value(__uint_as_float(raw & 0xffff0000u), rinv, norm, k + 1);
      }
      sum = warp_sum(sum);
    }
    if (lane == 0) a.xsum[(size_t)gr * a.Mpad + row] = sum;
  }
}

template <class P>
struct Shape {
  static constexpr int X_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = 8 * BN * 4;
  static constexpr int C_FLOATS = 2 * P::COEF_ROWS * BN + (P::FOLDED ? BM : 0);
  static constexpr int STAGE_BYTES = X_BYTES + B_BYTES + C_FLOATS * 4;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int EPI = BM * C_LD * 4;
  static constexpr int SMEM = RING > EPI ? RING : EPI;
};

template <class P>
__global__ void __launch_bounds__(THREADS) tile_kernel(const TileArgs a) {
  using S = Shape<P>;
  constexpr int NACC = BM / 2;   // accumulators a thread holds per wgmma
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int gr0 = (int)((long long)blockIdx.z * a.granules / a.split);
  const int gr1 = (int)((long long)(blockIdx.z + 1) * a.granules / a.split);
  const int s0 = gr0 * a.granule_steps;
  const int nsteps = (gr1 - gr0) * a.granule_steps;

  // Thread 0 fills a stage with bulk copies: the stage's prepared x tile
  // (one contiguous copy), 8 rows of words, the coefficient rows (and the
  // x sums); the stage's mbarrier counts the bytes in.
  __shared__ __align__(8) uint64_t full[STAGES];
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // a row of words / coefficients: a last tile of fewer columns (N a multiple of
  // 64, not of 128: Falcon-7B's 4544) copies only its own; its columns past N
  // compute on stale shared memory, each weight column its own wgmma row, and
  // are never stored
  const uint32_t wbytes = 4u * (uint32_t)min(BN, a.N - n0);
  const uint32_t tx =
      S::X_BYTES + (8 + 2 * P::COEF_ROWS) * wbytes + (P::FOLDED ? BM * 4 : 0);
  const bf16* xtile = a.xt + (size_t)blockIdx.x * a.granules * a.granule_steps * (BM * BK);
  const int cstride = P::coef_stride(a.gs, a.tk);   // groups from one coefficient row to the next

  auto load_stage = [&](int step, int slot) {
    unsigned char* st = smem + slot * S::STAGE_BYTES;
    uint32_t* Bs = reinterpret_cast<uint32_t*>(st + S::X_BYTES);
    float* Cf = reinterpret_cast<float*>(st + S::X_BYTES + S::B_BYTES);
    uint64_t* bar = &full[slot];
    mbar_expect_tx(bar, tx);
    bulk_copy(st, xtile + (size_t)step * (BM * BK), S::X_BYTES, bar);
#pragma unroll
    for (int wr = 0; wr < 8; ++wr)
      bulk_copy(Bs + wr * BN, a.packed + (size_t)(step * 8 + wr) * a.N + n0, wbytes, bar);
    const int g0 = P::unit_base(step, a.tk) / a.gs;   // the stage's first segment's group
#pragma unroll
    for (int r = 0; r < P::COEF_ROWS; ++r) {
      const size_t off = (size_t)(g0 + r * cstride) * a.N + n0;
      bulk_copy(Cf + r * BN, a.scales + off, wbytes, bar);
      bulk_copy(Cf + (P::COEF_ROWS + r) * BN, a.zs + off, wbytes, bar);
    }
    if constexpr (P::FOLDED)
      bulk_copy(Cf + 2 * BN, a.xsum + (size_t)g0 * a.Mpad + m0, BM * 4, bar);
  };

  // acc[i]: weight columns nb + 2i (d[4c], d[4c+1]) and nb + 2i + 1 (d[4c+2],
  // d[4c+3]), x rows 8c + 2t and 8c + 2t + 1
  float acc[2][NACC];
  float gacc[P::FOLDED ? 2 : 1][NACC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < NACC; ++e) acc[i][e] = 0.f;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s)
      if (s < nsteps) load_stage(s0 + s, s);
  }

  // this thread's four weight columns: wgmma i's rows 16 * (warp % 4) + g and
  // 16 * (warp % 4) + g + 8 are the columns nb + 2i and nb + 2i + 1 of the
  // warpgroup's 128
  const int nb = 32 * warp + 4 * g;
  int gstep = 0;   // folded: stages done of the current group
  for (int it = 0; it < nsteps; ++it) {
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);   // stage it has landed
    __syncthreads();   // every warp is done with stage it - 1, whose slot is refilled now
    if (tid == 0 && it + STAGES - 1 < nsteps)
      load_stage(s0 + it + STAGES - 1, (it + STAGES - 1) % STAGES);
    const unsigned char* st = smem + (it % STAGES) * S::STAGE_BYTES;
    const bf16* Xs = reinterpret_cast<const bf16*>(st);
    const uint32_t* Bs = reinterpret_cast<const uint32_t*>(st + S::X_BYTES);
    const float* Cf = reinterpret_cast<const float*>(st + S::X_BYTES + S::B_BYTES);
    const auto ctx = P::stage_ctx(Bs, Cf, nb, t);
    const bool group_start = P::FOLDED && gstep == 0;
    uint32_t afr[2][2][4];   // [slab parity][wgmma i]: weight registers in flight
#pragma unroll
    for (int j = 0; j < 4; ++j) {   // 16-deep slabs of the stage
      uint32_t b[4][2];
      P::convert(ctx, P::slab_raw(Bs, Cf, nb, j), j, t, b);
      uint32_t(&a0)[4] = afr[j & 1][0];
      uint32_t(&a1)[4] = afr[j & 1][1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a0[2 * h] = b[0][h];
        a0[2 * h + 1] = b[1][h];
        a1[2 * h] = b[2][h];
        a1[2 * h + 1] = b[3][h];
      }
      const uint64_t desc = desc_kmajor(Xs + 2 * j * 64);   // core matrices (., 2j), (., 2j+1)
      const int accumulate = (group_start && j == 0) ? 0 : 1;   // a group's first slab
      // slab j's products run while slab j + 1 is dequantized: wait for slab
      // j - 1's, whose weight registers are held live until then (the
      // hardware reads them asynchronously), and for all at the stage's end
      // (its shared memory is refilled next)
      auto product = [&](float(&d0)[NACC], float(&d1)[NACC]) {
        wgmma_fence();
        hopper::wgmma_rs_64x64x16<0>(d0, a0, desc, accumulate);
        hopper::wgmma_rs_64x64x16<0>(d1, a1, desc, accumulate);
        wgmma_commit();
        if (j < 3) {
          wgmma_wait<1>();
          if (j > 0) reg_keep(afr[(j - 1) & 1]);
        } else {
          wgmma_wait<0>();
          reg_keep(afr[0]);
          reg_keep(afr[1]);
          reg_fence(d0);
          reg_fence(d1);
        }
      };
      if constexpr (P::FOLDED)
        product(gacc[0], gacc[P::FOLDED ? 1 : 0]);
      else
        product(acc[0], acc[1]);
    }
    if constexpr (P::FOLDED) {
      if (++gstep == a.granule_steps) {   // the group ends with this stage
        gstep = 0;
        const float4 s4 = *reinterpret_cast<const float4*>(Cf + nb);
        const float4 z4 = *reinterpret_cast<const float4*>(Cf + BN + nb);
        const float s_[4] = {s4.x, s4.y, s4.z, s4.w}, z_[4] = {z4.x, z4.y, z4.z, z4.w};
        const float* xs = Cf + 2 * BN;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < BM / 8; ++c) {
            const float x0 = xs[8 * c + 2 * t], x1 = xs[8 * c + 2 * t + 1];
            float* o = acc[i] + 4 * c;
            const float* ga = gacc[i] + 4 * c;
            o[0] += s_[2 * i] * ga[0] - z_[2 * i] * x0;
            o[1] += s_[2 * i] * ga[1] - z_[2 * i] * x1;
            o[2] += s_[2 * i + 1] * ga[2] - z_[2 * i + 1] * x0;
            o[3] += s_[2 * i + 1] * ga[3] - z_[2 * i + 1] * x1;
          }
      }
    }
  }

  __syncthreads();   // the ring is free: reuse it for the f32 tile
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < BM / 8; ++c) {
      const int r = 8 * c + 2 * t, col = nb + 2 * i;
      Cs[r * C_LD + col] = acc[i][4 * c];
      Cs[(r + 1) * C_LD + col] = acc[i][4 * c + 1];
      Cs[r * C_LD + col + 1] = acc[i][4 * c + 2];
      Cs[(r + 1) * C_LD + col + 1] = acc[i][4 * c + 3];
    }
  __syncthreads();
  for (int idx = tid; idx < BM * (BN / 4); idx += THREADS) {
    const int r = idx / (BN / 4), c = 4 * (idx % (BN / 4));
    const int row = m0 + r, n = n0 + c;
    if (row >= a.M || n >= a.N) continue;
    if (a.split == 1) {
      finish4(Cs + r * C_LD, c, row, n, a);
    } else {
      *reinterpret_cast<float4*>(a.ws + ((size_t)blockIdx.z * a.M + row) * a.N + n) =
          *reinterpret_cast<const float4*>(Cs + r * C_LD + c);
    }
  }
}

// The split-K reduction: RED_ROWS rows x RED_BN columns a block; the partials
// are summed in split order, then the epilogue runs once. (Templated on the
// policy only so that a profiler trace names the layout it reduces.)
template <class P>
__global__ void __launch_bounds__(RED_ROWS * 32) reduce_kernel(const TileArgs a) {
  __shared__ __align__(16) float rows[RED_ROWS][RED_BN + 4];
  const int r = threadIdx.x >> 5, c = 4 * (threadIdx.x & 31);
  const int row = blockIdx.y * RED_ROWS + r, n = blockIdx.x * RED_BN + c;
  const bool ok = row < a.M && n < a.N;
  float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ok) {
    for (int sp = 0; sp < a.split; ++sp) {
      const float4 p = *reinterpret_cast<const float4*>(a.ws + ((size_t)sp * a.M + row) * a.N + n);
      y.x += p.x;
      y.y += p.y;
      y.z += p.z;
      y.w += p.w;
    }
  }
  *reinterpret_cast<float4*>(&rows[r][c]) = y;
  __syncthreads();
  if (ok) finish4(rows[r], c, row, n, a);
}

// The row-prep passes, the tile (and the reduction pass when K is split): two
// to four launches in one call. Requires N % 4 == 0, 16-byte aligned rows of
// x, packed, scales and zs, Mpad = M rounded up to BM, xt of Mpad x
// (steps x 64) bf16 and (folded) xsum of (Kx / gs + 1) x Mpad f32 (the last
// row: 1 / rms).
template <class P>
cudaError_t launch(const TileArgs& a, cudaStream_t st) {
  using S = Shape<P>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      tile_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (attr != cudaSuccess) return attr;
  cudaError_t e;
  if (P::FOLDED && a.norm != nullptr) {
    rms_kernel<P><<<a.Mpad / 8, PREP_THREADS, 0, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  prep_kernel<P><<<dim3(a.Mpad / 8, a.granules), PREP_THREADS, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dim3 grid(a.Mpad / BM, (a.N + BN - 1) / BN, a.split);
  tile_kernel<P><<<grid, THREADS, S::SMEM, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.split == 1) return e;
  const dim3 rgrid((a.N + RED_BN - 1) / RED_BN, (a.M + RED_ROWS - 1) / RED_ROWS);
  reduce_kernel<P><<<rgrid, RED_ROWS * 32, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace w4tile
