// W4A16 matmul for many rows (M >= 1024: a batched prefill, the QPEFT
// training forward).
//
// Replaces: accessory_tpu/ops/quant_matmul_bigm.py::planes_qmm_bigm (Pallas
// kernel `_kernel`), the weight-stationary large-M form of the W4 matmul.
//
//   y = x @ bf16(q * s - zs)        f32 accumulation over the whole of K
//
// Numerics are the TPU kernel's: every weight is dequantized in f32
// (q * s, then - zs, two roundings, no fused multiply-add), rounded once to
// bf16, and the product accumulates in f32 over all of K before one cast to
// bf16. (w4_matmul.cu keeps q exact and applies the scale per group in f32
// instead; the two forms differ by the bf16 rounding of the weight.) No
// prologue, no epilogue, no K split: each output element is one f32 sum in
// a fixed order, so two launches give the same bits.
//
// Weight layout: the port's folded layout, packed (K/8, N) uint32 with 8
// nibbles per word along K, scales and zs = zeros * scales (K/gs, N) f32.
//
// Bound on the H100: operations. At M rows the call does 2*M*K*N flops for
// K*N/2 + 8*N*K/gs weight bytes, about 3.6 * M flops per byte: far above the
// card's ~295 flops per byte from M ~ 83 on.
//
// Design (w8_matmul.cu's tile, fed by TMA and warp-specialized): the
// product is computed transposed, y^T = w^T x^T. An output tile is 256 x
// rows by 128 weight columns; each of two consumer warpgroups owns 64 of the
// columns as one wgmma m64n256k16 a 16-deep slab, with the dequantized
// weight as its register operand A and the stage's 256 x rows as its
// shared-memory operand B, so each weight is dequantized once for 256 rows.
// A producer warpgroup (its registers handed to the consumers by setmaxnreg)
// fills a ring of STAGES stages (64 K rows each) with four copies: x and the
// 8 word rows by one TMA box each (x: 64 K x 256 rows, 128-byte swizzle, rows
// past M as zeros, so no row-prep pass and no scratch; words: 128 columns x 8
// rows), the group's scale and zs rows by bulk copies, all counted on the
// stage's `full` mbarrier; the consumers hand a stage back on its `empty`
// mbarrier once its products are done. A thread dequantizes its two columns'
// four k rows of each slab from two 8-byte shared loads (q as the f32 bit
// pattern 0x4B000000 | q less 2^23, no int -> float convert), then its
// warpgroup issues the stage's four wgmmas back to back and waits for them
// at the stage's end: the two warpgroups fall out of step after the first
// stage, so one converts while the other's products run. The grid is
// persistent (one block an SM, the wrapper's plan ops/w4_tile.py
// bigm_plan): a block walks output tiles with the row tiles of one column
// panel on neighbouring blocks (the panel's words come from HBM once, then
// L2), and the producer fills the next tile's stages while the consumers
// store the last one's outputs.
//
// What the card taught (throwaway variants timed in turns on an NVIDIA H100
// 80GB HBM3, not kept): dequantizing slab j + 1 while slab j's wgmma runs
// makes ptxas serialize every wgmma (warning C7513: a wgmma's register
// operand written while another is in flight), and issuing a stage's four at
// once with no such overlap ran faster; so did one TMA box for the 8 word rows
// in place of 8 bulk copies (each copy costs the SM's copy engine a share
// whatever its size). This design takes 333.0 us for 7B's w13 at 1024 rows,
// 1.42x torch.matmul on the dense weight, about 56% of the bf16 peak, on an
// NVIDIA H100 80GB HBM3, 700.00 W (PERF.md row 5, measured by chip_smoke.py).
//
// The design it replaces (a 128 x 128 mma.sync tile, all threads
// dequantizing a stage into shared memory between two barriers, the next
// stage prefetched into registers) ran at ~24% of the bf16 peak: 776.9 us for
// 7B's w13 at 1024 rows on an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md row 5,
// measured by chip_smoke.py), 3.2x torch.matmul on the dense weight.

#include "hopper.cuh"

namespace {

constexpr int BM = 256;                    // x rows a tile (wgmma N)
constexpr int BN = 128;                    // weight columns a tile: 64 a consumer warpgroup
constexpr int BK = 64;                     // K rows a stage (8 word rows)
constexpr int STAGES = 5;
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 32 * CONSUMER_WARPS + 128;  // + the producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;   // setmaxnreg: 64,512 of 65,536
constexpr int X_BYTES = BM * BK * 2;       // a TMA box: 256 rows of 128 bytes
constexpr int W_BYTES = 8 * BN * 4;
constexpr int C_BYTES = 2 * BN * 4;        // the group's scale and zs rows
constexpr int STAGE_BYTES = X_BYTES + W_BYTES + C_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES + 1024;   // + the 1024-byte alignment
static_assert(STAGE_BYTES % 1024 == 0, "every stage's x box starts on a swizzle atom");

struct BigmArgs {
  CUtensorMap xmap;          // x (M, Kx) bf16, box 64 x 256, 128-byte swizzle
  CUtensorMap wmap;          // packed (Kx/8, N) words, box 128 x 8
  const float* scales;       // (>= Kx/gs, N)
  const float* zs;
  bf16* out;                 // (M, N)
  int M, N, gs, steps;       // steps: Kx / 64
  int tiles_m, tiles;
};

// q * s - zs of nibbles 2t, 2t + 1 of w (k rows 2t, 2t + 1 of its 8), f32
// with two roundings, as one bf16 pair
__device__ __forceinline__ uint32_t dequant2(uint32_t w, int sh, float s, float zs) {
  const uint32_t v = w >> sh;
  const float q0 = __uint_as_float(0x4B000000u | (v & 0xFu)) - 8388608.f;
  const float q1 = __uint_as_float(0x4B000000u | ((v >> 4) & 0xFu)) - 8388608.f;
  return pack_bf16x2(__fsub_rn(__fmul_rn(q0, s), zs), __fsub_rn(__fmul_rn(q1, s), zs));
}

__global__ void __launch_bounds__(THREADS, 1) w4_bigm_wgmma_kernel(const __grid_constant__ BigmArgs a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  unsigned char* smem = hopper::align1024(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], CONSUMER_WARPS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {   // the producer warpgroup: one lane issues every copy
    hopper::regs_dec<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      hopper::prefetch_map(&a.xmap);
      hopper::prefetch_map(&a.wmap);
      int it = 0;
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
        const int m0 = (tile % a.tiles_m) * BM, n0 = (tile / a.tiles_m) * BN;
        // a last column panel of 64 (N a multiple of 64, not of 128): the word
        // box's columns past N land as zeros and count in full, the scale and
        // zs rows are copied as far as N
        const uint32_t cbytes = 4u * (uint32_t)min(BN, a.N - n0);
        for (int s = 0; s < a.steps; ++s, ++it) {
          const int slot = it % STAGES;
          if (it >= STAGES) hopper::mbar_wait(&empty[slot], (it / STAGES - 1) & 1);
          unsigned char* st = smem + slot * STAGE_BYTES;
          uint64_t* bar = &full[slot];
          hopper::mbar_expect_tx(bar, X_BYTES + W_BYTES + 2 * cbytes);
          hopper::tma_load_2d(st, &a.xmap, s * BK, m0, bar);
          hopper::tma_load_2d(st + X_BYTES, &a.wmap, n0, s * 8, bar);
          const size_t g = (size_t)(s * BK / a.gs) * a.N + n0;
          hopper::bulk_copy(st + X_BYTES + W_BYTES, a.scales + g, cbytes, bar);
          hopper::bulk_copy(st + X_BYTES + W_BYTES + BN * 4, a.zs + g, cbytes, bar);
        }
      }
    }
    return;
  }

  hopper::regs_inc<CONSUMER_REGS>();
  // consumers: thread (g, t) of warp q of warpgroup wg dequantizes columns
  // cb and cb + 1 (its A rows g and g + 8), k rows 2t, 2t + 1 of each word
  // row, and holds the outputs of x rows 8j + 2t, + 1 for those columns
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int cb = 64 * wg + 16 * (warp & 3) + 2 * g, sh = 8 * t;
  float acc[128];
  int it = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int m0 = (tile % a.tiles_m) * BM, n0 = (tile / a.tiles_m) * BN;
    for (int s = 0; s < a.steps; ++s, ++it) {
      const int slot = it % STAGES;
      hopper::mbar_wait(&full[slot], (it / STAGES) & 1);
      const unsigned char* st = smem + slot * STAGE_BYTES;
      const uint32_t* ws = reinterpret_cast<const uint32_t*>(st + X_BYTES) + cb;
      const float* cf = reinterpret_cast<const float*>(st + X_BYTES + W_BYTES) + cb;
      const float2 s2 = *reinterpret_cast<const float2*>(cf);
      const float2 z2 = *reinterpret_cast<const float2*>(cf + BN);
      const uint32_t xaddr = hopper::smem_addr(st);
      uint32_t af4[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint2 w0 = *reinterpret_cast<const uint2*>(ws + (2 * j) * BN);
        const uint2 w1 = *reinterpret_cast<const uint2*>(ws + (2 * j + 1) * BN);
        af4[j][0] = dequant2(w0.x, sh, s2.x, z2.x);
        af4[j][1] = dequant2(w0.y, sh, s2.y, z2.y);
        af4[j][2] = dequant2(w1.x, sh, s2.x, z2.x);
        af4[j][3] = dequant2(w1.y, sh, s2.y, z2.y);
        hopper::pin(af4[j]);
      }
      int accumulate = s > 0;
      hopper::pin(accumulate);
      int one = 1;
      hopper::pin(one);
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        hopper::wgmma_rs_64x256x16<0>(acc, af4[j], hopper::desc_b128(xaddr + 32 * j, 16, 1024),
                                      j > 0 ? one : accumulate);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < 4; ++j) hopper::reg_keep(af4[j]);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[slot]);
    }
    hopper::reg_fence(acc);
    // the tile's outputs straight from the accumulators: x rows 8j + 2t
    // (acc[4j], acc[4j + 2]) and 8j + 2t + 1 (acc[4j + 1], acc[4j + 3]) of
    // columns cb, cb + 1; none past N (their weights were zeros, their
    // coefficients stale shared memory; a warpgroup's 64 columns lie all
    // before N or all past it, so the skip is uniform)
    if (n0 + cb >= a.N) continue;
    bf16* o = a.out + (size_t)m0 * a.N + n0 + cb;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const int r = 8 * j + 2 * t;
      if (m0 + r < a.M)
        *reinterpret_cast<uint32_t*>(o + (size_t)r * a.N) = pack_bf16x2(acc[4 * j], acc[4 * j + 2]);
      if (m0 + r + 1 < a.M)
        *reinterpret_cast<uint32_t*>(o + (size_t)(r + 1) * a.N) =
            pack_bf16x2(acc[4 * j + 1], acc[4 * j + 3]);
    }
  }
}

}  // namespace

// x (M, Kx) bf16 with row stride x_stride (elements, a multiple of 8, rows
// 16-byte aligned); packed (>= Kx/8, N) words; scales/zs (>= Kx/gs, N) f32;
// out (M, N) bf16 contiguous; ctas: the persistent grid (the wrapper's plan,
// ops/w4_tile.py bigm_plan). Requires Kx % 64 == 0, gs % 64 == 0,
// N % 64 == 0 (a last column panel of 64 is bounded), M >= 1 (a ragged last
// row tile is masked).
extern "C" int w4_matmul_bigm(const void* x, int M, int Kx, long long x_stride,
                              const void* packed, const void* scales, const void* zs, int N,
                              int gs, void* out, int ctas, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 0 || Kx <= 0 || Kx % BK != 0 || gs % BK != 0 || N <= 0 || N % 64 != 0 || ctas < 1 ||
      x_stride % 8 != 0 || x_stride < Kx)
    return (int)cudaErrorInvalidValue;
  BigmArgs a{};
  const cuuint64_t dims[2] = {(cuuint64_t)Kx, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)x_stride * 2};
  const cuuint32_t box[2] = {BK, BM};
  cudaError_t e = hopper::make_map(&a.xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 2, dims, strides,
                                   box, true);
  if (e != cudaSuccess) return (int)e;
  const cuuint64_t wdims[2] = {(cuuint64_t)N, (cuuint64_t)(Kx / 8)};
  const cuuint64_t wstrides[1] = {(cuuint64_t)N * 4};
  const cuuint32_t wbox[2] = {BN, 8};
  e = hopper::make_map(&a.wmap, CU_TENSOR_MAP_DATA_TYPE_UINT32, packed, 2, wdims, wstrides, wbox,
                       false);
  if (e != cudaSuccess) return (int)e;
  a.scales = static_cast<const float*>(scales);
  a.zs = static_cast<const float*>(zs);
  a.out = static_cast<bf16*>(out);
  a.M = M;
  a.N = N;
  a.gs = gs;
  a.steps = Kx / BK;
  a.tiles_m = (M + BM - 1) / BM;
  a.tiles = a.tiles_m * ((N + BN - 1) / BN);
  static const cudaError_t attr = cudaFuncSetAttribute(
      w4_bigm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  w4_bigm_wgmma_kernel<<<ctas < a.tiles ? ctas : a.tiles, THREADS, SMEM, st>>>(a);
  return (int)cudaGetLastError();
}
