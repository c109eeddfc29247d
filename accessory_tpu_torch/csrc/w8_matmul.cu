// W8A16 matmul with fused RMSNorm prologue, RoPE epilogue and residual add.
//
// Replaces: accessory_tpu/ops/quant_matmul_w8.py::w8_qmm (Pallas kernel
// `_kernel`).
//
//   y = rope([rms_norm(x)] @ bf16(q8 * s) - sum_g xsum_g * zs_g)  [+ residual]
//
// Weight layout (the port's "w8" layout, the TPU kernel's): q8 (K, N) int8
// rows, row-major, holding q - 128 so the asymmetric [0, 255] grid fits
// int8; scales and zs = (zeros - 128) * scales (K/gs, N) f32. Numerics are
// the TPU kernel's: each weight is rounded to bf16 as bf16(q8 * s) before the
// product, the zero-point term xsum_g * zs_g is f32 with xsum_g the group's
// sum of the bf16 activations (after the norm), accumulation is f32, RoPE
// acts on the f32 sum before the cast and the residual is added in bf16
// after it. The norm prologue has the reference's op order
// (x * rsqrt(mean(x^2) + eps)) * w, rounded to bf16.
//
// Two shapes, chosen by the row count:
//  * GEMV for M <= 8 (decode). Bound: bytes, 1 B a weight plus 8 B of f32
//    scale and zs per column per group (7B w13: 95.8 MB, 28.6 us at
//    3.35 TB/s). qgemv.cuh's tensor-core GEMV with the W8 policy: each
//    weight made bf16(q8 * s) in registers (the tile's bit pattern below) as
//    mma.sync's A operand, the zero-point term sum_g xsum_g * zs_g in f32 at
//    each group's end, K split over a cluster (ops/w4_tile.py
//    w8_gemv_split). It takes 52.2 us for 7B's w13 at M = 8 (wqkv 36.7, wo
//    13.7, w2 27.3; torch.matmul on the dense weight 60.0 / 35.5 / 13.3 /
//    33.2) on an NVIDIA H100 80GB HBM3, 700.00 W. The GEMV it replaces (a
//    thread 8 columns of 8 K rows, f32 FMAs on the CUDA cores, 512 threads
//    on each of N / 64 blocks) took 163.2 / 110.9 / 49.6 / 122.2 us on the
//    same shapes and card. PERF.md, row 22, holds both designs' times,
//    measured by chip_smoke.py.
//  * wgmma tile for M > 8 (the 1024-row prefill, and any fused call of
//    9..1023 rows). Bound: operations from ~300 rows (about 2 M flops a
//    weight byte). A row-prep pass (w4_tile.cuh's prep_kernel, and its
//    rms_kernel for the norm) writes x once, normalized and rounded, tiled in
//    wgmma's core matrices, with sum(x) per (group, row) beside it, so no
//    block re-reads x rows. The product is computed transposed, y^T = w^T
//    x^T: a block is two warpgroups over 256 x rows and 128 weight columns,
//    each warpgroup one wgmma m64n256k16 a 16-deep slab with the weight as
//    its register operand A (the int8 values of its two columns and four k
//    rows a thread read from the staged rows, made bf16(q8 * s) in
//    registers: the pattern 0x4B000000 | (q8 ^ 0x80) less 2^23 + 128, one f32
//    product, one rounding, no int -> float convert) and the stage's x rows
//    its shared-memory operand B; slab j + 1 is converted while slab j's
//    products run, and each weight is converted once for 256 rows. A ring
//    of 5 stages (64 K rows each) is filled by thread 0's bulk copies (the
//    x tiles and the group's scale row, on an mbarrier) and every thread's
//    cp.async pieces of the int8 rows. The zero-point term leaves the K
//    loop: the epilogue stages the sums and zs rows of a chunk of groups in
//    shared memory and subtracts sum_g xsum_g * zs_g in f32, then RoPE (the
//    partner column is in the staged f32 row), the cast and the residual.
//    Where the tiles are too few for the card, K is split in whole groups
//    (ops/w4_tile.py w8_plan) and w4_tile.cuh's reduction pass sums the
//    partials in split order (deterministic, no atomics). What the card
//    taught (stripped builds on an NVIDIA H100 80GB HBM3, 700.00 W, not
//    kept): 64 bulk copies a stage, one a 256-byte int8 row, kept the SM's
//    copy engine busier than the stage's products; dequantizing into a shared bf16 tile for
//    two shared-memory operands needs fence.proxy.async before the wgmma,
//    which compiles to MEMBAR.ALL.CTA and so waits for the thread's
//    outstanding cp.async copies every stage; per-group zs loads from
//    global memory in the epilogue ran one after another; and a 128-row
//    tile converted each weight twice as often. This design takes 478.6 us
//    for 7B's w13 at 1024 rows (wqkv 246.2, wo 90.6, w2 226.2), 2.03x
//    torch.matmul on the dense weight, on an NVIDIA H100 80GB HBM3,
//    700.00 W: about 39% of the bf16 peak. The tile it replaces
//    (mma.sync m16n8k16 on 128 x 128 tiles) staged one prefetch in
//    registers between two barriers, converted every weight int -> float
//    once per 128-row block, read its fragments with 32-bit shared loads,
//    subtracted the zero-point term inside the K loop and re-read whole x
//    rows for the norm in every block: 1259.2 us for 7B's w13 at 1024 rows
//    on an NVIDIA H100 80GB HBM3, 700.00 W, 5.37x torch.matmul on the dense
//    weight. PERF.md row 22 holds both designs' times, measured by
//    chip_smoke.py.
//
// The N tile holds whole heads for RoPE (interleaved partner n ^ 1, half
// n +- hd/2; the GEMV's and the tile's 128 columns and the reduction's 128).

#include "qgemv.cuh"

namespace {

// ---------------------------------------------------------------- the tile (M > 8)

constexpr int TBM = 256;                 // x rows a block (wgmma N)
constexpr int TBN = 128;                 // weight columns a block: a warpgroup's 64 (wgmma M)
constexpr int TBK = 64;                  // K rows a stage
constexpr int TTHREADS = 256;
constexpr int TSTAGES = 5;
constexpr int X_TILES = TBM / w4tile::BM;   // the prep's 64-row x tiles a stage copies
constexpr int X_BYTES = TBM * TBK * 2;
// a staged int8 row: the 16 bytes past 128 make the fragment loads (rows
// 2t.., columns 2g..) free of bank conflicts
constexpr int RAW_LD = TBN + 16;
constexpr int RAW_OFF = X_BYTES;
constexpr int SC_OFF = RAW_OFF + TBK * RAW_LD;
constexpr int STAGE_BYTES = SC_OFF + TBN * 4;
constexpr int TSMEM = TSTAGES * STAGE_BYTES;
constexpr int TC_LD = TBN + 4;           // f32 per row of the epilogue tile
constexpr int ZG = 32;                   // groups of the epilogue's zero-point term a chunk
constexpr int Z_OFF = TBM * TC_LD * 4;   // the chunk's sums and zs, past the epilogue tile
static_assert(Z_OFF + ZG * (TBM + TBN) * 4 <= TSMEM, "the epilogue fits the ring");
static_assert(TBK == w4tile::BK && TBM % w4tile::BM == 0, "x comes tiled by w4_tile's row prep");

// The row-prep, rms and split-K reduction passes of w4_tile.cuh as the W8
// tile takes them: the norm applied and rounded in the prep, x stored in K
// order, sum(x) per (group, row) for the zero-point term.
struct w8_prep {
  static constexpr bool FOLDED = true;    // the zero point is folded out: sum(x) per group
  static constexpr bool PAIRED = false;
  __device__ static __forceinline__ int unit_base(int step, int) { return step * TBK; }
  __device__ static __forceinline__ int chunk_off(int c, int) { return 8 * c; }
};

struct W8Tile {
  w4tile::TileArgs t;   // x, the prepared xt and xsum, scales, zs, the split and the epilogue
  const int8_t* q8;
};

// A 256-row x 128-column output tile over the K steps of its split,
// computed transposed: y^T = w^T x^T. Warpgroup wg owns weight columns
// 64 wg .. 64 wg + 63 as one wgmma m64n256k16 a 16-deep slab (A: the
// dequantized weight in registers; B: the stage's 256 x rows in shared
// memory), so each weight is converted once for 256 rows. Thread (g, t) of
// warp q of the warpgroup converts the columns cb and cb + 1, cb = 64 wg +
// 16 q + 2 g (its A rows g and g + 8), k pairs (2t, 2t + 1) and (2t + 8,
// 2t + 9) of each slab: four 2-byte loads of the staged int8 rows. Slab
// j + 1 is converted while slab j's products run.
__global__ void __launch_bounds__(TTHREADS, 1) w8_tile_kernel(const W8Tile A) {
  const w4tile::TileArgs& a = A.t;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[TSTAGES];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * TBM, n0 = blockIdx.y * TBN;
  const int gr0 = (int)((long long)blockIdx.z * a.granules / a.split);
  const int gr1 = (int)((long long)(blockIdx.z + 1) * a.granules / a.split);
  const int steps = a.granules * a.granule_steps;   // xt's K steps (all of Kx)
  const int s0 = gr0 * a.granule_steps, nsteps = (gr1 - gr0) * a.granule_steps;
  const int ncols = min(TBN, a.N - n0);
  // the block's first 64-row x tile of the prep; the next X_TILES - 1 follow
  const bf16* xtile = a.xt + (size_t)(X_TILES * blockIdx.x) * steps * (w4tile::BM * TBK);

  // a stage: thread 0 bulk-copies its X_TILES x tiles and the group's scale
  // row (the stage's mbarrier counts their bytes); every thread copies its
  // pieces of the 64 int8 rows by cp.async (16 bytes, or 8 where N % 16 !=
  // 0 leaves the rows 8-byte aligned; columns past N as zeros), one commit
  // group a stage, empty past the last. (A bulk copy a row kept the SM's
  // copy engine busier than the products; per-thread pieces recomputing
  // their addresses cost more issue slots than the products leave free.)
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < TSTAGES; ++i) w4tile::mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const uint32_t tx = X_BYTES + 4 * ncols;
  const bool wide = a.N % 16 == 0;
  // this thread's pieces: rows prow + 32 i (16 i for 8-byte pieces), columns pcol ..
  const int piece = wide ? 16 : 8, prow = tid / (TBN / piece), pcol = piece * (tid % (TBN / piece));
  const bool pon = pcol < ncols;
  const int8_t* psrc = A.q8 + (size_t)(s0 * TBK + prow) * a.N + n0 + (pon ? pcol : 0);
  auto load_stage = [&](int it) {
    if (it < nsteps) {
      const int step = s0 + it;
      unsigned char* st = smem + (it % TSTAGES) * STAGE_BYTES;
      if (tid == 0) {
        uint64_t* bar = &full[it % TSTAGES];
        w4tile::mbar_expect_tx(bar, tx);
#pragma unroll
        for (int x = 0; x < X_TILES; ++x)
          w4tile::bulk_copy(st + x * (X_BYTES / X_TILES),
                            xtile + ((size_t)x * steps + step) * (w4tile::BM * TBK),
                            X_BYTES / X_TILES, bar);
        w4tile::bulk_copy(st + SC_OFF, a.scales + (size_t)(step * TBK / a.gs) * a.N + n0,
                          4 * ncols, bar);
      }
      const int8_t* src = psrc + (size_t)it * TBK * a.N;
      unsigned char* dst = st + RAW_OFF + prow * RAW_LD + pcol;
      if (wide) {
#pragma unroll
        for (int i = 0; i < TBK / 32; ++i)
          cp_async<16>(dst + i * 32 * RAW_LD, src + (size_t)i * 32 * a.N, pon ? 16 : 0);
      } else {
#pragma unroll
        for (int i = 0; i < TBK / 16; ++i)
          cp_async<8>(dst + i * 16 * RAW_LD, src + (size_t)i * 16 * a.N, pon ? 8 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < TSTAGES - 2; ++s) load_stage(s);

  const int cb = 64 * wg + 16 * (warp & 3) + 2 * g;
  float acc[128];
#pragma unroll
  for (int e = 0; e < 128; ++e) acc[e] = 0.f;
  uint32_t afr[2][4];   // [slab parity]: weight registers in flight

  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<TSTAGES - 3>();   // stage it's int8 rows, this thread's pieces
    w4tile::mbar_wait(&full[it % TSTAGES], (it / TSTAGES) & 1);   // its x and scales
    __syncthreads();   // everyone's pieces; every warpgroup is done with stage it - 2: refill it
    load_stage(it + TSTAGES - 2);
    const unsigned char* st = smem + (it % TSTAGES) * STAGE_BYTES;
    const unsigned char* raw = st + RAW_OFF + cb;
    const float2 s2 = *reinterpret_cast<const float2*>(st + SC_OFF + 4 * cb);
#pragma unroll
    for (int j = 0; j < 4; ++j) {   // 16-deep slabs of the stage
      uint32_t w[4];   // k rows 16j + 2t, + 1, + 8, + 9: the thread's two columns
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[r] = *reinterpret_cast<const uint16_t*>(
                   raw + (16 * j + 2 * t + (r & 1) + 8 * (r >> 1)) * RAW_LD) ^
               0x8080u;
      uint32_t(&af)[4] = afr[j & 1];
      using qgemv::w8_value;
      af[0] = pack_bf16x2(w8_value(w[0], 0, s2.x), w8_value(w[1], 0, s2.x));
      af[1] = pack_bf16x2(w8_value(w[0], 1, s2.y), w8_value(w[1], 1, s2.y));
      af[2] = pack_bf16x2(w8_value(w[2], 0, s2.x), w8_value(w[3], 0, s2.x));
      af[3] = pack_bf16x2(w8_value(w[2], 1, s2.y), w8_value(w[3], 1, s2.y));
      w4tile::wgmma_fence();
      hopper::wgmma_rs_64x256x16<0>(acc, af, w4tile::desc_kmajor(st + j * 256),
                                    1);   // k chunks 2j, 2j + 1
      w4tile::wgmma_commit();
      // slab j - 1's products are done (slab j's may run on): its weight
      // registers, held live until here, are free for slab j + 1
      w4tile::wgmma_wait<1>();
      hopper::reg_keep(afr[(j + 1) & 1]);
    }
  }
  w4tile::wgmma_wait<0>();
  w4tile::reg_keep(afr);
  w4tile::reg_fence(acc);

  // epilogue: the f32 tile [x row][column] into the idle ring, the split's
  // zero-point term sum_g xsum_g * zs_g (f32, from the prep's sums), then
  // RoPE, the cast and the residual (w4_tile.cuh's finish4), or the split's
  // partial tile
  cp_async_wait<0>();
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < TBM / 8; ++j) {
    const int r = 8 * j + 2 * t;
    *reinterpret_cast<float2*>(Cs + r * TC_LD + cb) = make_float2(acc[4 * j], acc[4 * j + 2]);
    *reinterpret_cast<float2*>(Cs + (r + 1) * TC_LD + cb) =
        make_float2(acc[4 * j + 1], acc[4 * j + 3]);
  }
  __syncthreads();
  {   // groups in chunks of ZG: their sum(x) rows (the tile's 256 rows) and zs
      // rows (its 128 columns) copied past the f32 tile, then thread: columns
      // 4 cq .. 4 cq + 3, rows rb .. rb + 31, 8 at a time
    float* Xz = reinterpret_cast<float*>(smem + Z_OFF);   // [ZG][TBM]
    float* Zz = Xz + ZG * TBM;                            // [ZG][TBN]
    const int cq = tid % (TBN / 4), rb = (tid / (TBN / 4)) * 32, n = n0 + 4 * cq;
    static_assert(TTHREADS / (TBN / 4) * 32 == TBM, "the threads cover the tile");
    for (int gc = gr0; gc < gr1; gc += ZG) {
      const int ng = min(ZG, gr1 - gc);
      for (int c = tid; c < ng * (TBM / 4); c += TTHREADS) {
        const int r = c / (TBM / 4), q = 4 * (c % (TBM / 4));
        cp_async<16>(Xz + r * TBM + q, a.xsum + (size_t)(gc + r) * a.Mpad + m0 + q, 16);
      }
      for (int c = tid; c < ng * (TBN / 4); c += TTHREADS) {
        const int r = c / (TBN / 4), q = 4 * (c % (TBN / 4));
        const bool on = n0 + q < a.N;
        cp_async<16>(Zz + r * TBN + q, on ? a.zs + (size_t)(gc + r) * a.N + n0 + q : a.zs,
                     on ? 16 : 0);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (n < a.N) {
        for (int r8 = rb; r8 < rb + 32; r8 += 8) {
          float4 c[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            c[i] = *reinterpret_cast<const float4*>(Cs + (r8 + i) * TC_LD + 4 * cq);
          for (int gi = 0; gi < ng; ++gi) {
            const float4 z = *reinterpret_cast<const float4*>(Zz + gi * TBN + 4 * cq);
            const float4 x0 = *reinterpret_cast<const float4*>(Xz + gi * TBM + r8);
            const float4 x1 = *reinterpret_cast<const float4*>(Xz + gi * TBM + r8 + 4);
            const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              c[i].x = fmaf(-xs[i], z.x, c[i].x);
              c[i].y = fmaf(-xs[i], z.y, c[i].y);
              c[i].z = fmaf(-xs[i], z.z, c[i].z);
              c[i].w = fmaf(-xs[i], z.w, c[i].w);
            }
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
            *reinterpret_cast<float4*>(Cs + (r8 + i) * TC_LD + 4 * cq) = c[i];
        }
      }
      __syncthreads();   // the chunk's rows are read before the next chunk's copies
    }
  }
#pragma unroll 4
  for (int idx = tid; idx < TBM * (TBN / 4); idx += TTHREADS) {
    const int r = idx / (TBN / 4), c = 4 * (idx % (TBN / 4));
    const int row = m0 + r, n = n0 + c;
    if (row >= a.M || n >= a.N) continue;
    if (a.split == 1)
      w4tile::finish4(Cs + r * TC_LD, c, row, n, a);
    else
      *reinterpret_cast<float4*>(a.ws + ((size_t)blockIdx.z * a.M + row) * a.N + n) =
          *reinterpret_cast<const float4*>(Cs + r * TC_LD + c);
  }
}

}  // namespace

// x (M, Kx) bf16, row stride x_stride (elements, a multiple of 8, rows 16-byte
// aligned); q8 (>= Kx, N) int8 rows; scales / zs (>= Kx/gs, N) f32; q8,
// scales and zs 16-byte aligned; out (M, N) bf16 contiguous. rope_style: 0
// none, 1 interleaved, 2 half; norm / residual / cos / sin may be null.
// split: for M <= 8 the GEMV's cluster (1 .. 8 blocks over 64-row units,
// ops/w4_tile.py w8_gemv_split; xt, xsum and ws null); for M > 8 the tile's
// K splits with the wrapper's plan (ops/w4_tile.py w8_plan): xt (Mpad x Kx)
// bf16 and xsum (Kx/gs + 1, Mpad) f32 with Mpad = M rounded up to 256, ws
// (split, M, N) f32 when K is split. Requires Kx % gs == 0, gs % 64 == 0,
// N % 8 == 0, and with RoPE N % rope_hd == 0 and whole heads in the
// 128-column tile.
extern "C" int w8_matmul(const void* x, int M, int Kx, long long x_stride, const void* q8,
                         const void* scales, const void* zs, int N, int gs, const void* norm,
                         float eps, const void* residual, const void* cos_row,
                         const void* sin_row, int rope_style, int rope_hd, void* out, void* xt,
                         void* xsum, void* ws, int split, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const int8_t* q = static_cast<const int8_t*>(q8);
  const float* sc = static_cast<const float*>(scales);
  const float* z = static_cast<const float*>(zs);
  const float* nw = static_cast<const float*>(norm);
  const bf16* res = static_cast<const bf16*>(residual);
  const float* cr = static_cast<const float*>(cos_row);
  const float* sr = static_cast<const float*>(sin_row);
  bf16* o = static_cast<bf16*>(out);
  if (M <= 0 || Kx <= 0 || gs % TBK != 0 || Kx % gs != 0 || N <= 0 || N % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (rope_style != 0 && (rope_hd <= 0 || rope_hd % 2 != 0 || N % rope_hd != 0))
    return (int)cudaErrorInvalidValue;
  if (M <= 8) {
    const qgemv::Args g{xb, x_stride, M, Kx, q, sc, z, N, gs, nw, eps, res, cr, sr, rope_style,
                        rope_hd, o, Kx / qgemv::UNIT};
    return (int)qgemv::launch<qgemv::W8>(g, split, N % 16 == 0 ? 16 : 8, st);
  }
  const int granules = Kx / gs;
  if (rope_style == 2 && w4tile::RED_BN % rope_hd != 0) return (int)cudaErrorInvalidValue;
  if (split < 1 || split > granules || xt == nullptr || xsum == nullptr ||
      (split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  W8Tile A{};
  w4tile::TileArgs& a = A.t;
  a.x = xb;
  a.x_stride = x_stride;
  a.M = M;
  a.Kx = Kx;
  a.xt = static_cast<bf16*>(xt);
  a.norm = nw;
  a.eps = eps;
  a.scales = sc;
  a.zs = z;
  a.xsum = static_cast<float*>(xsum);
  a.N = N;
  a.gs = gs;
  a.Mpad = (M + TBM - 1) / TBM * TBM;
  a.granules = granules;
  a.granule_steps = gs / TBK;
  a.split = split;
  a.ws = static_cast<float*>(ws);
  a.out = o;
  a.residual = res;
  a.cos_row = cr;
  a.sin_row = sr;
  a.rope_style = rope_style;
  a.rope_hd = rope_hd;
  A.q8 = q;
  static const cudaError_t attr = cudaFuncSetAttribute(
      w8_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TSMEM);
  if (attr != cudaSuccess) return (int)attr;
  cudaError_t e;
  if (nw != nullptr) {
    w4tile::rms_kernel<w8_prep><<<a.Mpad / 8, w4tile::PREP_THREADS, 0, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  w4tile::prep_kernel<w8_prep><<<dim3(a.Mpad / 8, granules), w4tile::PREP_THREADS, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  w8_tile_kernel<<<dim3(a.Mpad / TBM, (N + TBN - 1) / TBN, split), TTHREADS, TSMEM, st>>>(A);
  if ((e = cudaGetLastError()) != cudaSuccess || split == 1) return (int)e;
  w4tile::reduce_kernel<w8_prep>
      <<<dim3((N + w4tile::RED_BN - 1) / w4tile::RED_BN, (M + w4tile::RED_ROWS - 1) / w4tile::RED_ROWS),
         w4tile::RED_ROWS * 32, 0, st>>>(a);
  return (int)cudaGetLastError();
}
