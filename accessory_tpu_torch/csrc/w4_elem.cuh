// W4A16 products whose weight is dequantized element by element and rounded
// to bf16 before the product: the std layout (w4_matmul_std.cu) and the
// magic layout (w4_matmul_magic.cu) share this body and differ only in a
// Layout policy (where a nibble's K row lies, and how a value is computed).
//
//   y = x @ bf16(w(q, s, z))        f32 accumulation over all of K, one cast
//
// Both layouts pack 8 nibbles per 32-bit word along K: packed (K/8, N). The
// work is cut into units of 8 word rows (64 K rows) of a column. A unit's 64
// rows are four segments of 16 consecutive K rows: for std the unit's rows in
// order (segment i = rows u*64 + 16i ..), for magic one 16-row slice of each
// quarter of the unit's K tile (the magic words of a tile hold rows i*tk/4 +
// 2w + h at nibble i + 4h). A segment never straddles a quantization group
// (groups are multiples of 64 rows, and the magic tile's quarter a multiple
// of the group), so each segment has one (scale, zero) per column. Segments
// at or past Kx (a padded in_dim) read zero activations.
//
// Two shapes:
//  * GEMV for M <= 8 rows (decode), on the tensor cores. The product is
//    computed transposed, y^T = w^T x^T, with mma.sync m16n8k16: the
//    dequantized weight is the A operand (16 weight columns x 16 K rows, the
//    same register fragments ElemB gives the many-row tile), x's rows padded
//    to 8 are the B operand, so the M dimension costs nothing. A block is
//    one warpgroup over 128 columns (a warp 32); its units arrive through a
//    ring of GEMV_STAGES stages filled by every thread's 16-byte cp.async
//    pieces (8 word rows and the unit's scale / zero rows: 35 KB in flight
//    for std, 56 KB for magic), and each thread reads the x pairs of its
//    fragments straight from global memory (x is a few KB, L1- and
//    L2-resident), following the Layout's segment order. K is split over
//    the blocks of a cluster (gridDim.y = split <= 8, the wrapper's plan,
//    ops/w4_tile.py gemv_split, fitted to a sweep of every split); the
//    blocks' 8 x 128 partial tiles are summed through distributed shared
//    memory, each rank a share of the columns, every element in rank order:
//    one launch, no workspace, no atomics, bit-equal across launches. Its time barely grows with M, and
//    a build without the dequant (stripped, not kept) was little faster:
//    the weight stream sets it: 16.0 / 16.4 us (std / magic) for
//    TinyLlama's w13 at M = 8 and 47.3 / 48.4 for 7B's on an NVIDIA H100
//    80GB HBM3, 700.00 W, 3-4x the bytes bound, under torch.matmul on the
//    dense weight. The GEMV it replaces read every x value of
//    every row for every word from global memory and did 8 f32 FMAs a
//    weight and row on the CUDA cores behind a per-nibble dequant, one
//    4-byte word a thread and (N + 31) / 32 blocks: 73.8 / 78.5 us (std / magic) for TinyLlama's
//    w13 at M = 8 and 298.1 / 290.1 for 7B's on an NVIDIA H100 80GB HBM3,
//    700.00 W, its time growing with M. PERF.md rows 24 / 25 hold both
//    designs' times, measured by chip_smoke.py.
//  * M > 8: the many-row mainloop of w4_tile.cuh with the ElemB policy
//    below (64 x 128 tiles, one warpgroup, wgmma with the weight as its
//    register operand): the row-prep pass tiles x in the unit's segment
//    order, a stage (a unit) arrives by bulk copies (the x tile, the raw
//    words, the unit's scales / zeros), each weight is computed by the
//    Layout in registers just before its product (std: f32 (q - z) * s from
//    the bit pattern 0x4B000000 | q, no int -> float convert; magic: the
//    bf16 pattern 0x4380 | q << 3 and two bf16x2 operations), and K is split
//    over blocks where the tiles are too few for the card (the wrapper's
//    plan, ops/w4_tile.py; the reduction pass sums the splits in order).
//    The replaced tile (mma.sync, 128 x 128) dequantized a unit into shared
//    memory behind one register prefetch, spilled (224 bytes of stack), and
//    took 234.9 / 272.6 us (std / magic) for TinyLlama's w13 at M = 512 on
//    an NVIDIA H100 80GB HBM3, 700.00 W; PERF.md rows 24 / 25 hold this
//    design's times.
//
// Bound on the H100: bytes at decode (K*N/2 bytes of nibbles plus 8 bytes of
// f32 scale and zero per column per group), operations from M ~ 80 rows.

#pragma once

#include <cooperative_groups.h>

#include "w4_tile.cuh"

namespace w4elem {

constexpr int UNIT_ROWS = 64;           // K rows per unit (8 words)
constexpr int GEMV_BN = w4tile::BN;     // columns a GEMV block: 4 warps of 32
constexpr int GEMV_THREADS = GEMV_BN;
constexpr int GEMV_STAGES = 8;
constexpr int GEMV_MAX_SPLIT = 8;       // blocks of a cluster (the portable most)

// The elem weight operand of w4_tile.cuh: a unit a stage; the Layout places the
// segments (seg_base), gives COEF_ROWS coefficient rows a unit (1 for std,
// whose unit lies in one group; 4 for magic, one a segment) and computes
// the bf16 fragments (stage_ctx, slab_raw, convert).
template <class Layout>
struct ElemB {
  static constexpr int COEF_ROWS = Layout::COEF_ROWS;
  static constexpr bool FOLDED = false;
  __device__ static __forceinline__ int unit_base(int step, int tk) {
    return Layout::seg_base(step, 0, tk);
  }
  // chunk c: segment c / 2, its half c % 2
  __device__ static __forceinline__ int chunk_off(int c, int tk) {
    return Layout::seg_base(0, c >> 1, tk) + 8 * (c & 1);
  }
  // segments of a unit lie a fixed distance apart (std 16 rows, one group;
  // magic a quarter of the tile, a whole number of groups)
  __device__ static __forceinline__ int coef_stride(int gs, int tk) {
    return (Layout::seg_base(0, 1, tk) - Layout::seg_base(0, 0, tk)) / gs;
  }
  using Ctx = typename Layout::Ctx;
  using Raw = typename Layout::Raw;
  __device__ static __forceinline__ Ctx stage_ctx(const uint32_t* Bs, const float* Cf, int nb,
                                                  int t) {
    return Layout::stage_ctx(Bs, Cf, nb, t);
  }
  __device__ static __forceinline__ Raw slab_raw(const uint32_t* Bs, const float* Cf, int nb,
                                                 int j) {
    return Layout::slab_raw(Bs, Cf, nb, j);
  }
  __device__ static __forceinline__ void convert(const Ctx& c, const Raw& r, int j, int t,
                                                 uint32_t b[4][2]) {
    Layout::convert(c, r, j, t, b);
  }
};

struct GemvArgs {
  const bf16* x;
  long long x_stride;
  int M, Kx;
  const uint32_t* packed;
  const float* scales;
  const float* zeros;
  int N, gs, tk;
  int units;                   // 64-row units of K the GEMV walks (Layout::units)
  bf16* out;
};

template <class Layout>
struct GemvShape {
  static constexpr int ROWS = 8 + 2 * Layout::COEF_ROWS;   // 512-byte rows a stage
  static constexpr int B_BYTES = 8 * GEMV_BN * 4;
  static constexpr int STAGE_BYTES = ROWS * GEMV_BN * 4;
  static constexpr int SMEM = GEMV_STAGES * STAGE_BYTES;   // also the 8 x 128 f32 partials
  static_assert(SMEM >= 8 * GEMV_BN * 4, "the ring holds the partial tile");
};

// y^T (128 columns x 8 rows) of one block over the units of its K split.
// Thread (g, t) of warp w holds, as ElemB gives them, the weight columns
// nb = 32 w + 4 g .. nb + 3: mma i's A rows g and g + 8 are the columns
// nb + 2i and nb + 2i + 1; its B column g is x row g (k pairs 2t and
// 8 + 2t of each 16-row segment), its D columns 2t, 2t + 1 are x rows.
template <class Layout>
__global__ void __launch_bounds__(GEMV_THREADS) gemv_kernel(const GemvArgs a) {
  using P = ElemB<Layout>;
  using S = GemvShape<Layout>;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * GEMV_BN;
  const int rank = blockIdx.y, split = gridDim.y;   // the cluster spans the split
  const int u0 = (int)((long long)rank * a.units / split);
  const int nunits = (int)((long long)(rank + 1) * a.units / split) - u0;
  const int cstride = P::coef_stride(a.gs, a.tk);

  // every thread: its 16-byte pieces of a unit's 8 word rows and coefficient
  // rows (scales, then zeros) into a ring slot, columns past N as zeros; one
  // commit group a unit (empty past the last)
  auto load_stage = [&](int it) {
    if (it < nunits) {
      const int u = u0 + it;
      unsigned char* st = smem + (it % GEMV_STAGES) * S::STAGE_BYTES;
      const int g0 = P::unit_base(u, a.tk) / a.gs;
      for (int c = tid; c < S::ROWS * (GEMV_BN / 4); c += GEMV_THREADS) {
        const int r = c / (GEMV_BN / 4), n = n0 + 4 * (c % (GEMV_BN / 4));
        const int cr = r - 8;   // coefficient row: scales 0 .., zeros COEF_ROWS ..
        const void* src =
            r < 8 ? static_cast<const void*>(a.packed + (size_t)(u * 8 + r) * a.N + n)
                  : static_cast<const void*>(
                        (cr < P::COEF_ROWS ? a.scales : a.zeros) +
                        (size_t)(g0 + (cr % P::COEF_ROWS) * cstride) * a.N + n);
        cp_async<16>(st + c * 16, n < a.N ? src : a.packed, n < a.N ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < GEMV_STAGES - 1; ++s) load_stage(s);

  const int nb = 32 * warp + 4 * g;
  const bf16* xrow = a.x + (size_t)g * a.x_stride;   // read only for g < M
  const bool row_ok = g < a.M;
  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int it = 0; it < nunits; ++it) {
    const int u = u0 + it;
    // x row g's pairs for the unit's four segments (B fragments); segments
    // at or past Kx read zero
    uint32_t xb[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int base = Layout::seg_base(u, j, a.tk);
      const bool on = row_ok && base < a.Kx;
      const unsigned int* xp = reinterpret_cast<const unsigned int*>(xrow + base + 2 * t);
      xb[j][0] = on ? __ldg(xp) : 0u;
      xb[j][1] = on ? __ldg(xp + 4) : 0u;
    }
    cp_async_wait<GEMV_STAGES - 2>();   // this thread's pieces of unit it landed
    __syncthreads();   // everyone's; every warp is done with unit it - 1: refill its slot
    load_stage(it + GEMV_STAGES - 1);
    const unsigned char* st = smem + (it % GEMV_STAGES) * S::STAGE_BYTES;
    const uint32_t* Bs = reinterpret_cast<const uint32_t*>(st);
    const float* Cf = reinterpret_cast<const float*>(st + S::B_BYTES);
    const auto ctx = P::stage_ctx(Bs, Cf, nb, t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {   // segment j: one 16-deep slab
      uint32_t b[4][2];
      P::convert(ctx, P::slab_raw(Bs, Cf, nb, j), j, t, b);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t af[4] = {b[2 * i][0], b[2 * i + 1][0], b[2 * i][1], b[2 * i + 1][1]};
        mma_bf16_16816(acc[i], af, xb[j][0], xb[j][1]);
      }
    }
  }

  // the block's partial tile [x row][column] in the (now idle) ring, then
  // the ranks sum the cluster's tiles
  cp_async_wait<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = nb + 2 * i;
    part[(2 * t) * GEMV_BN + c] = acc[i][0];
    part[(2 * t + 1) * GEMV_BN + c] = acc[i][1];
    part[(2 * t) * GEMV_BN + c + 1] = acc[i][2];
    part[(2 * t + 1) * GEMV_BN + c + 1] = acc[i][3];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every block's partial tile is written
  // every rank sums its share of the tile, 4 columns a thread, over the
  // ranks' partials in rank order (the same order whichever rank sums)
  for (int q = rank * GEMV_THREADS + tid; q < a.M * (GEMV_BN / 4); q += split * GEMV_THREADS) {
    const int m = q / (GEMV_BN / 4), c = 4 * (q % (GEMV_BN / 4)), n = n0 + c;
    if (n >= a.N) continue;
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < split; ++r) {
      const float4 p =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r) + m * GEMV_BN + c);
      y.x += p.x;
      y.y += p.y;
      y.z += p.z;
      y.w += p.w;
    }
    uint2 o;
    o.x = pack_bf16x2(y.x, y.y);
    o.y = pack_bf16x2(y.z, y.w);
    *reinterpret_cast<uint2*>(a.out + (size_t)m * a.N + n) = o;
  }
  cluster.sync();   // the partial tiles outlive the other ranks' reads
}

// x (M, Kx) bf16, row stride x_stride (elements, a multiple of 8, rows 16-byte
// aligned); packed (K/8, N) words in the Layout's order; scales / zeros
// (>= K/gs, N) f32 in the Layout's form, all three 16-byte aligned (the
// bulk copies); out (M, N) bf16 contiguous. split: the K split of the
// wrapper's plan (ops/w4_tile.py): for M <= 8 the GEMV's cluster (1 ..
// GEMV_MAX_SPLIT blocks, no scratch), for M > 8 the tile's, with xt (Mpad x
// units x 64) bf16, Mpad = M rounded up to 64, and ws (split, M, N) f32
// when split > 1.
// Requires K % 64 == 0, gs % 64 == 0, Kx % 64 == 0, Kx <= K, N % 8 == 0, and
// the Layout's own conditions on tk.
template <class Layout>
int launch(const void* x, int M, int Kx, long long x_stride, const void* packed,
           const void* scales, const void* zeros, int K, int N, int gs, int tk, void* out,
           void* xt, void* ws, int split, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || K % UNIT_ROWS != 0 || gs % UNIT_ROWS != 0 || Kx <= 0 ||
      Kx % UNIT_ROWS != 0 || Kx > K || N <= 0 || N % 8 != 0 || !Layout::tile_ok(K, gs, tk))
    return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const uint32_t* pk = static_cast<const uint32_t*>(packed);
  const float* sc = static_cast<const float*>(scales);
  const float* z = static_cast<const float*>(zeros);
  bf16* o = static_cast<bf16*>(out);
  if (M <= 8) {
    const GemvArgs g{xb, x_stride, M, Kx, pk, sc, z, N, gs, tk, Layout::units(Kx, tk), o};
    if (split < 1 || split > GEMV_MAX_SPLIT || split > g.units) return (int)cudaErrorInvalidValue;
    using S = GemvShape<Layout>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        gemv_kernel<Layout>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (attr != cudaSuccess) return (int)attr;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((N + GEMV_BN - 1) / GEMV_BN, split, 1);
    cfg.blockDim = dim3(GEMV_THREADS, 1, 1);
    cfg.dynamicSmemBytes = S::SMEM;
    cfg.stream = st;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = 1;
    cluster[0].val.clusterDim.y = split;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, gemv_kernel<Layout>, g);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
  }
  if (split < 1 || xt == nullptr || (split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  w4tile::TileArgs a{};
  a.x = xb;
  a.x_stride = x_stride;
  a.M = M;
  a.Kx = Kx;
  a.xt = static_cast<bf16*>(xt);
  a.Mpad = (M + w4tile::BM - 1) / w4tile::BM * w4tile::BM;
  a.packed = pk;
  a.scales = sc;
  a.zs = z;
  a.N = N;
  a.gs = gs;
  a.tk = tk;
  a.granules = Layout::units(Kx, tk);
  a.granule_steps = 1;
  a.split = split;
  a.ws = static_cast<float*>(ws);
  a.out = o;
  return (int)w4tile::launch<ElemB<Layout>>(a, st);
}

}  // namespace w4elem
