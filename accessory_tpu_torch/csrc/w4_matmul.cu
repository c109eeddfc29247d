// W4A16 matmul with fused RMSNorm prologue, RoPE epilogue and residual add.
//
// Replaces: accessory_tpu/ops/quant_matmul_planes.py::planes_qmm (Pallas
// kernel `_kernel`, with `_accum_tile` and the `rotate_lanes` epilogue).
//
//   y = [rms_norm(x)] @ (q * s - zs)  [RoPE on column pairs]  [+ residual]
//
// Weight layout (the port's "folded" layout): packed (K/8, N) uint32 with 8
// 4-bit values per word, little-endian along K (word row w holds k = 8w..8w+7);
// scales and zs = zeros * scales are (K/gs, N) f32. The zero point is folded
// out as in the TPU kernel: per group g,
//   y += s_g * (x_g . q_g) - zs_g * sum(x_g)
// with the group product accumulated in f32 over exact integer q.
//
// Bound on the H100: at decode (M <= 16) the call is a GEMV that must stream
// K*N/2 bytes of nibbles plus 8*N*K/gs bytes of scales and zs, so it is
// bound by memory bytes. That path is qgemv.cuh's tensor-core GEMV with the
// folded policy: exact q in bf16 as mma.sync's A operand, a per-group f32
// accumulator folded into the output at the group's end (a K split that
// cuts a group folds each rank's part), the RMSNorm's sum of squares summed
// over the cluster, RoPE and the residual in its epilogue. It takes 12.7 us
// for TinyLlama's w13 at M = 8 and 34.5 for 7B's (torch.matmul on the dense
// weight 17.3 / 60.1) on an NVIDIA H100 80GB HBM3, 700.00 W. The GEMV it
// replaces gave each thread one output column and did f32 FMAs on the CUDA
// cores behind an int -> float convert a nibble, its time growing with M:
// 40.2 / 121.3 us on the same shapes and card. PERF.md, row 1, holds both
// designs' times, measured by chip_smoke.py.
//
// For prefill rows (16 < M < 1024) the work does about 3.6 * M flops per
// weight byte (nibbles plus f32 scales and zs, group 128), so from M ~ 83 on
// (the card's ~295 bf16 flops per byte) it is bound by operations, as the
// main path's M = 512 prefill is. That path is the many-row tile of
// w4_tile.cuh with the folded policy below, three or four device passes
// inside one C call (one counted launch):
//  1. with a norm, rms_kernel: 1 / rms of each row over its Kx columns;
//  2. prep_kernel: the normalized x rounded to bf16 (or x), its 8-column
//     chunks reordered for the nibble pairs and tiled in the order the
//     stages copy it, into the wrapper's scratch, and sum(x) per group (the
//     folded zero point's factor), so no tile block re-reads whole rows (the
//     replaced tile read each row N / 128 times for its norm);
//  3. the tile: 64 rows x 128 columns a warpgroup, exact q in bf16 from the
//     bit pattern 0x4300 | q (a shift, one lop3 and one bf16x2 subtraction
//     a pair; no int -> float convert) as wgmma's register operand, a
//     per-group f32 accumulator folded into the output at each group's end;
//  4. where the output tiles are too few to fill the card (wo, wqkv, w2 and
//     wk/wv at 128-512 rows) the wrapper's plan (ops/w4_tile.py) splits K
//     over blocks in whole groups, and the reduction pass sums the partials
//     in split order, then runs the epilogue once.
// The replaced tile (mma.sync, 64 x 128) spent ~3.5 us per 64-deep K step:
// 303.3 us for w2 at M = 128 and 361.1 for w13 at M = 512 on an NVIDIA H100
// 80GB HBM3, 700.00 W; PERF.md, row 1, holds this design's times.
//
// The normalized x is rounded to bf16 before the product and RoPE runs in
// f32 before the output cast, then the residual is added in bf16, the same
// op order as the TPU kernel. The N tile holds whole heads so each column's
// RoPE partner (n^1 interleaved, n +- hd/2 half) is in the same block.

#include "qgemv.cuh"

namespace {

// The folded weight operand of w4_tile.cuh: exact q. The row-prep pass
// stores x with each 8-column chunk in the order (0, 4, 1, 5, 2, 6, 3, 7), so
// in slab j of a stage b0 holds K rows 16j + t and 16j + t + 4 (word row 2j,
// nibbles t and t + 4: one shift and one mask make the bf16 pair) and b1
// the same of word row 2j + 1, for the thread's four columns nb..nb+3.
struct FoldedB {
  static constexpr int COEF_ROWS = 1;   // scales and zs of the stage's group
  static constexpr bool FOLDED = true;
  static constexpr bool PAIRED = true;    // the row prep stores x in nibble-pair order
  struct Ctx {};
  struct Raw {
    uint4 w0, w1;
  };
  __device__ static __forceinline__ int unit_base(int step, int) { return step * w4tile::BK; }
  __device__ static __forceinline__ int chunk_off(int c, int) { return 8 * c; }
  __device__ static __forceinline__ int coef_stride(int, int) { return 0; }
  __device__ static __forceinline__ Ctx stage_ctx(const uint32_t*, const float*, int, int) {
    return {};
  }
  __device__ static __forceinline__ Raw slab_raw(const uint32_t* Bs, const float*, int nb, int j) {
    return {*reinterpret_cast<const uint4*>(Bs + (2 * j) * w4tile::BN + nb),
            *reinterpret_cast<const uint4*>(Bs + (2 * j + 1) * w4tile::BN + nb)};
  }
  __device__ static __forceinline__ void convert(const Ctx&, const Raw& r, int, int t,
                                                 uint32_t b[4][2]) {
    const uint32_t a0[4] = {r.w0.x, r.w0.y, r.w0.z, r.w0.w};
    const uint32_t a1[4] = {r.w1.x, r.w1.y, r.w1.z, r.w1.w};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      b[nt][0] = w4tile::q_pair(a0[nt], t);
      b[nt][1] = w4tile::q_pair(a1[nt], t);
    }
  }
};

}  // namespace

// rope_style: 0 none, 1 interleaved, 2 half. norm/residual/cos/sin may be null.
// Requires Kx % gs == 0, gs % 64 == 0, 16-byte aligned x rows; N % 64 == 0
// (a last 128-column tile of 64 columns is bounded: Falcon-7B's dense_4h_to_h,
// N 4544); half-style heads that divide 128.
// gate (M <= 16 only): null, or an int on the card; where it holds 0 the
// launch writes zeros to out and reads no weight byte (the MoE FFN's skip of
// an expert no row chose, decided on the card, so a captured decode step
// needs no host read of the routing).
// split: for M <= 16 the GEMV's cluster (1 .. 8 blocks over 64-row units,
// ops/w4_tile.py folded_gemv_split; no scratch); for M > 16 the tile's K
// splits, whole groups each, with the scratch the wrapper allocates by the
// plan of ops/w4_tile.py: xsum (Kx/gs + 1, Mpad) f32 and xt (Mpad x Kx) bf16
// (the prepared x) with Mpad = M rounded up to 64; ws (split, M, N) f32 when
// split > 1.
extern "C" int w4_matmul(const void* x, int M, int Kx, int x_stride, const void* packed,
                         const void* scales, const void* zs, int N, int gs,
                         const void* norm, float eps, const void* residual,
                         const void* cos_row, const void* sin_row, int rope_style,
                         int rope_hd, void* out, const void* gate, void* xsum, void* xt,
                         void* ws, int split, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const uint32_t* pk = static_cast<const uint32_t*>(packed);
  const float* sc = static_cast<const float*>(scales);
  const float* z = static_cast<const float*>(zs);
  const float* nw = static_cast<const float*>(norm);
  const bf16* res = static_cast<const bf16*>(residual);
  const float* cr = static_cast<const float*>(cos_row);
  const float* sr = static_cast<const float*>(sin_row);
  bf16* o = static_cast<bf16*>(out);
  if (M <= 0 || Kx % gs != 0 || gs % 64 != 0) return (int)cudaErrorInvalidValue;
  if (M <= 16) {
    qgemv::Args g{xb, x_stride, M, Kx, pk, sc, z, N, gs, nw, eps, res, cr, sr, rope_style,
                  rope_hd, o, Kx / qgemv::UNIT, static_cast<const int*>(gate)};
    const bool aligned = ((reinterpret_cast<uintptr_t>(pk) | reinterpret_cast<uintptr_t>(sc) |
                           reinterpret_cast<uintptr_t>(z)) & 15) == 0;
    if (N % 64 != 0) return (int)cudaErrorInvalidValue;
    return (int)qgemv::launch<qgemv::W4Folded>(g, split, aligned ? 16 : 4, st);
  }
  if (gate != nullptr) return (int)cudaErrorInvalidValue;   // the GEMV's alone
  if (N % 64 != 0 || (rope_style == 2 && w4tile::RED_BN % rope_hd != 0) || split < 1 ||
      xsum == nullptr || xt == nullptr || (split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  w4tile::TileArgs a{};
  a.x = xb;
  a.x_stride = x_stride;
  a.M = M;
  a.Kx = Kx;
  a.xt = static_cast<bf16*>(xt);
  a.norm = nw;
  a.eps = eps;
  a.packed = pk;
  a.scales = sc;
  a.zs = z;
  a.xsum = static_cast<float*>(xsum);
  a.N = N;
  a.gs = gs;
  a.tk = 0;
  a.Mpad = (M + w4tile::BM - 1) / w4tile::BM * w4tile::BM;
  a.granules = Kx / gs;
  a.granule_steps = gs / w4tile::BK;
  a.split = split;
  a.ws = static_cast<float*>(ws);
  a.out = o;
  a.residual = res;
  a.cos_row = cr;
  a.sin_row = sr;
  a.rope_style = rope_style;
  a.rope_hd = rope_hd;
  return (int)w4tile::launch<FoldedB>(a, st);
}
