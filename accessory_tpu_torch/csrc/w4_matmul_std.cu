// W4A16 matmul over the std layout (GPTQ / OmniQuant imports).
//
// Replaces: accessory_tpu/ops/quant_matmul_pallas.py::quant_matmul_pallas
// (`_qmm`, Pallas kernel `_kernel`).
//
//   y = x @ bf16((q - z) * s)       f32 accumulation, one cast to bf16
//
// Weight layout: packed (K/8, N) uint32, 8 nibbles per word little-endian
// along K (word w holds rows 8w..8w+7, qtensor.pack_int); scales and zeros
// (K/gs, N) f32, zeros in quantized units and NOT folded: a GPTQ export's
// zero is z + 1, up to 16, so no nibble could hold it. Each weight is
// computed as in the TPU kernel, (q - z) in f32 (exact), times s in f32,
// rounded once to bf16, then multiplied with x in the tensor cores (the
// GEMV's mma.sync, the tile's wgmma). No prologue or epilogue (the TPU
// kernel has none).
//
// The GEMV (M <= 8) and the many-row tile (M > 8) are w4_elem.cuh's and
// w4_tile.cuh's; this file gives them the std row order and value. Bound:
// bytes at decode (0.5 B a weight plus 8 B of scale and zero per column per
// group), operations from ~80 rows on.

#include "w4_elem.cuh"

namespace {

struct StdLayout {
  __device__ static __forceinline__ int seg_base(int u, int i, int) {
    return u * w4elem::UNIT_ROWS + 16 * i;
  }
  // the GEMV and the tile (w4_elem.cuh, w4_tile.cuh): a unit lies in one
  // group (gs % 64 == 0)
  static constexpr int COEF_ROWS = 1;
  static int units(int Kx, int) { return Kx / w4elem::UNIT_ROWS; }
  // slab j of a unit: b0 = rows 16j + 2t, +1 (word row 2j, byte t), b1 = rows
  // 16j + 8 + 2t, +1 (word row 2j + 1, byte t) of columns nb..nb+3; each
  // weight (q - z) * s in f32 with q exact from the float pattern 2^23 + q.
  // The high nibble is read in place as 16 q (2^23 + 16 q) against 16 z and
  // s / 16: scaling by a power of 2 commutes with each rounding, so the
  // product is bit for bit (q - z) * s.
  __device__ static __forceinline__ uint32_t pair(uint32_t w, int t, float s, float z, float s16,
                                                  float z16) {
    const uint32_t v = w >> (8 * t);
    const float q0 = __uint_as_float(w4tile::and_or(v, 0xFu, 0x4B000000u)) - 8388608.f;
    const float q1 = __uint_as_float(w4tile::and_or(v, 0xF0u, 0x4B000000u)) - 8388608.f;
    return pack_bf16x2(__fmul_rn(__fsub_rn(q0, z), s), __fmul_rn(__fsub_rn(q1, z16), s16));
  }
  struct Ctx {
    float s[4], z[4], s16[4], z16[4];
  };
  struct Raw {
    uint4 w0, w1;
  };
  __device__ static __forceinline__ Ctx stage_ctx(const uint32_t*, const float* Cf, int nb, int) {
    const float4 s4 = *reinterpret_cast<const float4*>(Cf + nb);
    const float4 z4 = *reinterpret_cast<const float4*>(Cf + w4tile::BN + nb);
    Ctx c{{s4.x, s4.y, s4.z, s4.w}, {z4.x, z4.y, z4.z, z4.w}, {}, {}};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c.s16[i] = c.s[i] * 0.0625f;
      c.z16[i] = c.z[i] * 16.f;
    }
    return c;
  }
  __device__ static __forceinline__ Raw slab_raw(const uint32_t* Bs, const float*, int nb, int j) {
    return {*reinterpret_cast<const uint4*>(Bs + (2 * j) * w4tile::BN + nb),
            *reinterpret_cast<const uint4*>(Bs + (2 * j + 1) * w4tile::BN + nb)};
  }
  __device__ static __forceinline__ void convert(const Ctx& c, const Raw& r, int, int t,
                                                 uint32_t b[4][2]) {
    const uint32_t a0[4] = {r.w0.x, r.w0.y, r.w0.z, r.w0.w};
    const uint32_t a1[4] = {r.w1.x, r.w1.y, r.w1.z, r.w1.w};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      b[nt][0] = pair(a0[nt], t, c.s[nt], c.z[nt], c.s16[nt], c.z16[nt]);
      b[nt][1] = pair(a1[nt], t, c.s[nt], c.z[nt], c.s16[nt], c.z16[nt]);
    }
  }
  static bool tile_ok(int, int, int) { return true; }
};

}  // namespace

// x (M, Kx) bf16, row stride x_stride; packed (K/8, N) std words; scales /
// zeros (>= K/gs, N) f32; out (M, N) bf16; xt / ws / split: the scratch and
// the K split of M > 8 (ops/w4_tile.py's plan). See w4elem::launch for the shape conditions.
extern "C" int w4_matmul_std(const void* x, int M, int Kx, long long x_stride,
                             const void* packed, const void* scales, const void* zeros, int K,
                             int N, int gs, void* out, void* xt, void* ws, int split,
                             void* stream) {
  return w4elem::launch<StdLayout>(x, M, Kx, x_stride, packed, scales, zeros, K, N, gs, 0, out,
                                   xt, ws, split, stream);
}
