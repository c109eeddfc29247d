// W4A16 matmul over the magic layout (bf16 bit-pattern unpack).
//
// Replaces: accessory_tpu/ops/quant_matmul_magic.py::magic_qmm (Pallas kernel
// `_kernel`).
//
//   y = x @ ((v - z') * s')         bf16 weight arithmetic, f32 accumulation
//
// A nibble q becomes the bf16 value v = 256 + 16 q with no conversion: the
// bit pattern 0x4380 | (q << 3) (exponent 135, mantissa q << 3), the trick of
// the lop3 / magic-number unpacks used by NVIDIA's own int4 kernels. The
// affine map is folded into the constants at repack time: s' = s / 16 and
// z' = 256 + 16 z, so (v - z') * s' = (q - z) * s. As in the TPU kernel, s'
// and z' are rounded to bf16 and the subtraction and the product are bf16
// operations (v - z' is an exact multiple of 16; the product rounds once), so
// the weight can differ from the f32-scale kernels' by the rounding of s'.
//
// Weight layout (repack_for_magic): per K tile of tk rows, word w of the
// tile holds at nibble i + 4h the tile's row i * tk/4 + 2w + h. The kernel
// reads the words as stored: a unit of 8 word rows gives four 16-row
// segments, one from each quarter of its tile (w4_elem.cuh), so a stage of 64
// rows is whole and the tile order never has to be undone in memory; in the
// GEMV and the many-row tile a nibble pair (j, j + 4) of a word is two
// adjacent K rows, one bf16x2 register of an m16n8k16 fragment as it
// stands. Requires tk % 4 == 0, (tk / 4) % gs == 0 and K % tk == 0.
//
// Bound: bytes at decode, operations from ~80 rows on (as w4_matmul_std.cu).

#include "w4_elem.cuh"

namespace {

struct MagicLayout {
  __device__ static __forceinline__ int seg_base(int u, int i, int tk) {
    const int per_tile = tk / w4elem::UNIT_ROWS;
    const int tile = u / per_tile, s = u % per_tile;
    return tile * tk + i * (tk / 4) + 16 * s;
  }
  // the GEMV and the tile: one coefficient row per segment (quarter)
  static constexpr int COEF_ROWS = 4;
  static int units(int Kx, int tk) { return (Kx + tk - 1) / tk * (tk / w4elem::UNIT_ROWS); }
  // slab j of a unit is segment j: b0 = its rows 2t, 2t + 1 (word row t,
  // nibbles j and j + 4), b1 = rows 8 + 2t, 9 + 2t (word row t + 4) of
  // columns nb..nb+3; the weight (v - z') * s' in bf16x2 arithmetic
  __device__ static __forceinline__ uint32_t pair(uint32_t w, int j, __nv_bfloat162 s,
                                                  __nv_bfloat162 z) {
    const uint32_t v = w4tile::and_or(j == 0 ? w << 3 : w >> (4 * j - 3), 0x00780078u, 0x43804380u);
    return w4tile::bf162_bits(__hmul2(__hsub2(w4tile::bits_bf162(v), z), s));
  }
  struct Ctx {
    uint4 w0, w1;   // word rows t and t + 4 of the unit
  };
  struct Raw {
    float4 s, z;    // segment j's coefficients
  };
  __device__ static __forceinline__ Ctx stage_ctx(const uint32_t* Bs, const float*, int nb, int t) {
    return {*reinterpret_cast<const uint4*>(Bs + t * w4tile::BN + nb),
            *reinterpret_cast<const uint4*>(Bs + (t + 4) * w4tile::BN + nb)};
  }
  __device__ static __forceinline__ Raw slab_raw(const uint32_t*, const float* Cf, int nb, int j) {
    return {*reinterpret_cast<const float4*>(Cf + j * w4tile::BN + nb),
            *reinterpret_cast<const float4*>(Cf + (COEF_ROWS + j) * w4tile::BN + nb)};
  }
  __device__ static __forceinline__ void convert(const Ctx& c, const Raw& r, int j, int,
                                                 uint32_t b[4][2]) {
    const uint32_t a0[4] = {c.w0.x, c.w0.y, c.w0.z, c.w0.w};
    const uint32_t a1[4] = {c.w1.x, c.w1.y, c.w1.z, c.w1.w};
    const float s[4] = {r.s.x, r.s.y, r.s.z, r.s.w}, z[4] = {r.z.x, r.z.y, r.z.z, r.z.w};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const __nv_bfloat162 s2 = __float2bfloat162_rn(s[nt]), z2 = __float2bfloat162_rn(z[nt]);
      b[nt][0] = pair(a0[nt], j, s2, z2);
      b[nt][1] = pair(a1[nt], j, s2, z2);
    }
  }
  static bool tile_ok(int K, int gs, int tk) {
    return tk > 0 && tk % 4 == 0 && (tk / 4) % gs == 0 && K % tk == 0;
  }
};

}  // namespace

// x (M, Kx) bf16, row stride x_stride; packed (K/8, N) magic words of tile
// tk; scales (>= K/gs, N) f32 holding s / 16, zeros_plus the same holding
// 256 + 16 z; out (M, N) bf16; xt / ws / split: the scratch and the K split
// of M > 8 (ops/w4_tile.py's plan). See w4elem::launch for the shape conditions.
extern "C" int w4_matmul_magic(const void* x, int M, int Kx, long long x_stride,
                               const void* packed, const void* scales, const void* zeros_plus,
                               int K, int N, int gs, int tk, void* out, void* xt, void* ws,
                               int split, void* stream) {
  return w4elem::launch<MagicLayout>(x, M, Kx, x_stride, packed, scales, zeros_plus, K, N, gs,
                                     tk, out, xt, ws, split, stream);
}
