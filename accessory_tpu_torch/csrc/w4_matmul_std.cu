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
// rounded once to bf16, then multiplied with x in the tensor cores or the
// GEMV's f32 FMAs. No prologue or epilogue (the TPU kernel has none).
//
// The GEMV (M <= 8) and the mma.sync tile (M > 8) are w4_elem.cuh's; this
// file gives them the std row order and value. Bound: bytes at decode
// (0.5 B a weight plus 8 B of scale and zero per column per group),
// operations from ~80 rows on.

#include "w4_elem.cuh"

namespace {

struct StdLayout {
  struct Coef {
    float s, z;
  };
  __device__ static __forceinline__ Coef coef(float s, float z) { return {s, z}; }
  // nibble p of a unit's word wl holds the unit's row 8 * wl + p
  __device__ static __forceinline__ int stage_index(int wl, int p) { return 8 * wl + p; }
  __device__ static __forceinline__ int pair_lo(int j) { return 2 * j; }
  __device__ static __forceinline__ int pair_hi(int j) { return 2 * j + 1; }
  __device__ static __forceinline__ int seg_base(int u, int i, int) {
    return u * w4elem::UNIT_ROWS + 16 * i;
  }
  __device__ static __forceinline__ float value(uint32_t q, Coef c) {
    return round_bf16(__fmul_rn((float)q - c.z, c.s));
  }
  __device__ static __forceinline__ void store_word(bf16* col, int wl, const bf16 v[8]) {
    uint4 u;
    u.x = pack_bf16_pair(v[0], v[1]);
    u.y = pack_bf16_pair(v[2], v[3]);
    u.z = pack_bf16_pair(v[4], v[5]);
    u.w = pack_bf16_pair(v[6], v[7]);
    *reinterpret_cast<uint4*>(col + 8 * wl) = u;
  }
  static bool tile_ok(int, int, int) { return true; }
};

}  // namespace

// x (M, Kx) bf16, row stride x_stride; packed (K/8, N) std words; scales /
// zeros (>= K/gs, N) f32; out (M, N) bf16. See w4elem::launch for the shape
// conditions.
extern "C" int w4_matmul_std(const void* x, int M, int Kx, long long x_stride,
                             const void* packed, const void* scales, const void* zeros, int K,
                             int N, int gs, void* out, void* stream) {
  return w4elem::launch<StdLayout>(x, M, Kx, x_stride, packed, scales, zeros, K, N, gs, 0, out,
                                   stream);
}
