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
//  * GEMV for M <= 8 rows: one column per thread (a warp reads 128
//    contiguous bytes of words per word row), the units split over the
//    block's 8 warps and the partials summed in shared memory; the x values
//    a word needs are read from global memory (the same address in every
//    lane: a broadcast, L1-resident).
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

#include "w4_tile.cuh"

namespace w4elem {

constexpr int UNIT_ROWS = 64;           // K rows per unit (8 words)
constexpr int GEMV_WARPS = 8;
constexpr int GEMV_THREADS = GEMV_WARPS * 32;

// x[m][base + off .. +1] (two bf16) as floats; zero when the segment is masked
__device__ __forceinline__ void load_x2(const bf16* row, int k, bool on, float& a, float& b) {
  if (!on) {
    a = b = 0.f;
    return;
  }
  const uint32_t raw = __ldg(reinterpret_cast<const unsigned int*>(row + k));
  a = __uint_as_float(raw << 16);
  b = __uint_as_float(raw & 0xffff0000u);
}

template <class Layout>
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_kernel(const bf16* __restrict__ x, int M, int Kx, long long x_stride,
            const uint32_t* __restrict__ packed, const float* __restrict__ scales,
            const float* __restrict__ zeros, int K, int N, int gs, int tk,
            bf16* __restrict__ out) {
  constexpr int MT = 8;
  __shared__ float red[GEMV_WARPS][MT][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const bool col_ok = n < N;
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  const int units = K / UNIT_ROWS;
  for (int u = warp; u < units; u += GEMV_WARPS) {
    int base[4];
    bool on[4];
    typename Layout::Coef coef[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      base[i] = Layout::seg_base(u, i, tk);
      on[i] = base[i] < Kx;
      const size_t gi = (size_t)(base[i] / gs) * N + n;
      coef[i] = Layout::coef(col_ok ? __ldg(scales + gi) : 0.f, col_ok ? __ldg(zeros + gi) : 0.f);
    }
    if (!(on[0] || on[1] || on[2] || on[3])) continue;
    uint32_t words[8];
#pragma unroll
    for (int wl = 0; wl < 8; ++wl)
      words[wl] = col_ok ? __ldg(packed + (size_t)(u * 8 + wl) * N + n) : 0u;
#pragma unroll
    for (int wl = 0; wl < 8; ++wl) {
      float w[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int seg = Layout::stage_index(wl, p) / 16;
        w[p] = Layout::value((words[wl] >> (4 * p)) & 15u, coef[seg]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= M) break;
        const bf16* row = x + (size_t)m * x_stride;
        float xv[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // the nibbles pair_lo(j) and pair_hi(j) of a word hold adjacent K rows
          const int idx = Layout::stage_index(wl, Layout::pair_lo(j));
          const int seg = idx / 16;
          load_x2(row, base[seg] + idx % 16, on[seg], xv[Layout::pair_lo(j)],
                  xv[Layout::pair_hi(j)]);
        }
        float s = 0.f;
#pragma unroll
        for (int p = 0; p < 8; ++p) s += xv[p] * w[p];
        acc[m] += s;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) red[warp][m][lane] = acc[m];
  __syncthreads();
  for (int i = threadIdx.x; i < M * 32; i += GEMV_THREADS) {
    const int m = i / 32, c = i % 32;
    const int nn = blockIdx.x * 32 + c;
    if (nn >= N) continue;
    float y = 0.f;
#pragma unroll
    for (int w = 0; w < GEMV_WARPS; ++w) y += red[w][m][c];
    out[(size_t)m * N + nn] = f2bf(y);
  }
}

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

// x (M, Kx) bf16, row stride x_stride (elements, a multiple of 8, rows 16-byte
// aligned); packed (K/8, N) words in the Layout's order; scales / zeros
// (>= K/gs, N) f32 in the Layout's form; out (M, N) bf16 contiguous; M > 8
// only, the wrapper's plan: xt (Mpad x units x 64) bf16 with Mpad = M
// rounded up to 64, ws (split, M, N) f32 when split > 1.
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
    gemv_kernel<Layout><<<(N + 31) / 32, GEMV_THREADS, 0, st>>>(xb, M, Kx, x_stride, pk, sc, z,
                                                                 K, N, gs, tk, o);
    return (int)cudaGetLastError();
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
