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
// K*N/2 bytes of nibbles plus 8*N*K/gs bytes of scales, so it is bound by
// memory bytes. The GEMV path gives each thread one output column so a warp
// reads 128 contiguous bytes of packed words per K row; the K range is split
// over the block's warps (one group per warp per chunk) so even 2048-wide
// outputs keep 16 warps of loads in flight per block, and the split partials
// are reduced in shared memory. x is staged (normalized, bf16-rounded) in
// shared memory once per block and read back as broadcasts.
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

#include <algorithm>

#include "common.cuh"
#include "w4_tile.cuh"

namespace {

constexpr int GEMV_THREADS = 512;

template <int MT>
__global__ void __launch_bounds__(GEMV_THREADS)
w4_gemv_kernel(const bf16* __restrict__ x, int M, int Kx, int x_stride,
               const uint32_t* __restrict__ packed, const float* __restrict__ scales,
               const float* __restrict__ zs, int N, int gs,
               const float* __restrict__ norm, float eps,
               const bf16* __restrict__ residual,
               const float* __restrict__ cos_row, const float* __restrict__ sin_row,
               int rope_style, int rope_hd, int BN, bf16* __restrict__ out) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int KS = blockDim.x / BN;  // K splits per block
  const int c = tid % BN, ks = tid / BN;
  const int n = blockIdx.x * BN + c;
  const int chunk_k = KS * gs;
  const int big = max(MT * chunk_k, KS * MT * BN);
  float* xs = smem;                 // [MT][chunk_k] staged x, one chunk
  float* red = smem;                // [KS][MT][BN] split partials (after the K loop)
  float* xsum = smem + big;         // [MT][KS] per-group sums of staged x
  float* rinv = xsum + MT * KS;     // [MT] 1 / rms

  if (norm != nullptr) {
    for (int m = warp; m < MT; m += nwarps) {
      float ss = 0.f;
      if (m < M) {
        const bf16* row = x + (size_t)m * x_stride;
        for (int k = lane * 8; k < Kx; k += 256) {
          uint4 raw = *reinterpret_cast<const uint4*>(row + k);
          const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float f = bf2f(v[j]);
            ss += f * f;
          }
        }
      }
      ss = warp_sum(ss);
      if (lane == 0) rinv[m] = 1.f / sqrtf(ss / (float)Kx + eps);
    }
  }

  float part[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) part[m] = 0.f;

  const int G = Kx / gs;
  const int wpg = gs / 8;  // packed words per group (a multiple of 8)
  for (int g0 = 0; g0 < G; g0 += KS) {
    const int ng = min(KS, G - g0);
    __syncthreads();
    const int vecs = ng * gs / 8;
    for (int i = tid; i < MT * vecs; i += blockDim.x) {
      const int m = i / vecs, v8 = i % vecs;
      const int k = g0 * gs + v8 * 8;
      float f[8];
      if (m < M) {
        uint4 raw = *reinterpret_cast<const uint4*>(x + (size_t)m * x_stride + k);
        const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = bf2f(v[j]);
        if (norm != nullptr) {
          const float r = rinv[m];
#pragma unroll
          for (int j = 0; j < 8; ++j) f[j] = round_bf16((f[j] * r) * norm[k + j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = 0.f;
      }
      float4* dst = reinterpret_cast<float4*>(xs + m * chunk_k + v8 * 8);
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    __syncthreads();
    for (int i = warp; i < MT * ng; i += nwarps) {
      const int m = i / ng, gg = i % ng;
      const float* src = xs + m * chunk_k + gg * gs;
      float s = 0.f;
      for (int k = lane; k < gs; k += 32) s += src[k];
      s = warp_sum(s);
      if (lane == 0) xsum[m * KS + gg] = s;
    }
    __syncthreads();
    if (ks < ng) {
      const int g = g0 + ks;
      const uint32_t* wp = packed + (size_t)g * wpg * N + n;
      const float* xg = xs + ks * gs;
      float acc[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m] = 0.f;
      for (int w0 = 0; w0 < wpg; w0 += 8) {
        uint32_t words[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) words[u] = __ldg(wp + (size_t)(w0 + u) * N);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const uint32_t wd = words[u];
          float q[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) q[j] = (float)((wd >> (4 * j)) & 15u);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float4 xa = *reinterpret_cast<const float4*>(xg + m * chunk_k + (w0 + u) * 8);
            const float4 xb = *reinterpret_cast<const float4*>(xg + m * chunk_k + (w0 + u) * 8 + 4);
            acc[m] += xa.x * q[0] + xa.y * q[1] + xa.z * q[2] + xa.w * q[3] +
                      xb.x * q[4] + xb.y * q[5] + xb.z * q[6] + xb.w * q[7];
          }
        }
      }
      const float s = scales[(size_t)g * N + n], z = zs[(size_t)g * N + n];
#pragma unroll
      for (int m = 0; m < MT; ++m) part[m] += s * acc[m] - z * xsum[m * KS + ks];
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m) red[(ks * MT + m) * BN + c] = part[m];
  __syncthreads();
  if (ks == 0) {
    for (int m = 0; m < MT; ++m) {
      float y = 0.f;
      for (int kk = 0; kk < KS; ++kk) y += red[(kk * MT + m) * BN + c];
      red[m * BN + c] = y;
    }
  }
  __syncthreads();
  if (ks == 0) {
    for (int m = 0; m < M && m < MT; ++m) {
      float y = red[m * BN + c];
      if (rope_style != 0) {
        const int half = rope_hd / 2;
        const int pc = rope_style == 1 ? (c ^ 1) : ((c % rope_hd) < half ? c + half : c - half);
        y = y * cos_row[n] + red[m * BN + pc] * sin_row[n];
      }
      bf16 o = f2bf(y);
      if (residual != nullptr) o = f2bf(bf2f(residual[(size_t)m * N + n]) + bf2f(o));
      out[(size_t)m * N + n] = o;
    }
  }
}

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

template <int MT>
cudaError_t launch_gemv(int BN, size_t smem, cudaStream_t st, const bf16* x, int M, int Kx,
                        int x_stride, const uint32_t* packed, const float* scales,
                        const float* zs, int N, int gs, const float* norm, float eps,
                        const bf16* residual, const float* cos_row, const float* sin_row,
                        int rope_style, int rope_hd, bf16* out) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(w4_gemv_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  w4_gemv_kernel<MT><<<N / BN, GEMV_THREADS, smem, st>>>(
      x, M, Kx, x_stride, packed, scales, zs, N, gs, norm, eps, residual, cos_row, sin_row,
      rope_style, rope_hd, BN, out);
  return cudaGetLastError();
}

}  // namespace

// rope_style: 0 none, 1 interleaved, 2 half. norm/residual/cos/sin may be null.
// Requires Kx % gs == 0, gs % 64 == 0, 16-byte aligned x rows; N % 64 == 0
// (M <= 16) or N % 128 == 0 (M > 16).
// Scratch of the many-row path (M > 16; ignored at M <= 16), allocated by
// the wrapper with the plan of ops/w4_tile.py: xsum (Kx/gs + 1, Mpad) f32 and xt
// (Mpad x Kx) bf16 (the prepared x) with Mpad = M rounded up to 64; ws
// (split, M, N) f32 when split > 1. split: K splits, whole groups each.
extern "C" int w4_matmul(const void* x, int M, int Kx, int x_stride, const void* packed,
                         const void* scales, const void* zs, int N, int gs,
                         const void* norm, float eps, const void* residual,
                         const void* cos_row, const void* sin_row, int rope_style,
                         int rope_hd, void* out, void* xsum, void* xt, void* ws, int split,
                         void* stream) {
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
    int BN = 64;
    if (rope_style == 2 && rope_hd > BN) BN = rope_hd;
    if (N % BN != 0 || GEMV_THREADS % BN != 0) return (int)cudaErrorInvalidValue;
    const int KS = GEMV_THREADS / BN;
    const int MT = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : 16;
    const size_t big = (size_t)std::max(MT * KS * gs, KS * MT * BN);
    const size_t smem = (big + MT * KS + MT) * sizeof(float);
    cudaError_t e;
    switch (MT) {
      case 1: e = launch_gemv<1>(BN, smem, st, xb, M, Kx, x_stride, pk, sc, z, N, gs, nw, eps, res, cr, sr, rope_style, rope_hd, o); break;
      case 2: e = launch_gemv<2>(BN, smem, st, xb, M, Kx, x_stride, pk, sc, z, N, gs, nw, eps, res, cr, sr, rope_style, rope_hd, o); break;
      case 4: e = launch_gemv<4>(BN, smem, st, xb, M, Kx, x_stride, pk, sc, z, N, gs, nw, eps, res, cr, sr, rope_style, rope_hd, o); break;
      case 8: e = launch_gemv<8>(BN, smem, st, xb, M, Kx, x_stride, pk, sc, z, N, gs, nw, eps, res, cr, sr, rope_style, rope_hd, o); break;
      default: e = launch_gemv<16>(BN, smem, st, xb, M, Kx, x_stride, pk, sc, z, N, gs, nw, eps, res, cr, sr, rope_style, rope_hd, o); break;
    }
    return (int)e;
  }
  if (N % w4tile::RED_BN != 0 || (rope_style == 2 && w4tile::RED_BN % rope_hd != 0) || split < 1 ||
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
