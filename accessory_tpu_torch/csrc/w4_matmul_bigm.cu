// W4A16 matmul for many rows (M >= 1024: a batched prefill).
//
// Replaces: accessory_tpu/ops/quant_matmul_bigm.py::planes_qmm_bigm (Pallas
// kernel `_kernel`), the weight-stationary large-M form of the W4 matmul.
//
//   y = x @ bf16(q * s - zs)        f32 accumulation over the whole of K
//
// Numerics are the TPU kernel's: every weight is dequantized in f32
// (q * s, then - zs, two roundings), rounded once to bf16, and the product
// accumulates in f32 over all of K before one cast to bf16. (w4_matmul.cu
// keeps q exact and applies the scale per group in f32 instead; the two forms
// differ by the bf16 rounding of the weight.) No prologue and no epilogue.
//
// Weight layout: the port's folded layout, packed (K/8, N) uint32 with 8
// nibbles per word along K, scales and zs = zeros * scales (K/gs, N) f32.
//
// Bound on the H100: operations. At M rows the call does 2*M*K*N flops for
// K*N/2 + 8*N*K/gs weight bytes, about 3.6 * M flops per byte: far above the
// card's ~295 flops per byte from M ~ 83 on. What the TPU kernel buys is fewer
// dequantizations (it keeps a whole (K, tn) bf16 panel in VMEM and reuses it
// over every row tile). A block here has 227 KB, not megabytes, so the same
// end is reached by a taller row tile: one (64, 128) stage of weights is
// dequantized once into shared memory and all eight warps' mma.sync
// (m16n8k16 bf16, f32 accumulate) read it over a 128-row tile, so a weight
// element is dequantized M/128 times per call where w4_matmul.cu's 64-row
// tile dequantizes it M/64 times. The row tiles of one weight column panel
// are neighbours in the grid (blockIdx.x walks M), so the panel's packed
// words come from HBM once and from L2 after. The next stage's global loads
// (x rows and packed words) are started into registers before the current
// stage's mma loop, so they overlap it; two blocks fit on an SM.
//
// K has no limit here: the TPU kernel's bigm_supported() is a VMEM budget.

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64, THREADS = 256;
constexpr int LD = BK + 8;                       // bf16 per staged row (16 B aligned, no bank conflicts)
constexpr int A_VECS = BM * BK / 8 / THREADS;    // uint4 of x per thread per stage (4)
constexpr int B_WORDS = BK / 8 * BN / THREADS;   // packed words per thread per stage (4)

__device__ __forceinline__ uint32_t dequant_pair(uint32_t q0, uint32_t q1, float s, float zs) {
  // q * s - zs with two f32 roundings (no fused multiply-add), as the plain version
  const float w0 = __fsub_rn(__fmul_rn((float)q0, s), zs);
  const float w1 = __fsub_rn(__fmul_rn((float)q1, s), zs);
  return pack_bf16x2(w0, w1);
}

__global__ void __launch_bounds__(THREADS, 2)
w4_bigm_kernel(const bf16* __restrict__ x, int M, int Kx, long long x_stride,
               const uint32_t* __restrict__ packed, const float* __restrict__ scales,
               const float* __restrict__ zs, int N, int gs, bf16* __restrict__ out) {
  __shared__ __align__(16) bf16 As[BM * LD];   // [row][k]
  __shared__ __align__(16) bf16 Bs[BN * LD];   // [col][k], k contiguous per column

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;     // 2 x 4 warps, 64 x 32 outputs each
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int bc = tid % BN, bw = tid / BN;      // this thread's weight column and word row

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;

  uint4 a_reg[A_VECS];
  uint32_t b_reg[B_WORDS];
  float s_reg, z_reg;

  auto load_stage = [&](int k0) {
#pragma unroll
    for (int p = 0; p < A_VECS; ++p) {
      const int i = tid + p * THREADS;
      const int r = i / (BK / 8), c8 = i % (BK / 8);
      a_reg[p] = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        a_reg[p] = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * x_stride + k0 + c8 * 8);
    }
#pragma unroll
    for (int p = 0; p < B_WORDS; ++p)
      b_reg[p] = __ldg(packed + (size_t)(k0 / 8 + bw + p * (THREADS / BN)) * N + n0 + bc);
    const size_t gi = (size_t)(k0 / gs) * N + n0 + bc;   // a stage lies inside one group
    s_reg = __ldg(scales + gi);
    z_reg = __ldg(zs + gi);
  };

  load_stage(0);
  for (int k0 = 0; k0 < Kx; k0 += BK) {
    __syncthreads();   // the previous stage's mma reads are done
#pragma unroll
    for (int p = 0; p < A_VECS; ++p) {
      const int i = tid + p * THREADS;
      *reinterpret_cast<uint4*>(As + (i / (BK / 8)) * LD + (i % (BK / 8)) * 8) = a_reg[p];
    }
#pragma unroll
    for (int p = 0; p < B_WORDS; ++p) {
      const uint32_t wd = b_reg[p];
      uint4 v;
      v.x = dequant_pair(wd & 15u, (wd >> 4) & 15u, s_reg, z_reg);
      v.y = dequant_pair((wd >> 8) & 15u, (wd >> 12) & 15u, s_reg, z_reg);
      v.z = dequant_pair((wd >> 16) & 15u, (wd >> 20) & 15u, s_reg, z_reg);
      v.w = dequant_pair((wd >> 24) & 15u, (wd >> 28) & 15u, s_reg, z_reg);
      *reinterpret_cast<uint4*>(Bs + bc * LD + (bw + p * (THREADS / BN)) * 8) = v;
    }
    __syncthreads();
    if (k0 + BK < Kx) load_stage(k0 + BK);   // in flight during the mma loop below
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t afr[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const bf16* base = As + (wm * 64 + mt * 16 + g) * LD + kk + 2 * t;
        afr[mt][0] = *reinterpret_cast<const uint32_t*>(base);
        afr[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD);
        afr[mt][2] = *reinterpret_cast<const uint32_t*>(base + 8);
        afr[mt][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* bb = Bs + (wn * 32 + nt * 8 + g) * LD + kk + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bb);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bb + 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_bf16_16816(acc[mt][nt], afr[mt], b0, b1);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int r0 = m0 + wm * 64 + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int cn = n0 + wn * 32 + nt * 8 + 2 * t;
      if (r0 < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)r0 * N + cn) =
            pack_bf16x2(acc[mt][nt][0], acc[mt][nt][1]);
      if (r0 + 8 < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)(r0 + 8) * N + cn) =
            pack_bf16x2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

}  // namespace

// x (M, Kx) bf16 with row stride x_stride (elements, a multiple of 8, rows
// 16-byte aligned); packed (>= Kx/8, N) words; scales/zs (>= Kx/gs, N) f32;
// out (M, N) bf16 contiguous. Requires Kx % 64 == 0, gs % 64 == 0,
// N % 128 == 0, M >= 1 (any M: a ragged last row tile is masked).
extern "C" int w4_matmul_bigm(const void* x, int M, int Kx, long long x_stride,
                              const void* packed, const void* scales, const void* zs, int N,
                              int gs, void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 0 || Kx <= 0 || Kx % BK != 0 || gs % BK != 0 || N % BN != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((M + BM - 1) / BM, N / BN);
  w4_bigm_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const bf16*>(x), M, Kx, x_stride, static_cast<const uint32_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(zs), N, gs,
      static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}
