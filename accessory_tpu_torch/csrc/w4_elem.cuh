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
//  * mma.sync tile for M > 8: a 128 x 128 output tile, 256 threads (2 x 4
//    warps of 64 x 32), a unit's weights dequantized to bf16 in shared memory
//    ([column][stage index], the A tile in the same stage order), m16n8k16
//    bf16 products with f32 accumulators; the next unit's global loads are
//    issued into registers before the current unit's products.
//
// Bound on the H100: bytes at decode (K*N/2 bytes of nibbles plus 8 bytes of
// f32 scale and zero per column per group), operations from M ~ 80 rows.

#pragma once

#include "common.cuh"

namespace w4elem {

constexpr int UNIT_ROWS = 64;           // K rows per unit (8 words)
constexpr int GEMV_WARPS = 8;
constexpr int GEMV_THREADS = GEMV_WARPS * 32;
constexpr int BM = 128, BN = 128, THREADS = 256;
constexpr int LD = UNIT_ROWS + 8;       // bf16 per staged row (16 B aligned, no bank conflicts)
constexpr int A_VECS = BM * UNIT_ROWS / 8 / THREADS;   // uint4 of x per thread per unit (4)
constexpr int B_WORDS = 8 * BN / THREADS;              // words per thread per unit (4)

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

template <class Layout>
__global__ void __launch_bounds__(THREADS, 2)
mma_kernel(const bf16* __restrict__ x, int M, int Kx, long long x_stride,
           const uint32_t* __restrict__ packed, const float* __restrict__ scales,
           const float* __restrict__ zeros, int K, int N, int gs, int tk,
           bf16* __restrict__ out) {
  __shared__ __align__(16) bf16 As[BM * LD];   // [row][stage index]
  __shared__ __align__(16) bf16 Bs[BN * LD];   // [column][stage index]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;     // 2 x 4 warps, 64 x 32 outputs each
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int bc = tid % BN, bw = tid / BN;      // this thread's weight column and first word row
  const bool col_ok = n0 + bc < N;

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;

  uint4 a_reg[A_VECS];
  uint32_t b_reg[B_WORDS];
  typename Layout::Coef c_reg[4];

  auto load_unit = [&](int u) {
    int base[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) base[i] = Layout::seg_base(u, i, tk);
#pragma unroll
    for (int p = 0; p < A_VECS; ++p) {
      const int i = tid + p * THREADS;
      const int r = i / 8, c8 = i % 8;
      const int k = base[c8 / 2] + 8 * (c8 % 2);
      a_reg[p] = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && base[c8 / 2] < Kx)
        a_reg[p] = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * x_stride + k);
    }
#pragma unroll
    for (int p = 0; p < B_WORDS; ++p)
      b_reg[p] = col_ok ? __ldg(packed + (size_t)(u * 8 + bw + 2 * p) * N + n0 + bc) : 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t gi = (size_t)(base[i] / gs) * N + n0 + bc;
      c_reg[i] = Layout::coef(col_ok ? __ldg(scales + gi) : 0.f, col_ok ? __ldg(zeros + gi) : 0.f);
    }
  };

  const int units = K / UNIT_ROWS;
  load_unit(0);
  for (int u = 0; u < units; ++u) {
    __syncthreads();   // the previous unit's mma reads are done
#pragma unroll
    for (int p = 0; p < A_VECS; ++p) {
      const int i = tid + p * THREADS;
      *reinterpret_cast<uint4*>(As + (i / 8) * LD + (i % 8) * 8) = a_reg[p];
    }
#pragma unroll
    for (int p = 0; p < B_WORDS; ++p) {
      const int wl = bw + 2 * p;
      bf16 v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        v[q] = f2bf(Layout::value((b_reg[p] >> (4 * q)) & 15u, c_reg[Layout::stage_index(wl, q) / 16]));
      Layout::store_word(Bs + bc * LD, wl, v);
    }
    __syncthreads();
    if (u + 1 < units) load_unit(u + 1);   // in flight during the products below
#pragma unroll
    for (int kk = 0; kk < UNIT_ROWS; kk += 16) {
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
      if (cn >= N) continue;
      if (r0 < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)r0 * N + cn) =
            pack_bf16x2(acc[mt][nt][0], acc[mt][nt][1]);
      if (r0 + 8 < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)(r0 + 8) * N + cn) =
            pack_bf16x2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// x (M, Kx) bf16, row stride x_stride (elements, a multiple of 8, rows 16-byte
// aligned); packed (K/8, N) words in the Layout's order; scales / zeros
// (>= K/gs, N) f32 in the Layout's form; out (M, N) bf16 contiguous.
// Requires K % 64 == 0, gs % 64 == 0, Kx % 64 == 0, Kx <= K, N % 8 == 0, and
// the Layout's own conditions on tk.
template <class Layout>
int launch(const void* x, int M, int Kx, long long x_stride, const void* packed,
           const void* scales, const void* zeros, int K, int N, int gs, int tk, void* out,
           void* stream) {
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
  } else {
    dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    mma_kernel<Layout><<<grid, THREADS, 0, st>>>(xb, M, Kx, x_stride, pk, sc, z, K, N, gs, tk, o);
  }
  return (int)cudaGetLastError();
}

}  // namespace w4elem
