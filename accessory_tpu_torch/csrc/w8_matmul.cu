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
//    3.35 TB/s). A thread owns 8 columns of 8 consecutive K rows and reads
//    them as 8 x 8-byte loads (a row of the block's columns is 64 or 128
//    contiguous bytes); the block's 512 threads split its K chunk into 64
//    (32) row lanes, so 16 warps of loads are in flight on each block, and
//    the partials are summed with warp shuffles and shared memory. x is
//    staged in shared memory (normalized, bf16-rounded, as f32) one K chunk
//    at a time and read back as broadcasts. The zero-point term is folded in
//    per thread over its own rows: sum_k x_k w_k - (sum_k x_k) zs_g summed
//    over the row lanes is the group's xsum_g * zs_g.
//  * mma.sync tile for M > 8 (the 1024-row prefill, and any fused call of
//    9..1023 rows). Bound: operations from ~300 rows (about 2 M flops a
//    byte). A 128 x 128 output tile, 256 threads (2 x 4 warps of 64 x 32),
//    m16n8k16 bf16 products with f32 accumulators. A stage is 64 K rows
//    (one group or part of one): the int8 rows are read 4 columns x 8 rows
//    a thread, scaled and rounded to bf16 into shared memory [column][k];
//    the row sums of the staged x feed the zero-point term at each group's
//    end; the next stage's global loads are issued into registers before
//    the current stage's products. The epilogue goes through shared memory
//    (half a tile at a time) so the RoPE partner column is at hand.
//
// The norm prologue reads the whole x row in every block (any K folds). The
// N tile holds whole heads for RoPE (interleaved partner n ^ 1, half n +-
// hd/2).

#include "common.cuh"

namespace {

constexpr int GEMV_THREADS = 512;
constexpr int GEMV_WARPS = GEMV_THREADS / 32;
constexpr int GEMV_MAX_BN = 128;

template <int MT>
__global__ void __launch_bounds__(GEMV_THREADS)
w8_gemv_kernel(const bf16* __restrict__ x, int M, int Kx, long long x_stride,
               const int8_t* __restrict__ q8, const float* __restrict__ scales,
               const float* __restrict__ zs, int N, int gs, const float* __restrict__ norm,
               float eps, const bf16* __restrict__ residual, const float* __restrict__ cos_row,
               const float* __restrict__ sin_row, int rope_style, int rope_hd, int BN,
               bf16* __restrict__ out) {
  __shared__ __align__(16) float xs[MT * 512];   // [MT][CK] staged x of one K chunk
  __shared__ float red[GEMV_WARPS][GEMV_MAX_BN]; // one row's warp partials
  __shared__ float yv[MT][GEMV_MAX_BN];          // the block's sums, before the epilogue
  __shared__ float rinv[MT];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int CG = BN / 8, RL = GEMV_THREADS / CG, CK = RL * 8;
  const int cg = tid % CG, rl = tid / CG;
  const int n = blockIdx.x * BN + cg * 8;
  const bool col_ok = n < N;

  if (norm != nullptr) {
    for (int m = warp; m < MT; m += GEMV_WARPS) {
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

  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

  for (int k0 = 0; k0 < Kx; k0 += CK) {
    __syncthreads();
    const int vecs = CK / 8;
    for (int i = tid; i < MT * vecs; i += GEMV_THREADS) {
      const int m = i / vecs, v8 = i % vecs;
      const int k = k0 + v8 * 8;
      float f[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = 0.f;
      if (m < M && k < Kx) {
        uint4 raw = *reinterpret_cast<const uint4*>(x + (size_t)m * x_stride + k);
        const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = bf2f(v[j]);
        if (norm != nullptr) {
          const float r = rinv[m];
#pragma unroll
          for (int j = 0; j < 8; ++j) f[j] = round_bf16((f[j] * r) * norm[k + j]);
        }
      }
      float4* dst = reinterpret_cast<float4*>(xs + m * CK + v8 * 8);
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    __syncthreads();
    const int kr = k0 + rl * 8;
    if (col_ok && kr < Kx) {
      const size_t gi = (size_t)(kr / gs) * N + n;   // 8 rows never straddle a group
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(scales + gi));
      const float4 s1 = __ldg(reinterpret_cast<const float4*>(scales + gi + 4));
      const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      uint2 qv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        qv[r] = __ldg(reinterpret_cast<const uint2*>(q8 + (size_t)(kr + r) * N + n));
      float xp[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) xp[m] = 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int8_t* qb = reinterpret_cast<const int8_t*>(&qv[r]);
        float w[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) w[j] = round_bf16(__fmul_rn((float)qb[j], s[j]));
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xs[m * CK + rl * 8 + r];
          xp[m] += xv;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[m][j] += xv * w[j];
        }
      }
      const float4 z0 = __ldg(reinterpret_cast<const float4*>(zs + gi));
      const float4 z1 = __ldg(reinterpret_cast<const float4*>(zs + gi + 4));
      const float z[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m][j] -= xp[m] * z[j];
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = acc[m][j];
      for (int off = CG; off < 32; off <<= 1) v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
    }
    __syncthreads();   // the previous row's partials are read
    if (lane < CG) {
#pragma unroll
      for (int j = 0; j < 8; ++j) red[warp][cg * 8 + j] = v[j];
    }
    __syncthreads();
    if (tid < BN) {
      float y = 0.f;
      for (int w = 0; w < GEMV_WARPS; ++w) y += red[w][tid];
      yv[m][tid] = y;
    }
  }
  __syncthreads();
  for (int i = tid; i < M * BN; i += GEMV_THREADS) {
    const int m = i / BN, c = i % BN;
    const int nn = blockIdx.x * BN + c;
    if (m >= MT || nn >= N) continue;
    float y = yv[m][c];
    if (rope_style != 0) {
      const int half = rope_hd / 2;
      const int pc = rope_style == 1 ? (c ^ 1) : ((c % rope_hd) < half ? c + half : c - half);
      y = y * cos_row[nn] + yv[m][pc] * sin_row[nn];
    }
    bf16 o = f2bf(y);
    if (residual != nullptr) o = f2bf(bf2f(residual[(size_t)m * N + nn]) + bf2f(o));
    out[(size_t)m * N + nn] = o;
  }
}

constexpr int BM = 128, BN = 128, BK = 64, THREADS = 256;
constexpr int LD = BK + 8;                      // bf16 per staged row (16 B aligned)
constexpr int C_LD = BN + 4;                    // f32 per staged output row
constexpr int A_VECS = BM * BK / 8 / THREADS;   // uint4 of x per thread per stage (4)
constexpr int AB_BYTES = (BM + BN) * LD * 2;
constexpr int C_BYTES = (BM / 2) * C_LD * 4;
constexpr int SMEM_BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;

__global__ void __launch_bounds__(THREADS, 2)
w8_mma_kernel(const bf16* __restrict__ x, int M, int Kx, long long x_stride,
              const int8_t* __restrict__ q8, const float* __restrict__ scales,
              const float* __restrict__ zs, int N, int gs, const float* __restrict__ norm,
              float eps, const bf16* __restrict__ residual, const float* __restrict__ cos_row,
              const float* __restrict__ sin_row, int rope_style, int rope_hd,
              bf16* __restrict__ out) {
  __shared__ __align__(16) unsigned char smem_raw[SMEM_BYTES];
  __shared__ float rinv_s[BM];
  __shared__ float xsum_s[BM];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);   // [row][k]
  bf16* Bs = As + BM * LD;                         // [column][k], k contiguous per column
  float* Cs = reinterpret_cast<float*>(smem_raw);  // [64][C_LD], epilogue only

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;        // 2 x 4 warps, 64 x 32 outputs each
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int cq = tid % 32, rb = tid / 32;         // B stage: columns 4cq..4cq+3, rows 8rb..8rb+7
  const int bn = n0 + 4 * cq;
  const bool bcol_ok = bn < N;                     // N % 8 == 0: the 4 columns are all in or out

  if (norm != nullptr) {
    const int r = tid >> 1, h = tid & 1;
    float ss = 0.f;
    if (m0 + r < M) {
      const bf16* row = x + (size_t)(m0 + r) * x_stride;
      for (int k = h * 8; k < Kx; k += 16) {
        uint4 raw = *reinterpret_cast<const uint4*>(row + k);
        const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float f = bf2f(v[j]);
          ss += f * f;
        }
      }
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    if (h == 0) rinv_s[r] = 1.f / sqrtf(ss / (float)Kx + eps);
  }

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;

  uint4 a_reg[A_VECS];
  uint32_t b_reg[8];
  float4 s_reg;

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
    for (int r = 0; r < 8; ++r)
      b_reg[r] = bcol_ok ? __ldg(reinterpret_cast<const unsigned int*>(
                               q8 + (size_t)(k0 + 8 * rb + r) * N + bn))
                         : 0u;
    s_reg = bcol_ok ? __ldg(reinterpret_cast<const float4*>(scales + (size_t)(k0 / gs) * N + bn))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  };

  load_stage(0);
  for (int k0 = 0; k0 < Kx; k0 += BK) {
    const int grp = k0 / gs;
    const bool first = (k0 % gs) == 0;
    const bool last = ((k0 + BK) % gs) == 0;
    __syncthreads();   // the previous stage's mma reads are done
#pragma unroll
    for (int p = 0; p < A_VECS; ++p) {
      const int i = tid + p * THREADS;
      const int r = i / (BK / 8), c8 = i % (BK / 8);
      uint4 raw = a_reg[p];
      bf16* v = reinterpret_cast<bf16*>(&raw);
      if (norm != nullptr && m0 + r < M) {
        const float rr = rinv_s[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = f2bf((bf2f(v[j]) * rr) * norm[k0 + c8 * 8 + j]);
      }
      *reinterpret_cast<uint4*>(As + r * LD + c8 * 8) = raw;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) s += bf2f(v[j]);
      s += __shfl_xor_sync(0xffffffffu, s, 1);   // the 8 lanes of one row (c8 = lane % 8)
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      if (c8 == 0) xsum_s[r] = first ? s : xsum_s[r] + s;
    }
    {
      const float sc[4] = {s_reg.x, s_reg.y, s_reg.z, s_reg.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bf16 v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          v[r] = f2bf(__fmul_rn((float)(int8_t)((b_reg[r] >> (8 * j)) & 0xffu), sc[j]));
        uint4 u;
        u.x = pack_bf16_pair(v[0], v[1]);
        u.y = pack_bf16_pair(v[2], v[3]);
        u.z = pack_bf16_pair(v[4], v[5]);
        u.w = pack_bf16_pair(v[6], v[7]);
        *reinterpret_cast<uint4*>(Bs + (4 * cq + j) * LD + 8 * rb) = u;
      }
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
    if (last) {   // the group's zero-point term: acc -= xsum_g * zs_g
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int cn = n0 + wn * 32 + nt * 8 + 2 * t;
        const float z0 = cn < N ? __ldg(zs + (size_t)grp * N + cn) : 0.f;
        const float z1 = cn < N ? __ldg(zs + (size_t)grp * N + cn + 1) : 0.f;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int r0 = wm * 64 + mt * 16 + g;
          const float x0 = xsum_s[r0], x1 = xsum_s[r0 + 8];
          float* a = acc[mt][nt];
          a[0] -= x0 * z0;
          a[1] -= x0 * z1;
          a[2] -= x1 * z0;
          a[3] -= x1 * z1;
        }
      }
    }
  }

  for (int h = 0; h < 2; ++h) {   // rows 64h .. 64h + 63 of the tile
    __syncthreads();
    if (wm == h) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int r0 = mt * 16 + g, cl = wn * 32 + nt * 8 + 2 * t;
          Cs[r0 * C_LD + cl] = acc[mt][nt][0];
          Cs[r0 * C_LD + cl + 1] = acc[mt][nt][1];
          Cs[(r0 + 8) * C_LD + cl] = acc[mt][nt][2];
          Cs[(r0 + 8) * C_LD + cl + 1] = acc[mt][nt][3];
        }
    }
    __syncthreads();
    for (int i = tid; i < (BM / 2) * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int row = m0 + 64 * h + r, n = n0 + c;
      if (row >= M || n >= N) continue;
      float y = Cs[r * C_LD + c];
      if (rope_style != 0) {
        const int half = rope_hd / 2;
        const int pc = rope_style == 1 ? (c ^ 1) : ((c % rope_hd) < half ? c + half : c - half);
        y = y * cos_row[n] + Cs[r * C_LD + pc] * sin_row[n];
      }
      bf16 o = f2bf(y);
      if (residual != nullptr) o = f2bf(bf2f(residual[(size_t)row * N + n]) + bf2f(o));
      out[(size_t)row * N + n] = o;
    }
  }
}

}  // namespace

// x (M, Kx) bf16, row stride x_stride (elements, a multiple of 8, rows 16-byte
// aligned); q8 (>= Kx, N) int8 rows; scales / zs (>= Kx/gs, N) f32; out (M, N)
// bf16 contiguous. rope_style: 0 none, 1 interleaved, 2 half; norm / residual
// / cos / sin may be null. Requires Kx % gs == 0, gs % 64 == 0, N % 8 == 0,
// and with RoPE N % rope_hd == 0 and whole heads in the N tile.
extern "C" int w8_matmul(const void* x, int M, int Kx, long long x_stride, const void* q8,
                         const void* scales, const void* zs, int N, int gs, const void* norm,
                         float eps, const void* residual, const void* cos_row,
                         const void* sin_row, int rope_style, int rope_hd, void* out,
                         void* stream) {
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
  if (M <= 0 || Kx <= 0 || gs % BK != 0 || Kx % gs != 0 || N <= 0 || N % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (rope_style != 0 && (rope_hd <= 0 || rope_hd % 2 != 0 || N % rope_hd != 0))
    return (int)cudaErrorInvalidValue;
  if (M <= 8) {
    const int BNg = (rope_style == 2 && rope_hd > 64) ? 128 : 64;
    if (rope_style == 2 && BNg % rope_hd != 0) return (int)cudaErrorInvalidValue;
    const int grid = (N + BNg - 1) / BNg;
    switch (M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8) {
      case 1:
        w8_gemv_kernel<1><<<grid, GEMV_THREADS, 0, st>>>(xb, M, Kx, x_stride, q, sc, z, N, gs, nw,
                                                         eps, res, cr, sr, rope_style, rope_hd,
                                                         BNg, o);
        break;
      case 2:
        w8_gemv_kernel<2><<<grid, GEMV_THREADS, 0, st>>>(xb, M, Kx, x_stride, q, sc, z, N, gs, nw,
                                                         eps, res, cr, sr, rope_style, rope_hd,
                                                         BNg, o);
        break;
      case 4:
        w8_gemv_kernel<4><<<grid, GEMV_THREADS, 0, st>>>(xb, M, Kx, x_stride, q, sc, z, N, gs, nw,
                                                         eps, res, cr, sr, rope_style, rope_hd,
                                                         BNg, o);
        break;
      default:
        w8_gemv_kernel<8><<<grid, GEMV_THREADS, 0, st>>>(xb, M, Kx, x_stride, q, sc, z, N, gs, nw,
                                                         eps, res, cr, sr, rope_style, rope_hd,
                                                         BNg, o);
        break;
    }
    return (int)cudaGetLastError();
  }
  if (rope_style == 2 && BN % rope_hd != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  w8_mma_kernel<<<grid, THREADS, 0, st>>>(xb, M, Kx, x_stride, q, sc, z, N, gs, nw, eps, res, cr,
                                          sr, rope_style, rope_hd, o);
  return (int)cudaGetLastError();
}
