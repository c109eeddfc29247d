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
// so per weight element the work is one int->float convert and one FMA per
// row, with the group product accumulated in f32 over exact integer q.
//
// Bound on the H100: at decode (M <= 16) the call is a GEMV that must stream
// K*N/2 bytes of nibbles plus 8*N*K/gs bytes of scales, so it is bound by
// memory bytes. The GEMV path gives each thread one output column so a warp
// reads 128 contiguous bytes of packed words per K row; the K range is split
// over the block's warps (one group per warp per chunk) so even 2048-wide
// outputs keep 16 warps of loads in flight per block, and the split partials
// are reduced in shared memory. x is staged (normalized, bf16-rounded) in
// shared memory once per block and read back as broadcasts.
// For prefill rows (16 < M < 1024) the work does about 3.6 * M flops per
// weight byte (nibbles plus f32 scales and zs, group 128), so from M ~ 83 on
// (the card's ~295 bf16 flops per byte) it is bound by operations, as the
// main path's M = 512 prefill is; a tiled mma.sync m16n8k16 bf16 kernel
// (64x128 tile, 8 warps) dequantizes each 64-row slab of packed words into
// shared memory as exact bf16 integers and applies the per-group scale to an
// f32 group accumulator.
//
// The norm prologue reads the whole x row in every block (the TPU kernel's
// in_dim == tile_k rule does not apply: any K folds). The normalized x is
// rounded to bf16 before the product and RoPE runs in f32 before the output
// cast, then the residual is added in bf16, the same op order as the TPU
// kernel. The N tile holds whole heads so each column's RoPE partner
// (n^1 interleaved, n +- hd/2 half) is in the same block.

#include <algorithm>

#include "common.cuh"

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

constexpr int MM_BM = 64, MM_BN = 128, MM_BK = 64, MM_THREADS = 256;
constexpr int A_LD = MM_BK + 8;  // bf16 elements per staged row (16 B aligned)
constexpr int B_LD = MM_BK + 8;
constexpr int C_LD = MM_BN + 4;
constexpr int AB_BYTES = (MM_BM * A_LD + MM_BN * B_LD) * 2;
constexpr int C_BYTES = MM_BM * C_LD * 4;
constexpr int MM_SMEM = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;

__global__ void __launch_bounds__(MM_THREADS)
w4_mma_kernel(const bf16* __restrict__ x, int M, int Kx, int x_stride,
              const uint32_t* __restrict__ packed, const float* __restrict__ scales,
              const float* __restrict__ zs, int N, int gs,
              const float* __restrict__ norm, float eps,
              const bf16* __restrict__ residual,
              const float* __restrict__ cos_row, const float* __restrict__ sin_row,
              int rope_style, int rope_hd, bf16* __restrict__ out) {
  __shared__ __align__(16) unsigned char smem_raw[MM_SMEM];
  __shared__ float rinv_s[MM_BM];
  __shared__ float xsum_s[MM_BM];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [BM][A_LD]
  bf16* Bs = As + MM_BM * A_LD;                   // [BN][B_LD], k contiguous per column
  float* Cs = reinterpret_cast<float*>(smem_raw); // [BM][C_LD], epilogue only

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 32 x 32 each
  const int m0 = blockIdx.y * MM_BM, n0 = blockIdx.x * MM_BN;

  if (norm != nullptr) {
    const int r = tid >> 2, q4 = tid & 3;
    float ss = 0.f;
    if (m0 + r < M) {
      const bf16* row = x + (size_t)(m0 + r) * x_stride;
      for (int k = q4 * 8; k < Kx; k += 32) {
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
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    if (q4 == 0) rinv_s[r] = 1.f / sqrtf(ss / (float)Kx + eps);
  }

  float acc[2][4][4], gacc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = gacc[a][b][e] = 0.f;

  for (int k0 = 0; k0 < Kx; k0 += MM_BK) {
    const int grp = k0 / gs;
    const bool first = (k0 % gs) == 0;
    const bool last = ((k0 + MM_BK) % gs) == 0;
    __syncthreads();
    for (int i = tid; i < MM_BM * MM_BK / 8; i += MM_THREADS) {
      const int r = i / (MM_BK / 8), c8 = i % (MM_BK / 8);
      const int row = m0 + r, k = k0 + c8 * 8;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (row < M) {
        raw = *reinterpret_cast<const uint4*>(x + (size_t)row * x_stride + k);
        if (norm != nullptr) {
          bf16* v = reinterpret_cast<bf16*>(&raw);
          const float rr = rinv_s[r];
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = f2bf((bf2f(v[j]) * rr) * norm[k + j]);
        }
      }
      *reinterpret_cast<uint4*>(As + r * A_LD + c8 * 8) = raw;
    }
    for (int i = tid; i < (MM_BK / 8) * MM_BN; i += MM_THREADS) {
      const int wr = i / MM_BN, c = i % MM_BN;
      const uint32_t wd = __ldg(packed + (size_t)(k0 / 8 + wr) * N + n0 + c);
      uint4 v;
      v.x = pack_bf16x2((float)(wd & 15u), (float)((wd >> 4) & 15u));
      v.y = pack_bf16x2((float)((wd >> 8) & 15u), (float)((wd >> 12) & 15u));
      v.z = pack_bf16x2((float)((wd >> 16) & 15u), (float)((wd >> 20) & 15u));
      v.w = pack_bf16x2((float)((wd >> 24) & 15u), (float)((wd >> 28) & 15u));
      *reinterpret_cast<uint4*>(Bs + c * B_LD + wr * 8) = v;
    }
    __syncthreads();
    {
      const int r = tid >> 2, q4 = tid & 3;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < MM_BK / 4; ++j) s += bf2f(As[r * A_LD + q4 * (MM_BK / 4) + j]);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (q4 == 0) xsum_s[r] = first ? s : xsum_s[r] + s;
    }
    if (first) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) gacc[a][b][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < MM_BK; kk += 16) {
      uint32_t afr[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* base = As + (wm * 32 + mt * 16 + g) * A_LD + kk + 2 * t;
        afr[mt][0] = *reinterpret_cast<const uint32_t*>(base);
        afr[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * A_LD);
        afr[mt][2] = *reinterpret_cast<const uint32_t*>(base + 8);
        afr[mt][3] = *reinterpret_cast<const uint32_t*>(base + 8 * A_LD + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* bb = Bs + (wn * 32 + nt * 8 + g) * B_LD + kk + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bb);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bb + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16_16816(gacc[mt][nt], afr[mt], b0, b1);
      }
    }
    __syncthreads();
    if (last) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int cn = n0 + wn * 32 + nt * 8 + 2 * t;
        const float s0 = scales[(size_t)grp * N + cn], s1 = scales[(size_t)grp * N + cn + 1];
        const float z0 = zs[(size_t)grp * N + cn], z1 = zs[(size_t)grp * N + cn + 1];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r0 = wm * 32 + mt * 16 + g;
          const float x0 = xsum_s[r0], x1 = xsum_s[r0 + 8];
          float* a = acc[mt][nt];
          const float* ga = gacc[mt][nt];
          a[0] += s0 * ga[0] - z0 * x0;
          a[1] += s1 * ga[1] - z1 * x0;
          a[2] += s0 * ga[2] - z0 * x1;
          a[3] += s1 * ga[3] - z1 * x1;
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r0 = wm * 32 + mt * 16 + g, cl = wn * 32 + nt * 8 + 2 * t;
      Cs[r0 * C_LD + cl] = acc[mt][nt][0];
      Cs[r0 * C_LD + cl + 1] = acc[mt][nt][1];
      Cs[(r0 + 8) * C_LD + cl] = acc[mt][nt][2];
      Cs[(r0 + 8) * C_LD + cl + 1] = acc[mt][nt][3];
    }
  __syncthreads();
  for (int i = tid; i < MM_BM * MM_BN; i += MM_THREADS) {
    const int r = i / MM_BN, c = i % MM_BN;
    const int row = m0 + r, n = n0 + c;
    if (row >= M) continue;
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
extern "C" int w4_matmul(const void* x, int M, int Kx, int x_stride, const void* packed,
                         const void* scales, const void* zs, int N, int gs,
                         const void* norm, float eps, const void* residual,
                         const void* cos_row, const void* sin_row, int rope_style,
                         int rope_hd, void* out, void* stream) {
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
  if (N % MM_BN != 0 || (rope_style == 2 && MM_BN % rope_hd != 0)) return (int)cudaErrorInvalidValue;
  dim3 grid(N / MM_BN, (M + MM_BM - 1) / MM_BM);
  w4_mma_kernel<<<grid, MM_THREADS, 0, st>>>(xb, M, Kx, x_stride, pk, sc, z, N, gs, nw, eps,
                                             res, cr, sr, rope_style, rope_hd, o);
  return (int)cudaGetLastError();
}
