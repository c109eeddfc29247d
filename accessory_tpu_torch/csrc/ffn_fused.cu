// The whole W4 decode FFN in one launch:
//
//   out = (silu(x' @ W1) * (x' @ W3)) @ W2  [+ residual],  x' = [rms_norm](x)
//
// Replaces: accessory_tpu/ops/ffn_fused.py::ffn_qmm (Pallas kernel
// `_ffn_kernel`: phase A x @ [W1|W3] into a VMEM slab h, phase B
// silu(h1) * h3 @ W2 plus the residual, on one sequential grid).
//
// Weights: the port's folded W4 layout, as csrc/w4_matmul.cu takes it:
// packed (in_dim/8, N) uint32 words of 8 nibbles little-endian along K,
// scales and zs = zeros * scales (>= in_dim/gs, N) f32 (rows past the used
// groups are never read). W13 is [W1|W3] fused along N (N13 = 2 * FFN); W2
// is read over its first FFN rows only, so a W2 whose in_dim the quantizer
// padded past FFN (zero activations meet the padded rows) is served as the
// unfused route serves it.
//
// Bound on the H100: bytes. At decode (M <= 8 rows) the call must stream both
// weights once (TinyLlama 19.5 MB, LLaMA2-7B 76.1 MB with f32 scales and zs);
// the activations and the intermediate are a few hundred KB.
//
// Design. Phase B needs all of phase A: every W2 column sums over the whole
// intermediate h (M, N13). At 7B and M = 8 h is 352 KB, more than one SM's
// shared memory, so it cannot stay on chip as it stays in the TPU's VMEM.
// The kernel is persistent and cooperative instead: a grid no larger than the
// blocks that are resident at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// x SM count, launched with cudaLaunchCooperativeKernel) walks phase A's
// 64-column tiles, writes h as bf16 (the TPU kernel's rounding of the slab)
// into a global scratch the caller allocates, which stays in the 50 MB L2,
// meets at cooperative_groups::this_grid().sync(), and walks phase B's tiles,
// reading h back with L1-bypassing loads (it was written by other SMs in this
// launch). The host side refuses (an error code the wrapper raises) where the
// device has no cooperative launch or the block cannot be resident, rather
// than splitting the work into two launches.
//
// Each tile is row 1's GEMV (csrc/w4_matmul.cu, w4_gemv_kernel): one thread
// per output column, the K range split over 8 thread groups (one quant group
// each per chunk), x staged in shared memory as f32 (normalized and rounded
// to bf16 in phase A; silu(h1) * h3 in f32 rounded once to bf16 in phase B,
// the TPU kernel's SwiGLU rounding), and per group
//   y += s_g * (x_g . q_g) - zs_g * sum(x_g)
// with q exact, so the fused route differs from the unfused one only by the
// SwiGLU rounding (the unfused chain rounds silu(h1) and the product apart).
// M runs from 1 to 128: MT rows a pass (MT in 1, 2, 4, 8 up to 8 rows, else
// 16) and the rows in passes of 16, each pass reading the tile's weights
// again (from L2). Phase B has only N2 / 64 tiles (32 at TinyLlama, 64 at
// 7B) for the 132 SMs, as the unfused W2 GEMV has.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int BN = 64;              // output columns of a tile, one a thread
constexpr int KS = THREADS / BN;    // K splits of a tile
constexpr int MAX_ROWS = 128;

struct Params {
  const bf16* x;
  int M, K, x_stride;
  const uint32_t* p13;
  const float* s13;
  const float* z13;
  int N13;
  const uint32_t* p2;
  const float* s2;
  const float* z2;
  int N2;
  int gs;
  const float* norm;
  float eps;
  const bf16* residual;
  bf16* h;    // (M, N13) scratch
  bf16* out;  // (M, N2)
};

__host__ __device__ constexpr int smem_floats(int mt, int gs) {
  // staged rows [MT][KS * gs] (also the split partials [KS][MT][BN], gs >= BN),
  // per-group sums [MT][KS], 1 / rms of every row [MAX_ROWS]
  return mt * KS * gs + mt * KS + MAX_ROWS;
}

// One 64-column tile of MT rows from r0: phase A (x @ W13 -> h) or, with
// SWIGLU, phase B (silu(h1) * h3 @ W2 [+ residual] -> out).
template <int MT, bool SWIGLU>
__device__ void gemv_tile(const Params& p, int r0, int n0, float* smem, const float* rinv) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % BN, ks = tid / BN;
  const int gs = p.gs, chunk_k = KS * gs;
  const int ffn = p.N13 / 2;
  const bf16* src = SWIGLU ? p.h : p.x;
  const int stride = SWIGLU ? p.N13 : p.x_stride;
  const int K = SWIGLU ? ffn : p.K;
  const uint32_t* packed = SWIGLU ? p.p2 : p.p13;
  const float* scales = SWIGLU ? p.s2 : p.s13;
  const float* zs = SWIGLU ? p.z2 : p.z13;
  const int N = SWIGLU ? p.N2 : p.N13;
  bf16* out = SWIGLU ? p.out : p.h;
  const int n = n0 + c;
  const int rows = min(MT, p.M - r0);
  float* xs = smem;                  // [MT][chunk_k]
  float* red = smem;                 // [KS][MT][BN], after the K loop
  float* xsum = smem + MT * chunk_k; // [MT][KS]

  float part[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) part[m] = 0.f;

  const int G = K / gs;
  const int wpg = gs / 8;  // packed words per group (a multiple of 8)
  for (int g0 = 0; g0 < G; g0 += KS) {
    const int ng = min(KS, G - g0);
    __syncthreads();
    const int vecs = ng * gs / 8;
    for (int i = tid; i < MT * vecs; i += THREADS) {
      const int m = i / vecs, v8 = i % vecs;
      const int k = g0 * gs + v8 * 8;
      float f[8];
      if (m < rows) {
        const bf16* row = src + (size_t)(r0 + m) * stride + k;
        if (SWIGLU) {
          const uint4 ra = __ldcg(reinterpret_cast<const uint4*>(row));
          const uint4 rb = __ldcg(reinterpret_cast<const uint4*>(row + ffn));
          const bf16* a = reinterpret_cast<const bf16*>(&ra);
          const bf16* b = reinterpret_cast<const bf16*>(&rb);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float h1 = bf2f(a[j]);
            f[j] = round_bf16(h1 * (1.f / (1.f + expf(-h1))) * bf2f(b[j]));
          }
        } else {
          const uint4 raw = *reinterpret_cast<const uint4*>(row);
          const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int j = 0; j < 8; ++j) f[j] = bf2f(v[j]);
          if (p.norm != nullptr) {
            const float r = rinv[r0 + m];
#pragma unroll
            for (int j = 0; j < 8; ++j) f[j] = round_bf16((f[j] * r) * p.norm[k + j]);
          }
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
    for (int i = warp; i < MT * ng; i += NWARPS) {
      const int m = i / ng, gg = i % ng;
      const float* g_src = xs + m * chunk_k + gg * gs;
      float s = 0.f;
      for (int k = lane; k < gs; k += 32) s += g_src[k];
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
            const float4 xb =
                *reinterpret_cast<const float4*>(xg + m * chunk_k + (w0 + u) * 8 + 4);
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
    for (int m = 0; m < rows; ++m) {
      float y = 0.f;
      for (int kk = 0; kk < KS; ++kk) y += red[(kk * MT + m) * BN + c];
      bf16 o = f2bf(y);
      if (SWIGLU && p.residual != nullptr)
        o = f2bf(bf2f(p.residual[(size_t)(r0 + m) * N + n]) + bf2f(o));
      out[(size_t)(r0 + m) * N + n] = o;
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS) ffn_fused_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* rinv = smem + smem_floats(MT, p.gs) - MAX_ROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (p.norm != nullptr) {
    for (int m = warp; m < p.M; m += NWARPS) {
      const bf16* row = p.x + (size_t)m * p.x_stride;
      float ss = 0.f;
      for (int k = lane * 8; k < p.K; k += 256) {
        const uint4 raw = *reinterpret_cast<const uint4*>(row + k);
        const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float f = bf2f(v[j]);
          ss += f * f;
        }
      }
      ss = warp_sum(ss);
      if (lane == 0) rinv[m] = 1.f / sqrtf(ss / (float)p.K + p.eps);
    }
  }
  __syncthreads();
  const int tiles_a = p.N13 / BN, tiles_b = p.N2 / BN;
  for (int t = blockIdx.x; t < tiles_a; t += gridDim.x)
    for (int r0 = 0; r0 < p.M; r0 += MT) gemv_tile<MT, false>(p, r0, t * BN, smem, rinv);
  // every block's h tiles are written and visible before any block reads them
  cg::this_grid().sync();
  for (int t = blockIdx.x; t < tiles_b; t += gridDim.x)
    for (int r0 = 0; r0 < p.M; r0 += MT) gemv_tile<MT, true>(p, r0, t * BN, smem, rinv);
}

// Per device and row template: the resident-block count at the shared
// memory size it was taken for (a grid larger than that would never meet
// at the grid barrier).
struct Residency {
  size_t smem = 0;
  int blocks = 0;
};

constexpr int MAX_DEVICES = 64;

template <int MT>
cudaError_t launch(const Params& p, cudaStream_t st) {
  static int coop[MAX_DEVICES], sms[MAX_DEVICES];
  static Residency res[MAX_DEVICES];
  const size_t smem = (size_t)smem_floats(MT, p.gs) * sizeof(float);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&coop[dev], cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  if (!coop[dev]) return cudaErrorNotSupported;
  if (res[dev].smem != smem) {
    e = cudaFuncSetAttribute(ffn_fused_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ffn_fused_kernel<MT>, THREADS,
                                                      smem);
    if (e != cudaSuccess) return e;
    res[dev].smem = smem;
    res[dev].blocks = blocks;
  }
  if (res[dev].blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int tiles = max(p.N13, p.N2) / BN;
  const int grid = min(tiles, res[dev].blocks * sms[dev]);
  void* args[] = {const_cast<Params*>(&p)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ffn_fused_kernel<MT>),
                                  dim3(grid), dim3(THREADS), args, smem, st);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// x (M, K) bf16 with 16-byte aligned rows of stride x_stride; W13 packed
// (>= K/8, N13) with scales / zs (>= K/gs, N13); W2 packed (>= N13/16, N2)
// with scales / zs (>= N13/2/gs, N2); norm (K,) f32 or null; residual (M, N2)
// bf16 contiguous or null; h (M, N13) bf16 scratch; out (M, N2) bf16.
// Requires 1 <= M <= 128, gs % 64 == 0, K % gs == 0, (N13 / 2) % gs == 0,
// N2 % 64 == 0.
extern "C" int ffn_fused(const void* x, int M, int K, int x_stride, const void* p13,
                         const void* s13, const void* z13, int N13, const void* p2,
                         const void* s2, const void* z2, int N2, int gs, const void* norm,
                         float eps, const void* residual, void* h, void* out, void* stream) {
  if (M < 1 || M > MAX_ROWS || gs <= 0 || gs % 64 != 0 || K <= 0 || K % gs != 0 ||
      N13 <= 0 || N13 % 2 != 0 || (N13 / 2) % gs != 0 || N2 <= 0 || N2 % BN != 0 ||
      x_stride % 8 != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.M = M;
  p.K = K;
  p.x_stride = x_stride;
  p.p13 = static_cast<const uint32_t*>(p13);
  p.s13 = static_cast<const float*>(s13);
  p.z13 = static_cast<const float*>(z13);
  p.N13 = N13;
  p.p2 = static_cast<const uint32_t*>(p2);
  p.s2 = static_cast<const float*>(s2);
  p.z2 = static_cast<const float*>(z2);
  p.N2 = N2;
  p.gs = gs;
  p.norm = static_cast<const float*>(norm);
  p.eps = eps;
  p.residual = static_cast<const bf16*>(residual);
  p.h = static_cast<bf16*>(h);
  p.out = static_cast<bf16*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (M <= 1) e = launch<1>(p, st);
  else if (M <= 2) e = launch<2>(p, st);
  else if (M <= 4) e = launch<4>(p, st);
  else if (M <= 8) e = launch<8>(p, st);
  else e = launch<16>(p, st);
  return (int)e;
}
