// Folded W4 weight -> dense (K, N) weight in one streaming pass.
//
// Replaces: accessory_tpu/ops/quant_matmul_bigm.py::planes_dequant
// (`_dequant_kernel` :162), which quant/qtensor.py::dense_weight calls once
// per frozen W4 matmul in every QPEFT backward (the dx = g @ W^T product).
//
// Input: the port's folded layout. packed (ceil(K/8), N) 32-bit words, eight
// nibbles little-endian along K (word w holds rows 8w..8w+7); scales and zs
// (>= K/g, N) f32 (rows past K/g, where padded, are not read). Output (K, N)
// bf16 or f32, w = q*s - zs computed in f32 as a multiply and a subtract, each
// rounded (no FMA contraction), then cast once: bit-equal to
// quant/qtensor.py::dequantize_weight.
//
// Bound on the H100: no arithmetic to speak of; the bytes are K*N/2 read,
// K*N*2 (bf16) written and 2*(K/g)*N*4 of scales, at 3.35 TB/s (7B w1,
// 4096 x 11008: ~34 us). Each thread owns 8 neighbouring columns and a run
// of WPT words (64 K rows): per word two 16-byte loads, per output row one
// 16-byte store (two for f32); it re-reads the scale rows only when the group
// changes. Threads of a warp take neighbouring column chunks, so every load
// and store is coalesced along N.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;  // column chunks per block (x)
constexpr int WPT = 8;        // words (8 K rows each) per thread

__device__ __forceinline__ void store8(bf16* dst, const float v[8]) {
  uint4 o;
  o.x = pack_bf16x2(v[0], v[1]);
  o.y = pack_bf16x2(v[2], v[3]);
  o.z = pack_bf16x2(v[4], v[5]);
  o.w = pack_bf16x2(v[6], v[7]);
  *reinterpret_cast<uint4*>(dst) = o;
}

__device__ __forceinline__ void store8(float* dst, const float v[8]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
w4_dequant_kernel(const uint32_t* __restrict__ packed, const float* __restrict__ scales,
                  const float* __restrict__ zs, OutT* __restrict__ out, int K, int N, int G) {
  const int c0 = (blockIdx.x * THREADS + threadIdx.x) * 8;
  if (c0 >= N) return;
  const int w0 = blockIdx.y * WPT;
  const int words = (K + 7) / 8;
  int grp = -1;
  float s[8], z[8];
  for (int w = w0; w < min(w0 + WPT, words); ++w) {
    const uint4 lo = *reinterpret_cast<const uint4*>(packed + (size_t)w * N + c0);
    const uint4 hi = *reinterpret_cast<const uint4*>(packed + (size_t)w * N + c0 + 4);
    const uint32_t q[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = w * 8 + j;
      if (r >= K) break;
      if (r / G != grp) {
        grp = r / G;
        const float4* sp = reinterpret_cast<const float4*>(scales + (size_t)grp * N + c0);
        const float4* zp = reinterpret_cast<const float4*>(zs + (size_t)grp * N + c0);
        const float4 s0 = sp[0], s1 = sp[1], z0 = zp[0], z1 = zp[1];
        s[0] = s0.x; s[1] = s0.y; s[2] = s0.z; s[3] = s0.w;
        s[4] = s1.x; s[5] = s1.y; s[6] = s1.z; s[7] = s1.w;
        z[0] = z0.x; z[1] = z0.y; z[2] = z0.z; z[3] = z0.w;
        z[4] = z1.x; z[5] = z1.y; z[6] = z1.z; z[7] = z1.w;
      }
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float qf = static_cast<float>((q[i] >> (4 * j)) & 0xFu);
        v[i] = __fsub_rn(__fmul_rn(qf, s[i]), z[i]);
      }
      store8(out + (size_t)r * N + c0, v);
    }
  }
}

}  // namespace

// packed (ceil(K/8), N) int32 words, scales / zs (>= K/G, N) f32, out (K, N)
// contiguous, bf16 (out_f32 = 0) or f32. Requires N % 8 == 0, G % 8 == 0,
// K % G == 0 and 16-byte aligned pointers (the wrapper checks).
extern "C" int w4_dequant(const void* packed, const void* scales, const void* zs, void* out,
                          int K, int N, int G, int out_f32, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (K < 1 || N < 8 || N % 8 || G < 8 || G % 8 || K % G) return (int)cudaErrorInvalidValue;
  const int words = (K + 7) / 8;
  dim3 grid((N / 8 + THREADS - 1) / THREADS, (words + WPT - 1) / WPT);
  const uint32_t* p = static_cast<const uint32_t*>(packed);
  const float* s = static_cast<const float*>(scales);
  const float* z = static_cast<const float*>(zs);
  if (out_f32) {
    w4_dequant_kernel<float><<<grid, THREADS, 0, st>>>(p, s, z, static_cast<float*>(out), K, N,
                                                       G);
  } else {
    w4_dequant_kernel<bf16><<<grid, THREADS, 0, st>>>(p, s, z, static_cast<bf16*>(out), K, N,
                                                      G);
  }
  return (int)cudaGetLastError();
}
