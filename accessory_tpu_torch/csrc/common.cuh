// Shared helpers for the port's Hopper kernels: bf16 conversions, the
// bf16 mma.sync wrapper, and the error-string export every library carries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define NEG_INF_F (-1e30f)

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }

// Round a float through bf16 (what a cast to the activation dtype does).
__device__ __forceinline__ float round_bf16(float v) { return bf2f(f2bf(v)); }

// Two floats -> one 32-bit register of two bf16 (lo = first element).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16_pair(bf16 lo, bf16 hi) {
  uint16_t l = *reinterpret_cast<uint16_t*>(&lo);
  uint16_t h = *reinterpret_cast<uint16_t*>(&hi);
  return static_cast<uint32_t>(l) | (static_cast<uint32_t>(h) << 16);
}

// D (16x8 f32) += A (16x16 bf16, row) * B (16x8 bf16, col).
// Fragments (g = lane / 4, t = lane % 4):
//   a0 (row g, k 2t..2t+1)  a1 (row g+8, k 2t..)  a2 (row g, k 2t+8..)  a3 (row g+8, k 2t+8..)
//   b0 (k 2t..2t+1, col g)  b1 (k 2t+8..2t+9, col g)
//   d0,d1 (row g, cols 2t, 2t+1)  d2,d3 (row g+8, cols 2t, 2t+1)
__device__ __forceinline__ void mma_bf16_16816(float d[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
