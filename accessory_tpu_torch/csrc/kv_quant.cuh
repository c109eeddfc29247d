// The int8 quantizing body of the KV-cache writes: bf16 (token, head) vectors
// of HD elements quantized into an int8 pool row and an f32 scale, exactly as
// ops/decode_attention.py::quantize_kv_chunk does (scale = max(amax, 1e-6) /
// 127, q = clip(rint(x / scale), +-127) with IEEE division). kv_write.cu
// (static and stacked caches) and paged_write.cu (paged pools) walk their
// vectors with `quantize_vectors` and keep only their addressing (a Map);
// decode_attention_mha.cu's fused write quantizes its one new token with
// `quantize_piece`.
//
// A thread owns one 16-byte piece (8 bf16) of a vector, so a vector is SEG =
// HD / 8 adjacent lanes: its amax is log2(SEG) xor shuffles inside the
// segment (max is exact in any order), each thread stores its 8 int8 values
// as one 8-byte store, and the segment's first lane stores the scale. A
// thread takes up to U vectors and starts all their loads, then their rows'
// lookups, before the first use; the grid is at most one wave of resident
// blocks, which walk the vectors in a loop (`plan`). A warp's neighbouring
// segments take neighbouring vectors (the Map's order: tokens fastest), so
// its int8 rows and scales land in neighbouring pool rows.
//
// Bound on the H100: bytes (2 * HD read, HD + 4 written per vector). What
// held the one-warp-a-vector design back was not the bytes but the SM's
// quarter-rate pipe (MUFU and int/float conversions, 16 a clock an SM): an
// IEEE division's reciprocal, an F2I a value and three of each per integer
// division of the addressing. So the addressing divides by multiplication
// (FastDiv) and the rounding is an add: clip(rint(v), +-127) as the low byte
// of fminf(fmaxf(v, -127), 127) + 1.5 * 2^23, whose FADD rounds half to even
// (bit-equal to __float2int_rn with the clip for every v, NaN and infinities
// too). The divisions stay true IEEE divisions (`__fdiv_rn`, never a
// reciprocal multiply or --use_fast_math): the int8 pools are bit-equal to the
// plain version's.
#pragma once

#include "common.cuh"

namespace kvq {

constexpr float EPS = 1e-6f;
constexpr int THREADS = 256;
constexpr int U = 4;  // the most vectors a thread takes in one pass

// n / d for 0 <= n < 2^31 by a multiply, an add and a shift (Granlund and
// Montgomery's method: mul = floor(2^32 (2^l - d) / d) + 1, l = ceil(log2 d);
// d = 1 gives mul 1, l 0, so no case is special).
struct FastDiv {
  int d;
  uint32_t mul, shr;
  __device__ __forceinline__ int div(int n) const {
    const uint32_t u = static_cast<uint32_t>(n);
    return static_cast<int>((__umulhi(u, mul) + u) >> shr);
  }
};

inline FastDiv fast_div(int d) {
  int l = 0;
  while ((1LL << l) < d) ++l;
  const uint64_t mul = (1ULL << 32) * ((1ULL << l) - static_cast<uint64_t>(d)) / d + 1;
  return FastDiv{d, static_cast<uint32_t>(mul), static_cast<uint32_t>(l)};
}

// clip(rint(v), +-127) in two's complement in the low byte (see the header)
__device__ __forceinline__ uint32_t rint_clip_byte(float v) {
  return __float_as_uint(fminf(fmaxf(v, -127.f), 127.f) + 12582912.f) & 0xffu;
}

// Quantize this thread's piece of a vector spread over SEG adjacent lanes
// (every lane of the warp calls it: the shuffles take the full mask). q gets
// the 8 int8 values, byte j = element j; returns the vector's scale.
template <int SEG>
__device__ __forceinline__ float quantize_piece(const uint4& raw, uint2& q) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  float x[8], amax = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // a bf16 is the top half of its f32
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(x[j]));
#pragma unroll
  for (int o = SEG / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float sc = __fdiv_rn(fmaxf(amax, EPS), 127.f);
  uint32_t b[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) b[j / 4] |= rint_clip_byte(__fdiv_rn(x[j], sc)) << (8 * (j % 4));
  q = make_uint2(b[0], b[1]);
  return sc;
}

// Vectors [0, total) of one pool: Map gives vector i's first source element
// (`src(i)`, 16-byte aligned) and its pool row (`row(i)`). `un` vectors a
// thread (1..U) a pass, from the launch's plan. Every thread of the block
// runs the loop the same number of times (the shuffles need the whole warp).
template <int HD, class Map>
__device__ __forceinline__ void quantize_vectors(const Map& map, int total, int un,
                                                 int8_t* __restrict__ dst,
                                                 float* __restrict__ dsc) {
  constexpr int SEG = HD / 8;
  static_assert(SEG >= 1 && SEG <= 32 && 32 % SEG == 0, "a vector is 1-32 lanes of a warp");
  const int seg = threadIdx.x / SEG, d8 = (threadIdx.x % SEG) * 8;
  const int vpb = blockDim.x / SEG;  // vectors a block takes per u
  const int tile = vpb * un;
  for (int t0 = blockIdx.x * tile; t0 < total; t0 += gridDim.x * tile) {
    uint4 raw[U];
    size_t row[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = t0 + u * vpb + seg;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (u < un && i < total) raw[u] = *reinterpret_cast<const uint4*>(map.src(i) + d8);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = t0 + u * vpb + seg;
      row[u] = (u < un && i < total) ? map.row(i) : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u >= un) break;
      const int i = t0 + u * vpb + seg;
      uint2 q;
      const float sc = quantize_piece<SEG>(raw[u], q);
      if (i < total) {
        *reinterpret_cast<uint2*>(dst + row[u] * HD + d8) = q;
        if (d8 == 0) dsc[row[u]] = sc;
      }
    }
  }
}

// A launch of quantize_vectors: blocks a pool (grid.x) and vectors a thread.
struct Plan {
  unsigned blocks;
  int un;
};

inline int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 1;
  }();
  return n;
}

// `total` vectors of HD in each of `pools` pools (grid.y), for a kernel of
// which `resident` blocks of THREADS fit an SM: as few vectors a thread as
// lets one wave of resident blocks cover them all (at most U), then as many
// blocks as the vectors need, no more than that wave (the blocks loop).
inline Plan plan(long long total, int hd, int pools, int resident) {
  const long long vpb = THREADS / (hd / 8);
  const long long wave = (long long)sm_count() * (resident > 0 ? resident : 1) / pools;
  const long long cap = wave > 0 ? wave : 1;
  const long long per_block = (total + cap - 1) / cap;
  long long un = (per_block + vpb - 1) / vpb;
  un = un < 1 ? 1 : (un > U ? U : un);
  const long long want = (total + vpb * un - 1) / (vpb * un);
  return Plan{static_cast<unsigned>(want < cap ? want : cap), static_cast<int>(un)};
}

// Blocks of THREADS an SM holds of `kernel`, asked of the runtime once per
// kernel by the caller (a function-local static).
template <class K>
inline int resident_blocks(K kernel) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, 0);
  return n > 0 ? n : 1;
}

}  // namespace kvq
