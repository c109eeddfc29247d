// KV-cache slab writes: a prefill chunk's K and V into the per-layer cache,
// as bf16 (kv_write_slab) or quantized to int8 on the way (kv_write_slab_q8).
//
// Replaces: accessory_tpu/ops/decode_attention.py::_write_slab_layer (Pallas
// kernel `_write_kernel4`, via write_kv_layer) and ::_write_slab_layer_q8
// (Pallas kernel `_write_kernel4_q8`, via write_kv_layer8).
//
// Copies new K/V (B, sq, NKV, HD), given with batch and token strides so a
// strided view of the fused qkv projection needs no copy, into the caches
// (B, NKV, S, HD) at token rows [pos, pos + sq). Both pools go in one launch
// (blockIdx.y selects the pool). Any sq and any pos are served: the TPU
// kernel's 128-aligned pos rule was a lane-tiling constraint.
//
// Bound on the H100: bytes (each element is read once and written once).
// Each thread moves 16 bytes; neighbouring threads take neighbouring 16-byte
// pieces of one token's heads, so reads are contiguous per token and writes
// are contiguous per (head, token) row of HD * 2 bytes.
//
// The int8 form. The TPU kernel is four DMAs of a chunk that XLA quantized in
// a pass before it. On this card such a pass would write the quantized chunk
// and read it back, so the kernel takes the bf16 chunk itself (the same
// strided views) and quantizes on the way: one warp per (token, head) vector
// reads it as one contiguous row, reduces its amax by shuffles, and writes
// the int8 row (scale = max(amax, 1e-6) / 127, q = clip(rint(x / scale),
// +-127), IEEE division) and the f32 scale into the pools; k and v pools and
// their scale pools all go in one launch. Bound: bytes (2 * HD read, HD + 4
// written per vector).

#include "common.cuh"

namespace {

__global__ void kv_write_kernel(const bf16* __restrict__ nk, long long nk_bs, long long nk_ts,
                                const bf16* __restrict__ nv, long long nv_bs, long long nv_ts,
                                bf16* __restrict__ ck, bf16* __restrict__ cv, int B, int sq,
                                int NKV, int HD, int S, int pos) {
  const bf16* src = blockIdx.y == 0 ? nk : nv;
  const long long bs = blockIdx.y == 0 ? nk_bs : nv_bs;
  const long long ts = blockIdx.y == 0 ? nk_ts : nv_ts;
  bf16* dst = blockIdx.y == 0 ? ck : cv;
  const int v8 = HD / 8;
  const long long total = (long long)B * sq * NKV * v8;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int d8 = (int)(i % v8) * 8;
    const int h = (int)((i / v8) % NKV);
    const int s = (int)((i / ((long long)v8 * NKV)) % sq);
    const int b = (int)(i / ((long long)v8 * NKV * sq));
    const uint4 val = *reinterpret_cast<const uint4*>(src + b * bs + s * ts + (long long)h * HD + d8);
    *reinterpret_cast<uint4*>(dst + (((size_t)b * NKV + h) * S + pos + s) * HD + d8) = val;
  }
}

// An integer type of BYTES bytes, for one aligned load or store.
template <int BYTES> struct Vec;
template <> struct Vec<2> { typedef uint16_t type; };
template <> struct Vec<4> { typedef uint32_t type; };
template <> struct Vec<8> { typedef uint2 type; };
template <> struct Vec<16> { typedef uint4 type; };

// One warp per (b, s, h) vector; each lane holds DPL = HD / 32 neighbouring
// elements (one 4/8/16-byte load, one 2/4/8-byte store).
template <int DPL>
__global__ void kv_write_q8_kernel(const bf16* __restrict__ nk, long long nk_bs, long long nk_ts,
                                   const bf16* __restrict__ nv, long long nv_bs, long long nv_ts,
                                   int8_t* __restrict__ ck, int8_t* __restrict__ cv,
                                   float* __restrict__ cks, float* __restrict__ cvs, int B,
                                   int sq, int NKV, int S, int pos) {
  constexpr int HD = DPL * 32;
  const bf16* src = blockIdx.y == 0 ? nk : nv;
  const long long bs = blockIdx.y == 0 ? nk_bs : nv_bs;
  const long long ts = blockIdx.y == 0 ? nk_ts : nv_ts;
  int8_t* dst = blockIdx.y == 0 ? ck : cv;
  float* dsc = blockIdx.y == 0 ? cks : cvs;
  const int lane = threadIdx.x & 31;
  const int wpb = blockDim.x >> 5;
  const long long total = (long long)B * sq * NKV;
  for (long long i = blockIdx.x * (long long)wpb + (threadIdx.x >> 5); i < total;
       i += (long long)gridDim.x * wpb) {
    const int h = (int)(i % NKV);
    const int s = (int)((i / NKV) % sq);
    const int b = (int)(i / ((long long)NKV * sq));
    const typename Vec<2 * DPL>::type raw = *reinterpret_cast<const typename Vec<2 * DPL>::type*>(
        src + b * bs + s * ts + (long long)h * HD + lane * DPL);
    const bf16* rv = reinterpret_cast<const bf16*>(&raw);
    float x[DPL], amax = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      x[j] = bf2f(rv[j]);
      amax = fmaxf(amax, fabsf(x[j]));
    }
    amax = warp_max(amax);
    const float sc = __fdiv_rn(fmaxf(amax, 1e-6f), 127.f);
    typename Vec<DPL>::type qraw;
    int8_t* qv = reinterpret_cast<int8_t*>(&qraw);
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int qi = __float2int_rn(__fdiv_rn(x[j], sc));
      qv[j] = (int8_t)max(-127, min(127, qi));
    }
    const size_t tok = ((size_t)b * NKV + h) * S + pos + s;
    *reinterpret_cast<typename Vec<DPL>::type*>(dst + tok * HD + lane * DPL) = qraw;
    if (lane == 0) dsc[tok] = sc;
  }
}

}  // namespace

// Requires HD % 8 == 0, 16-byte aligned sources with strides that are
// multiples of 8 elements, and pos + sq <= S.
extern "C" int kv_write_slab(const void* nk, long long nk_bs, long long nk_ts, const void* nv,
                             long long nv_bs, long long nv_ts, void* cache_k, void* cache_v,
                             int B, int sq, int NKV, int HD, int S, int pos, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (HD % 8 != 0 || pos < 0 || sq < 1 || pos + sq > S) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * sq * NKV * (HD / 8);
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  dim3 grid((unsigned)(want < 4096 ? want : 4096), 2);
  kv_write_kernel<<<grid, threads, 0, st>>>(
      static_cast<const bf16*>(nk), nk_bs, nk_ts, static_cast<const bf16*>(nv), nv_bs, nv_ts,
      static_cast<bf16*>(cache_k), static_cast<bf16*>(cache_v), B, sq, NKV, HD, S, pos);
  return (int)cudaGetLastError();
}

// The int8 form: nk/nv as above (bf16, strided); cache_k/cache_v int8
// (B, NKV, S, HD) and cache_ks/cache_vs f32 (B, NKV, S), all contiguous.
// Requires HD in {64, 128, 256}, sources aligned to HD / 16 bytes with
// strides that are multiples of HD / 32 elements, and pos + sq <= S.
extern "C" int kv_write_slab_q8(const void* nk, long long nk_bs, long long nk_ts, const void* nv,
                                long long nv_bs, long long nv_ts, void* cache_k, void* cache_v,
                                void* cache_ks, void* cache_vs, int B, int sq, int NKV, int HD,
                                int S, int pos, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (pos < 0 || sq < 1 || pos + sq > S) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * sq * NKV;
  const int threads = 256, wpb = threads / 32;
  const long long want = (total + wpb - 1) / wpb;
  dim3 grid((unsigned)(want < 16384 ? want : 16384), 2);
  const bf16* k = static_cast<const bf16*>(nk);
  const bf16* v = static_cast<const bf16*>(nv);
  int8_t* ck = static_cast<int8_t*>(cache_k);
  int8_t* cv = static_cast<int8_t*>(cache_v);
  float* ks = static_cast<float*>(cache_ks);
  float* vs = static_cast<float*>(cache_vs);
  if (HD == 64) {
    kv_write_q8_kernel<2><<<grid, threads, 0, st>>>(k, nk_bs, nk_ts, v, nv_bs, nv_ts, ck, cv, ks,
                                                    vs, B, sq, NKV, S, pos);
  } else if (HD == 128) {
    kv_write_q8_kernel<4><<<grid, threads, 0, st>>>(k, nk_bs, nk_ts, v, nv_bs, nv_ts, ck, cv, ks,
                                                    vs, B, sq, NKV, S, pos);
  } else if (HD == 256) {
    kv_write_q8_kernel<8><<<grid, threads, 0, st>>>(k, nk_bs, nk_ts, v, nv_bs, nv_ts, ck, cv, ks,
                                                    vs, B, sq, NKV, S, pos);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
