// Fused MHA (one query head per KV head) decode attention + KV-cache write of
// the new token, over a bf16 cache or an int8 cache with per-token f32 scales,
// and the same attention with the cache only read.
//
// Replaces: accessory_tpu/ops/decode_attention.py::_kernel_hgrp_w (via
// _decode_attn_hgrp_w / decode_attention_update, with _hgrp_common) and its
// int8 form _kernel_hgrp_w8 (via _decode_attn_hgrp_w8 /
// decode_attention_update8). With the compile-time WRITE switch off it is
// the read-only attention of _kernel_bloop / _kernel (cached_attention_t) and
// _kernel_bloop8 (cached_attention_t8) at one query row per KV head, where
// the JAX package has no head-grouped read-only kernel of its own.
//
// The TPU kernels group G heads per program because a lone (1, S) softmax row
// fills one of eight sublanes. This card's form of that problem: the GQA
// kernel (decode_attention.cu) gives each warp of a block one query row, so
// with a single row per KV head seven of its eight warps would only help to
// load. Here the work spread over a block's warps is the cached tokens.
//
// One block per (batch row, head), eight warps. A token's cached vector is one
// contiguous row of the (B, NKV, S, HD) cache: 16 (bf16, HD 128) or 8 (int8)
// lanes read it with one 16-byte load each, so one warp-wide load covers 2-8
// tokens, each held by a sub-group of lanes; a lane keeps its own slice of q
// in registers. Warp w takes the token steps w, w + 8, w + 16, ... (16 tokens
// per step at HD 128) straight from global memory, with all of a step's K and
// V loads started before the first use, and keeps a running max, sum and
// output slice per sub-group (an online softmax). Sub-groups merge by
// shuffles, the eight warps through 4 KB of shared memory, and the new token's
// k/v, not yet cached, join exactly as the second part of the softmax, as in
// the TPU kernels. No K/V staging in shared memory is needed: with one query
// row nothing is read twice. This was chosen over "one warp per head, several
// heads per block" because it keeps 8 x 16 x 32 sixteen-byte loads in flight
// per block whatever the batch, where one warp per head leaves a short cache
// with too few loads in flight to cover the memory latency.
//
// int8 form: a 16-byte load carries 16 values. The token's k scale multiplies
// the score (with the softmax scale), the v scale multiplies p before p is
// rounded to bf16 for the value product, never each element. The new token's
// vectors are amax-reduced by a warp each, quantized (scale =
// max(amax, 1e-6) / 127, q = clip(rint(x / scale), +-127), IEEE division) and
// written with their two scales.
//
// Probabilities are rounded to bf16 before the P.V product as in the TPU
// kernels (there relative to the row's max, here to the running max of the
// sub-group). The write at index pos happens in the same launch; reads never
// touch an index >= pos and a block owns its (b, head) slice, so there is no
// race. Any cache length S.
//
// Bound on the H100: bytes, 2 * pos * HD * 2 per (b, head) over the bf16
// cache; about half of that plus 8 bytes of scales per token over int8.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr float KV_SCALE_EPS = 1e-6f;

// A pool pointer: written by the fused kernels, const for the read-only ones.
template <bool WRITE, typename X>
using Pool = typename std::conditional<WRITE, X, const X>::type*;

// element j of a 16-byte load as float
template <typename CT, int EPL>
__device__ __forceinline__ void unpack16(const uint4& raw, float (&f)[EPL]);

template <>
__device__ __forceinline__ void unpack16<bf16, 8>(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __low2float(p[j]);
    f[2 * j + 1] = __high2float(p[j]);
  }
}

template <>
__device__ __forceinline__ void unpack16<int8_t, 16>(const uint4& raw, float (&f)[16]) {
  const int8_t* p = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int j = 0; j < 16; ++j) f[j] = (float)p[j];
}

// merge two online-softmax states (m, l, acc) held by lane pairs `off` apart
template <int EPL>
__device__ __forceinline__ void merge_lanes(float& m, float& l, float (&acc)[EPL], int off) {
  const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
  const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
  const float m_new = fmaxf(m, m_o);
  const float c = expf(m - m_new), c_o = expf(m_o - m_new);
  l = l * c + l_o * c_o;
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const float a_o = __shfl_xor_sync(0xffffffffu, acc[j], off);
    acc[j] = acc[j] * c + a_o * c_o;
  }
  m = m_new;
}

template <int HD, typename CT, bool WRITE>
__global__ void __launch_bounds__(THREADS)
decode_attn_mha_kernel(const bf16* __restrict__ q, long long q_bstride,
                       const bf16* __restrict__ kn, long long kn_bstride,
                       const bf16* __restrict__ vn, long long vn_bstride,
                       Pool<WRITE, CT> __restrict__ cache_k,
                       Pool<WRITE, CT> __restrict__ cache_v,
                       Pool<WRITE, float> __restrict__ cache_ks,
                       Pool<WRITE, float> __restrict__ cache_vs,
                       int NKV, int S, int pos, float scale, bf16* __restrict__ out) {
  constexpr bool INT8 = sizeof(CT) == 1;
  constexpr int EPL = 16 / sizeof(CT);   // elements of one 16-byte load
  constexpr int LPT = HD / EPL;          // lanes per token
  constexpr int TPW = 32 / LPT;          // tokens per warp-wide load
  constexpr int U = INT8 ? 4 : 8;        // tokens per sub-group per step
  constexpr int STEP = U * TPW;          // tokens per warp per step
  __shared__ float sm_acc[NWARPS][HD];
  __shared__ float sm_m[NWARPS], sm_l[NWARPS];
  __shared__ float sm_snew;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / LPT, d0 = (lane % LPT) * EPL;
  const bf16* qb = q + b * q_bstride + (size_t)h * HD;
  const bf16* knb = kn + b * kn_bstride + (size_t)h * HD;
  const bf16* vnb = vn + b * vn_bstride + (size_t)h * HD;
  const size_t cbase = ((size_t)b * NKV + h) * (size_t)S * HD;
  const size_t sbase = ((size_t)b * NKV + h) * (size_t)S;

  float qf[EPL];
#pragma unroll
  for (int j = 0; j < EPL; j += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(qb + d0 + j);
    unpack16<bf16, 8>(raw, *reinterpret_cast<float(*)[8]>(&qf[j]));
  }

  if (warp == 0) {   // the new token's score, exact f32
    float dot = 0.f;
    for (int d = lane; d < HD; d += 32) dot += bf2f(qb[d]) * bf2f(knb[d]);
    dot = warp_sum(dot);
    if (lane == 0) sm_snew = dot * scale;
  }

  float m_run = NEG_INF_F, l_run = 0.f, acc[EPL];
#pragma unroll
  for (int j = 0; j < EPL; ++j) acc[j] = 0.f;

  for (int t0 = warp * STEP; t0 < pos; t0 += NWARPS * STEP) {
    uint4 kr[U], vr[U];
    float ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int tok = t0 + u * TPW + sub;
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      vr[u] = kr[u];
      ksc[u] = vsc[u] = 1.f;
      if (tok < pos) {
        const size_t off = cbase + (size_t)tok * HD + d0;
        kr[u] = *reinterpret_cast<const uint4*>(cache_k + off);
        vr[u] = *reinterpret_cast<const uint4*>(cache_v + off);
        if (INT8) {
          ksc[u] = cache_ks[sbase + tok];
          vsc[u] = cache_vs[sbase + tok];
        }
      }
    }
    float s[U];
    float mx = NEG_INF_F;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EPL];
      unpack16<CT, EPL>(kr[u], kf);
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < EPL; ++j) dot += qf[j] * kf[j];
#pragma unroll
      for (int o = LPT / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const bool valid = t0 + u * TPW + sub < pos;
      s[u] = valid ? dot * (INT8 ? ksc[u] * scale : scale) : NEG_INF_F;
      mx = fmaxf(mx, s[u]);
    }
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(m_run - m_new);
    l_run *= corr;
#pragma unroll
    for (int j = 0; j < EPL; ++j) acc[j] *= corr;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // a sub-group with no valid token yet has m_new == NEG_INF_F: p must be 0, not exp(0)
      const bool valid = t0 + u * TPW + sub < pos;
      const float p = valid ? expf(s[u] - m_new) : 0.f;
      l_run += p;
      const float pv = round_bf16(INT8 ? p * vsc[u] : p);
      float vf[EPL];
      unpack16<CT, EPL>(vr[u], vf);
#pragma unroll
      for (int j = 0; j < EPL; ++j) acc[j] += pv * vf[j];
    }
    m_run = m_new;
  }

#pragma unroll
  for (int off = LPT; off < 32; off <<= 1) merge_lanes<EPL>(m_run, l_run, acc, off);
  if (sub == 0) {
#pragma unroll
    for (int j = 0; j < EPL; ++j) sm_acc[warp][d0 + j] = acc[j];
    if (lane == 0) {
      sm_m[warp] = m_run;
      sm_l[warp] = l_run;
    }
  }
  __syncthreads();

  // merge the warps; the new token is the second part of the softmax
  if (tid < HD) {
    const float s_new = sm_snew;
    float m_all = s_new;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) m_all = fmaxf(m_all, sm_m[w]);
    const float p_new = expf(s_new - m_all);
    float denom = p_new, o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float c = expf(sm_m[w] - m_all);
      denom += sm_l[w] * c;
      o += sm_acc[w][tid] * c;
    }
    o += p_new * bf2f(vnb[tid]);
    out[((size_t)b * NKV + h) * HD + tid] = f2bf(o / denom);
  }

  // in-place write of the new token at index pos
  if constexpr (WRITE) {
    const size_t woff = cbase + (size_t)pos * HD;
    if constexpr (!INT8) {
      for (int i = tid; i < 2 * (HD / 8); i += THREADS) {
        const int d8 = (i % (HD / 8)) * 8;
        if (i < HD / 8)
          *reinterpret_cast<uint4*>(cache_k + woff + d8) =
              *reinterpret_cast<const uint4*>(knb + d8);
        else
          *reinterpret_cast<uint4*>(cache_v + woff + d8) =
              *reinterpret_cast<const uint4*>(vnb + d8);
      }
    } else if (warp < 2) {
      constexpr int DPL = HD / 32;
      const bf16* src = warp == 0 ? knb : vnb;
      int8_t* dst = (warp == 0 ? cache_k : cache_v) + woff;
      float xv[DPL], amax = 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        xv[j] = bf2f(src[lane * DPL + j]);
        amax = fmaxf(amax, fabsf(xv[j]));
      }
      amax = warp_max(amax);
      const float sc = __fdiv_rn(fmaxf(amax, KV_SCALE_EPS), 127.f);
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int qv = __float2int_rn(__fdiv_rn(xv[j], sc));
        dst[lane * DPL + j] = (int8_t)max(-127, min(127, qv));
      }
      if (lane == 0) (warp == 0 ? cache_ks : cache_vs)[sbase + pos] = sc;
    }
  }
}

template <typename CT, bool WRITE>
cudaError_t launch(const void* q, long long q_bstride, const void* kn, long long kn_bstride,
                   const void* vn, long long vn_bstride, const void* cache_k,
                   const void* cache_v, const void* cache_ks, const void* cache_vs, int B,
                   int NKV, int S, int HD, int pos, float scale, void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // the fused kernels write index pos; a read-only call may find the cache full
  if (B < 1 || NKV < 1 || pos < 0 || pos > (WRITE ? S - 1 : S)) return cudaErrorInvalidValue;
  dim3 grid(NKV, B);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(kn);
  const bf16* vp = static_cast<const bf16*>(vn);
  Pool<WRITE, CT> ck = static_cast<Pool<WRITE, CT>>(const_cast<void*>(cache_k));
  Pool<WRITE, CT> cv = static_cast<Pool<WRITE, CT>>(const_cast<void*>(cache_v));
  Pool<WRITE, float> ks = static_cast<Pool<WRITE, float>>(const_cast<void*>(cache_ks));
  Pool<WRITE, float> vs = static_cast<Pool<WRITE, float>>(const_cast<void*>(cache_vs));
  bf16* o = static_cast<bf16*>(out);
  if (HD == 64) {
    decode_attn_mha_kernel<64, CT, WRITE><<<grid, THREADS, 0, st>>>(
        qp, q_bstride, kp, kn_bstride, vp, vn_bstride, ck, cv, ks, vs, NKV, S, pos, scale, o);
  } else if (HD == 128) {
    decode_attn_mha_kernel<128, CT, WRITE><<<grid, THREADS, 0, st>>>(
        qp, q_bstride, kp, kn_bstride, vp, vn_bstride, ck, cv, ks, vs, NKV, S, pos, scale, o);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q, kn, vn: (B, NKV*HD) bf16 rows with batch strides in elements (multiples
// of 8, 16-byte aligned); caches (B, NKV, S, HD) contiguous, 16-byte aligned;
// out (B, NKV, HD) bf16 contiguous. Requires HD in {64, 128}, 0 <= pos < S.
extern "C" int decode_attention_mha(const void* q, long long q_bstride, const void* kn,
                                    long long kn_bstride, const void* vn, long long vn_bstride,
                                    void* cache_k, void* cache_v, int B, int NKV, int S, int HD,
                                    int pos, float scale, void* out, void* stream) {
  return (int)launch<bf16, true>(q, q_bstride, kn, kn_bstride, vn, vn_bstride, cache_k, cache_v,
                                 nullptr, nullptr, B, NKV, S, HD, pos, scale, out, stream);
}

// The same over int8 caches with f32 scale pools cache_ks / cache_vs
// (B, NKV, S) contiguous.
extern "C" int decode_attention_mha8(const void* q, long long q_bstride, const void* kn,
                                     long long kn_bstride, const void* vn, long long vn_bstride,
                                     void* cache_k, void* cache_v, void* cache_ks,
                                     void* cache_vs, int B, int NKV, int S, int HD, int pos,
                                     float scale, void* out, void* stream) {
  return (int)launch<int8_t, true>(q, q_bstride, kn, kn_bstride, vn, vn_bstride, cache_k,
                                   cache_v, cache_ks, cache_vs, B, NKV, S, HD, pos, scale, out,
                                   stream);
}

// The two attentions with the pools only read (0 <= pos <= S).
extern "C" int decode_attention_mha_ro(const void* q, long long q_bstride, const void* kn,
                                       long long kn_bstride, const void* vn,
                                       long long vn_bstride, const void* cache_k,
                                       const void* cache_v, int B, int NKV, int S, int HD,
                                       int pos, float scale, void* out, void* stream) {
  return (int)launch<bf16, false>(q, q_bstride, kn, kn_bstride, vn, vn_bstride, cache_k, cache_v,
                                  nullptr, nullptr, B, NKV, S, HD, pos, scale, out, stream);
}

extern "C" int decode_attention_mha8_ro(const void* q, long long q_bstride, const void* kn,
                                        long long kn_bstride, const void* vn,
                                        long long vn_bstride, const void* cache_k,
                                        const void* cache_v, const void* cache_ks,
                                        const void* cache_vs, int B, int NKV, int S, int HD,
                                        int pos, float scale, void* out, void* stream) {
  return (int)launch<int8_t, false>(q, q_bstride, kn, kn_bstride, vn, vn_bstride, cache_k,
                                    cache_v, cache_ks, cache_vs, B, NKV, S, HD, pos, scale, out,
                                    stream);
}
