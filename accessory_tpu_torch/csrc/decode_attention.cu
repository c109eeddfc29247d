// GQA decode attention over the static KV cache, bf16 or int8 with per-token
// f32 scales, fused with the cache write of the new token or read-only.
//
// Replaces, in accessory_tpu/ops/decode_attention.py:
//   _kernel_bloop_w   (via _decode_attn_bloop_w / decode_attention_update)
//   _kernel_bloop_w8  (via _decode_attn_bloop_w8 / decode_attention_update8)
//   _kernel_bloop     (via _decode_attn_bloop / cached_attention_t) and
//   _kernel           (via _decode_attn_pallas, the same function on a
//                      (B, NKV) grid, which is this kernel's own launch shape)
//   _kernel_bloop8    (via _decode_attn_bloop8 / cached_attention_t8)
// One kernel body, two compile-time switches: the cache's element type and
// WRITE (with it off the pools are only read).
//
// One block per (kv head, batch row). The R = NQ / NKV query rows of the
// group share every K/V read. Cached tokens with index < pos are read from
// the (B, NKV, S, HD) bf16 cache in chunks of 64 tokens (one 128-byte row per
// token at HD 64), scored in f32, and folded into an online softmax; the new
// token's k/v (not yet in the cache) enter exactly, as the second part of the
// softmax, as in the TPU kernel. Probabilities are rounded to bf16 before the
// P.V product (the TPU kernel's p_old.astype(bf16)); the new token's term
// stays f32. The same launch then writes k/v at index pos. Reads never touch
// index >= pos and only this block owns its (b, head) slice, so there is no
// race. Any cache length S is served (no S % 128 rule).
//
// int8 form: a token's cached row is HD bytes, so a 16-byte load carries 16
// values; they are widened to bf16 (exact) as they are staged, and the score
// and P.V loops are the bf16 form's. The token's k scale multiplies the score
// (with the softmax scale) after the dot, the v scale multiplies p before p
// is rounded to bf16, never an element (the TPU kernel's rank-1 epilogues).
// With WRITE the new token's k and v are amax-reduced by a warp each,
// quantized (scale = max(amax, 1e-6) / 127, q = clip(rint(x / scale), +-127),
// IEEE division) and stored with their two f32 scales at index pos, after
// the block's last read.
//
// Bound on the H100: bytes. Per step the kernel must read 2 * pos * HD * 2
// bytes per (b, kv head); the design reads each cached byte once with 16-byte
// loads into shared memory, and each warp owns one query row so the score and
// P.V loops read shared memory without bank conflicts. One block per
// (b, head) is 32 blocks at the decode shape, which under-fills 132 SMs; a
// split over the sequence is the next step for long caches.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int T = 64;          // tokens per chunk
constexpr float KV_SCALE_EPS = 1e-6f;

// A pool pointer: written by the fused kernels, const for the read-only ones.
template <bool WRITE, typename X>
using Pool = typename std::conditional<WRITE, X, const X>::type*;

template <int HD, typename CT, bool WRITE>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const bf16* __restrict__ q, long long q_bstride,
                   const bf16* __restrict__ kn, long long kn_bstride,
                   const bf16* __restrict__ vn, long long vn_bstride,
                   Pool<WRITE, CT> __restrict__ cache_k, Pool<WRITE, CT> __restrict__ cache_v,
                   Pool<WRITE, float> __restrict__ cache_ks,
                   Pool<WRITE, float> __restrict__ cache_vs,
                   int NKV, int S, int R, int pos, float scale, bf16* __restrict__ out) {
  constexpr bool INT8 = sizeof(CT) == 1;
  constexpr int EPL = 16 / sizeof(CT);  // cached elements per 16-byte load
  constexpr int KLD = HD + 2;          // padded K row (bf16): odd word stride
  constexpr int DPL = HD / 32;         // dims per lane in the P.V loop
  constexpr int MAXR = HD == 64 ? 32 : 16;  // query rows per kv head
  constexpr int MAX_RPW = MAXR / NWARPS;    // query rows per warp
  __shared__ float qs[MAXR][HD];
  __shared__ __align__(16) bf16 Ks[T][KLD];
  __shared__ __align__(16) bf16 Vs[T][HD];
  __shared__ float ps[NWARPS][T];
  __shared__ float kss[INT8 ? T : 1], vss[INT8 ? T : 1];  // the chunk's token scales

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* qb = q + b * q_bstride + (size_t)h * R * HD;
  for (int i = tid; i < R * HD; i += THREADS) qs[i / HD][i % HD] = bf2f(qb[i]);
  __syncthreads();
  const size_t cbase = ((size_t)b * NKV + h) * (size_t)S * HD;
  const size_t sbase = ((size_t)b * NKV + h) * (size_t)S;

  float m_run[MAX_RPW], l_run[MAX_RPW], acc[MAX_RPW][DPL];
#pragma unroll
  for (int i = 0; i < MAX_RPW; ++i) {
    m_run[i] = NEG_INF_F;
    l_run[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[i][d] = 0.f;
  }

  for (int t0 = 0; t0 < pos; t0 += T) {
    const int nt = min(T, pos - t0);
    __syncthreads();
    for (int i = tid; i < T * HD / EPL; i += THREADS) {
      const int tok = i / (HD / EPL), d0 = (i % (HD / EPL)) * EPL;
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
      if (tok < nt) {
        const size_t off = cbase + (size_t)(t0 + tok) * HD + d0;
        kr = *reinterpret_cast<const uint4*>(cache_k + off);
        vr = *reinterpret_cast<const uint4*>(cache_v + off);
      }
      uint32_t* krow = reinterpret_cast<uint32_t*>(&Ks[tok][d0]);
      if constexpr (INT8) {
        // 16 int8 values each: widened to bf16 (exact) on the way in
        const int8_t* k8 = reinterpret_cast<const int8_t*>(&kr);
        const int8_t* v8 = reinterpret_cast<const int8_t*>(&vr);
        uint32_t vw[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          krow[j] = pack_bf16x2((float)k8[2 * j], (float)k8[2 * j + 1]);
          vw[j] = pack_bf16x2((float)v8[2 * j], (float)v8[2 * j + 1]);
        }
        uint4* vrow = reinterpret_cast<uint4*>(&Vs[tok][d0]);
        vrow[0] = make_uint4(vw[0], vw[1], vw[2], vw[3]);
        vrow[1] = make_uint4(vw[4], vw[5], vw[6], vw[7]);
      } else {
        const uint32_t* kw = reinterpret_cast<const uint32_t*>(&kr);
#pragma unroll
        for (int j = 0; j < 4; ++j) krow[j] = kw[j];
        *reinterpret_cast<uint4*>(&Vs[tok][d0]) = vr;
      }
    }
    if (INT8 && tid < T) {
      kss[tid] = tid < nt ? cache_ks[sbase + t0 + tid] : 1.f;
      vss[tid] = tid < nt ? cache_vs[sbase + t0 + tid] : 1.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MAX_RPW; ++i) {
      const int r = warp + i * NWARPS;
      if (r >= R) break;
      float s[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int tok = lane + half * 32;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; d += 2) {
          const __nv_bfloat162 kk = *reinterpret_cast<const __nv_bfloat162*>(&Ks[tok][d]);
          dot += qs[r][d] * __low2float(kk) + qs[r][d + 1] * __high2float(kk);
        }
        s[half] = tok < nt ? dot * (INT8 ? kss[tok] * scale : scale) : NEG_INF_F;
      }
      const float m_new = fmaxf(m_run[i], warp_max(fmaxf(s[0], s[1])));
      const float corr = expf(m_run[i] - m_new);
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      l_run[i] = l_run[i] * corr + warp_sum(p0 + p1);
      m_run[i] = m_new;
      ps[warp][lane] = round_bf16(INT8 ? p0 * vss[lane] : p0);
      ps[warp][lane + 32] = round_bf16(INT8 ? p1 * vss[lane + 32] : p1);
      __syncwarp();
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[i][d] *= corr;
      for (int tok = 0; tok < nt; ++tok) {
        const float p = ps[warp][tok];
#pragma unroll
        for (int d = 0; d < DPL; d += 2) {
          const __nv_bfloat162 vv =
              *reinterpret_cast<const __nv_bfloat162*>(&Vs[tok][(lane * DPL) + d]);
          acc[i][d] += p * __low2float(vv);
          acc[i][d + 1] += p * __high2float(vv);
        }
      }
      __syncwarp();
    }
  }

  // the new token: second part of the softmax, exact f32
  const bf16* knb = kn + b * kn_bstride + (size_t)h * HD;
  const bf16* vnb = vn + b * vn_bstride + (size_t)h * HD;
#pragma unroll
  for (int i = 0; i < MAX_RPW; ++i) {
    const int r = warp + i * NWARPS;
    if (r >= R) break;
    float dot = 0.f;
    for (int d = lane; d < HD; d += 32) dot += qs[r][d] * bf2f(knb[d]);
    const float s_new = warp_sum(dot) * scale;
    const float m_new = fmaxf(m_run[i], s_new);
    const float corr = expf(m_run[i] - m_new);
    const float p_new = expf(s_new - m_new);
    const float denom = l_run[i] * corr + p_new;
    bf16* ob = out + (((size_t)b * NKV + h) * R + r) * HD;
#pragma unroll
    for (int d = 0; d < DPL; ++d) {
      const int dd = lane * DPL + d;
      ob[dd] = f2bf((acc[i][d] * corr + p_new * bf2f(vnb[dd])) / denom);
    }
  }

  // in-place write of the new token at index pos (no block reads that index)
  if constexpr (WRITE) {
    const size_t woff = cbase + (size_t)pos * HD;
    if constexpr (!INT8) {
      for (int d = tid; d < HD; d += THREADS) {
        cache_k[woff + d] = knb[d];
        cache_v[woff + d] = vnb[d];
      }
    } else if (warp < 2) {   // warp 0 quantizes k, warp 1 v
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
                   int NKV, int S, int R, int HD, int pos, float scale, void* out,
                   void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // the fused kernels write index pos; a read-only call may find the cache full
  if (B < 1 || NKV < 1 || R < 1 || R > (HD == 64 ? 32 : 16) || pos < 0 ||
      pos > (WRITE ? S - 1 : S))
    return cudaErrorInvalidValue;
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
    decode_attn_kernel<64, CT, WRITE><<<grid, THREADS, 0, st>>>(
        qp, q_bstride, kp, kn_bstride, vp, vn_bstride, ck, cv, ks, vs, NKV, S, R, pos, scale, o);
  } else if (HD == 128) {
    decode_attn_kernel<128, CT, WRITE><<<grid, THREADS, 0, st>>>(
        qp, q_bstride, kp, kn_bstride, vp, vn_bstride, ck, cv, ks, vs, NKV, S, R, pos, scale, o);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q: (B, NKV*R*HD) rows with batch stride q_bstride (elements); kn/vn: (B,
// NKV*HD) rows with their batch strides; caches (B, NKV, S, HD) contiguous,
// 16-byte aligned; out (B, NKV, R, HD) contiguous. Requires HD in {64, 128},
// R <= 32 (HD 64) or 16 (HD 128), 0 <= pos < S. Attends, then writes k/v at pos.
extern "C" int decode_attention(const void* q, long long q_bstride, const void* kn,
                                long long kn_bstride, const void* vn, long long vn_bstride,
                                void* cache_k, void* cache_v, int B, int NKV, int S, int R,
                                int HD, int pos, float scale, void* out, void* stream) {
  return (int)launch<bf16, true>(q, q_bstride, kn, kn_bstride, vn, vn_bstride, cache_k, cache_v,
                                 nullptr, nullptr, B, NKV, S, R, HD, pos, scale, out, stream);
}

// The same attention with the caches only read (0 <= pos <= S).
extern "C" int decode_attention_ro(const void* q, long long q_bstride, const void* kn,
                                   long long kn_bstride, const void* vn, long long vn_bstride,
                                   const void* cache_k, const void* cache_v, int B, int NKV,
                                   int S, int R, int HD, int pos, float scale, void* out,
                                   void* stream) {
  return (int)launch<bf16, false>(q, q_bstride, kn, kn_bstride, vn, vn_bstride, cache_k, cache_v,
                                  nullptr, nullptr, B, NKV, S, R, HD, pos, scale, out, stream);
}

// Over int8 caches (B, NKV, S, HD) with f32 scale pools cache_ks / cache_vs
// (B, NKV, S) contiguous: attends, then quantizes k/v and writes them and
// their two scales at pos.
extern "C" int decode_attention8(const void* q, long long q_bstride, const void* kn,
                                 long long kn_bstride, const void* vn, long long vn_bstride,
                                 void* cache_k, void* cache_v, void* cache_ks, void* cache_vs,
                                 int B, int NKV, int S, int R, int HD, int pos, float scale,
                                 void* out, void* stream) {
  return (int)launch<int8_t, true>(q, q_bstride, kn, kn_bstride, vn, vn_bstride, cache_k,
                                   cache_v, cache_ks, cache_vs, B, NKV, S, R, HD, pos, scale,
                                   out, stream);
}

// The int8 attention with the four pools only read (0 <= pos <= S).
extern "C" int decode_attention8_ro(const void* q, long long q_bstride, const void* kn,
                                    long long kn_bstride, const void* vn, long long vn_bstride,
                                    const void* cache_k, const void* cache_v,
                                    const void* cache_ks, const void* cache_vs, int B, int NKV,
                                    int S, int R, int HD, int pos, float scale, void* out,
                                    void* stream) {
  return (int)launch<int8_t, false>(q, q_bstride, kn, kn_bstride, vn, vn_bstride, cache_k,
                                    cache_v, cache_ks, cache_vs, B, NKV, S, R, HD, pos, scale,
                                    out, stream);
}
