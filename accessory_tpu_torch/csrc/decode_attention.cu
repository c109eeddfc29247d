// Fused GQA decode attention + KV-cache write of the new token.
//
// Replaces: accessory_tpu/ops/decode_attention.py::_kernel_bloop_w (via
// _decode_attn_bloop_w / decode_attention_update).
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
// Bound on the H100: bytes. Per step the kernel must read 2 * pos * HD * 2
// bytes per (b, kv head); the design reads each cached byte once with 16-byte
// loads into shared memory, and each warp owns one query row so the score and
// P.V loops read shared memory without bank conflicts. One block per
// (b, head) is 32 blocks at the decode shape, which under-fills 132 SMs; a
// split over the sequence is the next step for long caches.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int T = 64;          // tokens per chunk

template <int HD>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const bf16* __restrict__ q, long long q_bstride,
                   const bf16* __restrict__ kn, long long kn_bstride,
                   const bf16* __restrict__ vn, long long vn_bstride,
                   bf16* __restrict__ cache_k, bf16* __restrict__ cache_v,
                   int NKV, int S, int R, int pos, float scale, bf16* __restrict__ out) {
  constexpr int KLD = HD + 2;          // padded K row (bf16): odd word stride
  constexpr int DPL = HD / 32;         // dims per lane in the P.V loop
  constexpr int MAXR = HD == 64 ? 32 : 16;  // query rows per kv head
  constexpr int MAX_RPW = MAXR / NWARPS;    // query rows per warp
  __shared__ float qs[MAXR][HD];
  __shared__ __align__(16) bf16 Ks[T][KLD];
  __shared__ __align__(16) bf16 Vs[T][HD];
  __shared__ float ps[NWARPS][T];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* qb = q + b * q_bstride + (size_t)h * R * HD;
  for (int i = tid; i < R * HD; i += THREADS) qs[i / HD][i % HD] = bf2f(qb[i]);
  __syncthreads();
  const size_t cbase = ((size_t)b * NKV + h) * (size_t)S * HD;

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
    for (int i = tid; i < T * HD / 8; i += THREADS) {
      const int tok = i / (HD / 8), d8 = (i % (HD / 8)) * 8;
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
      if (tok < nt) {
        const size_t off = cbase + (size_t)(t0 + tok) * HD + d8;
        kr = *reinterpret_cast<const uint4*>(cache_k + off);
        vr = *reinterpret_cast<const uint4*>(cache_v + off);
      }
      const uint32_t* kw = reinterpret_cast<const uint32_t*>(&kr);
      uint32_t* krow = reinterpret_cast<uint32_t*>(&Ks[tok][d8]);
#pragma unroll
      for (int j = 0; j < 4; ++j) krow[j] = kw[j];
      *reinterpret_cast<uint4*>(&Vs[tok][d8]) = vr;
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
        s[half] = tok < nt ? dot * scale : NEG_INF_F;
      }
      const float m_new = fmaxf(m_run[i], warp_max(fmaxf(s[0], s[1])));
      const float corr = expf(m_run[i] - m_new);
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      l_run[i] = l_run[i] * corr + warp_sum(p0 + p1);
      m_run[i] = m_new;
      ps[warp][lane] = round_bf16(p0);
      ps[warp][lane + 32] = round_bf16(p1);
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

  // in-place write of the new token at index pos
  const size_t woff = cbase + (size_t)pos * HD;
  for (int d = tid; d < HD; d += THREADS) {
    cache_k[woff + d] = knb[d];
    cache_v[woff + d] = vnb[d];
  }
}

}  // namespace

// q: (B, NKV*R*HD) rows with batch stride q_bstride (elements); kn/vn: (B,
// NKV*HD) rows with their batch strides; caches (B, NKV, S, HD) contiguous;
// out (B, NKV, R, HD) contiguous. Requires HD in {64, 128}, R <= 32 (HD 64)
// or 16 (HD 128), 0 <= pos < S.
extern "C" int decode_attention_update(const void* q, long long q_bstride, const void* kn,
                                       long long kn_bstride, const void* vn,
                                       long long vn_bstride, void* cache_k, void* cache_v,
                                       int B, int NKV, int S, int R, int HD, int pos,
                                       float scale, void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (R < 1 || R > (HD == 64 ? 32 : 16) || pos < 0 || pos >= S) return (int)cudaErrorInvalidValue;
  dim3 grid(NKV, B);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(kn);
  const bf16* vp = static_cast<const bf16*>(vn);
  bf16* ck = static_cast<bf16*>(cache_k);
  bf16* cv = static_cast<bf16*>(cache_v);
  bf16* o = static_cast<bf16*>(out);
  if (HD == 64) {
    decode_attn_kernel<64><<<grid, THREADS, 0, st>>>(qp, q_bstride, kp, kn_bstride, vp,
                                                     vn_bstride, ck, cv, NKV, S, R, pos,
                                                     scale, o);
  } else if (HD == 128) {
    decode_attn_kernel<128><<<grid, THREADS, 0, st>>>(qp, q_bstride, kp, kn_bstride, vp,
                                                      vn_bstride, ck, cv, NKV, S, R, pos,
                                                      scale, o);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
