// Decode attention over a paged KV cache: SQ new tokens per slot attend to
// the slot's cached tokens, read through its page table from read-only
// pools, plus (causally) to each other; bf16 pools, or int8 pools with
// per-token f32 scales.
//
// Replaces, in accessory_tpu/ops/paged_decode.py:
//   _paged_kernel   (via _paged_decode / paged_decode_attention)   paged_decode
//   _paged_kernel8  (via _paged_decode8 / paged_decode_attention)  paged_decode8
// and their shared epilogue _finish (the new tokens' part of the softmax).
//
// Pools (NKV, P, PS, HD): one layer of the port's stacked (L, NKV, P, PS, HD)
// pools, every cached token of a head one contiguous row; int8 pools carry
// f32 scale pools (NKV, P, PS). The page table (B, PPS) int32 and the
// lengths (B,) int32 are device tensors read here, so a host loop of decode
// steps that advances the lengths on the device never waits for the card.
//
// One block per (kv head, slot, tile of up to MAXM query rows). Query row
// m = t * R + g is new token t, group member g (the TPU kernel's row order);
// the R rows of a token share every K/V read. The block walks the slot's
// cached tokens [0, min(length, J * PS)) in chunks of 64: each token's pool
// row is found from its page (page_indices[b, tok / PS]) and offset, staged
// into shared memory with 16-byte loads (int8 widened to bf16 on the way,
// exact), scored in f32 and folded into an online softmax, P rounded to bf16
// before the P.V product (the TPU kernel's p.astype(bf16)). Pages past the
// length are not read at all: the TPU kernel reads them (TRASH page 0 for an
// idle slot) and masks every score with the finite -1e30, which gives the
// same result. int8: the token's k scale multiplies the score after the dot
// (with the softmax scale), the v scale multiplies p before its bf16
// rounding, never an element. Then the new tokens' k/v, given apart (not yet
// in the pools, so exact and, for int8 pools, unquantized), enter as the
// second part of the softmax: row t sees new tokens t' <= t, in f32.
//
// Bound on the H100: bytes (each cached token's k and v read once per block,
// q and the new k/v once, the output written once). The same design as
// csrc/decode_attention.cu; a block per (slot, kv head) leaves most of the
// 132 SMs idle at the serving shapes (8 slots x 4 kv heads), and a split
// over the sequence is the next step.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int T = 64;  // cached tokens per chunk

template <int HD, typename CT>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const bf16* __restrict__ q, long long q_bs, long long q_ts,
                    const bf16* __restrict__ kn, long long kn_bs, long long kn_ts,
                    const bf16* __restrict__ vn, long long vn_bs, long long vn_ts,
                    const CT* __restrict__ kp, const CT* __restrict__ vp,
                    const float* __restrict__ ksp, const float* __restrict__ vsp,
                    const int* __restrict__ lengths, const int* __restrict__ pt, int PPS, int J,
                    int NKV, int P, int PS, int SQ, int R, float scale, bf16* __restrict__ out) {
  constexpr bool INT8 = sizeof(CT) == 1;
  constexpr int EPL = 16 / sizeof(CT);        // pool elements per 16-byte load
  constexpr int KLD = HD + 2;                 // padded K row: odd word stride
  constexpr int DPL = HD / 32;                // dims per lane in the P.V loop
  constexpr int MAXM = HD == 64 ? 64 : 32;    // query rows per block
  constexpr int RPW = MAXM / NWARPS;          // query rows per warp
  __shared__ __align__(16) bf16 qs[MAXM][HD];
  __shared__ __align__(16) bf16 Ks[T][KLD];
  __shared__ __align__(16) bf16 Vs[T][HD];
  __shared__ float ps[NWARPS][T];
  __shared__ float kss[INT8 ? T : 1], vss[INT8 ? T : 1];
  __shared__ long long prow[T];               // pool row of each token of the chunk

  const int h = blockIdx.x, b = blockIdx.y, row0 = blockIdx.z * MAXM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NQ = NKV * R;
  const int nrows = min(MAXM, SQ * R - row0);
  for (int i = tid; i < nrows * HD; i += THREADS) {
    const int m = row0 + i / HD, t = m / R, g = m % R;
    qs[i / HD][i % HD] = q[b * q_bs + t * q_ts + (long long)(h * R + g) * HD + i % HD];
  }
  const long long head_rows = (long long)h * P * PS;  // first pool row of this kv head
  const int n_tok = max(0, min(lengths[b], J * PS));

  float m_run[RPW], l_run[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_run[i] = NEG_INF_F;
    l_run[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[i][d] = 0.f;
  }

  for (int t0 = 0; t0 < n_tok; t0 += T) {
    const int nt = min(T, n_tok - t0);
    __syncthreads();
    if (tid < nt) {
      const int tok = t0 + tid;
      const int page = pt[(long long)b * PPS + tok / PS];
      if (page < 0 || page >= P) __trap();  // a page id the pools do not have
      prow[tid] = head_rows + (long long)page * PS + tok % PS;
    }
    __syncthreads();
    for (int i = tid; i < T * HD / EPL; i += THREADS) {
      const int tok = i / (HD / EPL), d0 = (i % (HD / EPL)) * EPL;
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
      if (tok < nt) {
        const size_t off = (size_t)prow[tok] * HD + d0;
        kr = *reinterpret_cast<const uint4*>(kp + off);
        vr = *reinterpret_cast<const uint4*>(vp + off);
      }
      uint32_t* krow = reinterpret_cast<uint32_t*>(&Ks[tok][d0]);
      if constexpr (INT8) {
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
      kss[tid] = tid < nt ? ksp[prow[tid]] : 1.f;
      vss[tid] = tid < nt ? vsp[prow[tid]] : 1.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + i * NWARPS;
      if (r >= nrows) break;
      float s[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int tok = lane + half * 32;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; d += 2) {
          const __nv_bfloat162 qq = *reinterpret_cast<const __nv_bfloat162*>(&qs[r][d]);
          const __nv_bfloat162 kk = *reinterpret_cast<const __nv_bfloat162*>(&Ks[tok][d]);
          dot += __low2float(qq) * __low2float(kk) + __high2float(qq) * __high2float(kk);
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
              *reinterpret_cast<const __nv_bfloat162*>(&Vs[tok][lane * DPL + d]);
          acc[i][d] += p * __low2float(vv);
          acc[i][d + 1] += p * __high2float(vv);
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();  // qs is complete for rows whose block read no cached token too

  // the new tokens: second part of the softmax, exact f32, causal among them
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + i * NWARPS;
    if (r >= nrows) break;
    const int m = row0 + r, t = m / R, g = m % R;
    float mr = m_run[i], lr = l_run[i];
    for (int tn = 0; tn <= t; ++tn) {
      const bf16* knb = kn + b * kn_bs + tn * kn_ts + (long long)h * HD;
      const bf16* vnb = vn + b * vn_bs + tn * vn_ts + (long long)h * HD;
      float dot = 0.f;
      for (int d = lane; d < HD; d += 32) dot += bf2f(qs[r][d]) * bf2f(knb[d]);
      const float s_new = warp_sum(dot) * scale;
      const float m_new = fmaxf(mr, s_new);
      const float corr = expf(mr - m_new);
      const float p_new = expf(s_new - m_new);
      lr = lr * corr + p_new;
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        acc[i][d] = acc[i][d] * corr + p_new * bf2f(vnb[lane * DPL + d]);
      mr = m_new;
    }
    bf16* ob = out + (((long long)b * SQ + t) * NQ + h * R + g) * HD;
#pragma unroll
    for (int d = 0; d < DPL; ++d) ob[lane * DPL + d] = f2bf(acc[i][d] / lr);
  }
}

template <typename CT>
cudaError_t launch(const void* q, long long q_bs, long long q_ts, const void* kn, long long kn_bs,
                   long long kn_ts, const void* vn, long long vn_bs, long long vn_ts,
                   const void* kp, const void* vp, const void* ksp, const void* vsp,
                   const void* lengths, const void* pt, int PPS, int J, int B, int NKV, int P,
                   int PS, int SQ, int R, int HD, float scale, void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || NKV < 1 || P < 1 || PS < 1 || SQ < 1 || R < 1 || J < 1 || J > PPS)
    return cudaErrorInvalidValue;
  const int maxm = HD == 64 ? 64 : 32;
  dim3 grid(NKV, B, (SQ * R + maxm - 1) / maxm);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* knp = static_cast<const bf16*>(kn);
  const bf16* vnp = static_cast<const bf16*>(vn);
  const CT* k = static_cast<const CT*>(kp);
  const CT* v = static_cast<const CT*>(vp);
  const float* ks = static_cast<const float*>(ksp);
  const float* vs = static_cast<const float*>(vsp);
  const int* len = static_cast<const int*>(lengths);
  const int* table = static_cast<const int*>(pt);
  bf16* o = static_cast<bf16*>(out);
  if (HD == 64) {
    paged_decode_kernel<64, CT><<<grid, THREADS, 0, st>>>(
        qp, q_bs, q_ts, knp, kn_bs, kn_ts, vnp, vn_bs, vn_ts, k, v, ks, vs, len, table, PPS, J,
        NKV, P, PS, SQ, R, scale, o);
  } else if (HD == 128) {
    paged_decode_kernel<128, CT><<<grid, THREADS, 0, st>>>(
        qp, q_bs, q_ts, knp, kn_bs, kn_ts, vnp, vn_bs, vn_ts, k, v, ks, vs, len, table, PPS, J,
        NKV, P, PS, SQ, R, scale, o);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q (B, SQ, NKV * R, HD) and k_new / v_new (B, SQ, NKV, HD), bf16, each with
// batch and token strides in elements and contiguous heads; pools (NKV, P, PS,
// HD) bf16 contiguous, 16-byte aligned; lengths (B,) int32 (cached tokens
// before the new ones); page table (B, PPS) int32 rows; the first J logical
// pages are read. out (B, SQ, NKV * R, HD) bf16 contiguous. HD 64 or 128.
extern "C" int paged_decode(const void* q, long long q_bs, long long q_ts, const void* kn,
                            long long kn_bs, long long kn_ts, const void* vn, long long vn_bs,
                            long long vn_ts, const void* k_pages, const void* v_pages,
                            const void* lengths, const void* page_table, int PPS, int J, int B,
                            int NKV, int P, int PS, int SQ, int R, int HD, float scale, void* out,
                            void* stream) {
  return (int)launch<bf16>(q, q_bs, q_ts, kn, kn_bs, kn_ts, vn, vn_bs, vn_ts, k_pages, v_pages,
                           nullptr, nullptr, lengths, page_table, PPS, J, B, NKV, P, PS, SQ, R,
                           HD, scale, out, stream);
}

// The same over int8 pools (NKV, P, PS, HD) with f32 scale pools (NKV, P, PS).
extern "C" int paged_decode8(const void* q, long long q_bs, long long q_ts, const void* kn,
                             long long kn_bs, long long kn_ts, const void* vn, long long vn_bs,
                             long long vn_ts, const void* k_pages, const void* v_pages,
                             const void* ks_pages, const void* vs_pages, const void* lengths,
                             const void* page_table, int PPS, int J, int B, int NKV, int P,
                             int PS, int SQ, int R, int HD, float scale, void* out,
                             void* stream) {
  return (int)launch<int8_t>(q, q_bs, q_ts, kn, kn_bs, kn_ts, vn, vn_bs, vn_ts, k_pages, v_pages,
                             ks_pages, vs_pages, lengths, page_table, PPS, J, B, NKV, P, PS, SQ,
                             R, HD, scale, out, stream);
}
