// Causal self-attention forward (prefill at position 0) with native GQA.
//
// Replaces: accessory_tpu/ops/flash_attention.py::flash_attention_tpu, which
// calls JAX's bundled TPU splash kernel (`_splash_kernel`).
//
// One block (4 warps) per (64-row query tile, query head, batch row); each
// warp owns 16 query rows. K/V tiles of 64 tokens, up to the diagonal, are
// staged in shared memory; S = Q.K^T and O += P.V run on the tensor cores
// with mma.sync m16n8k16 (bf16 in, f32 accumulate), and the softmax is the
// online (flash) form in f32. Query head hq reads kv head hq / (NQ / NKV), so
// K/V are never repeated in memory. The kernel masks the causal triangle and
// a ragged sequence end itself: any S >= 1 is served (no 128-multiple rule).
//
// Bound on the H100: the work is about 2 * S^2 * HD flops per query head
// against 2 * S * HD * (2 + 2 * NKV / NQ) bytes (q read, out written, k/v
// shared by the group), so S * NQ / (2 * NQ + 2 * NKV) flops per byte. With
// 32/4 heads that passes the card's ~295 bf16 flops per byte near S = 660:
// shorter prefills (the main path's 128-token bucket) are bound by bytes,
// longer ones by the tensor cores. This first version keeps Q fragments in
// registers and does not double-buffer K/V, so it runs well below either.
//
// For training, an optional lse (B, NQ, S) f32 output receives each row's
// log-sum-exp of the scaled scores, m + log(l) from the f32 running max and
// the f32 sum (before P is rounded to bf16): csrc/flash_attention_bwd.cu
// recomputes P = exp(s * scale - lse) from it.
//
// The same body is the forward of context-parallel (sequence-sharded)
// attention, entry flash_attention_cp_fwd. It replaces accessory_tpu/
// parallel/context.py::_splash_cp_kernel (:46), JAX's bundled splash kernel
// with q_seq_shards, reached through cp_attention (:77). A shard's SQ query
// rows sit at global positions q0 .. q0 + SQ - 1 of a sequence whose SK keys
// were all-gathered: row i sees keys 0 .. q0 + i, and a block stops at the
// key tile that holds its last row's diagonal, so a late shard does more work
// than an early one and nothing is computed twice. flash_attention_fwd is the
// case q0 = 0, SK = SQ of the one body, so both entries give the same bits
// there. Bound: 4 * HD * (SQ * q0 + SQ^2 / 2) flops per query head, on the
// tensor cores from a few hundred rows on, like the unsharded pass.

#include "common.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 128;

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, long long q_bs, long long q_ts,
                 const bf16* __restrict__ k, long long k_bs, long long k_ts,
                 const bf16* __restrict__ v, long long v_bs, long long v_ts,
                 bf16* __restrict__ out, float* __restrict__ lse, int SQ, int SK, int q0,
                 int NQ, int NKV, float scale) {
  constexpr int LD = HD + 8;  // padded smem row (bf16), 16-byte aligned
  constexpr int KT = HD / 16; // k16 steps over the head dim
  constexpr int DT = HD / 8;  // n8 tiles over the head dim
  __shared__ __align__(16) bf16 Ks[BKV][LD];
  __shared__ __align__(16) bf16 Vs[BKV][LD];

  const int qt = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (NQ / NKV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = qt * BQ + warp * 16 + g, r1 = r0 + 8;  // local rows, at q0 + r

  const bf16* qb = q + b * q_bs + (size_t)hq * HD;
  const bf16* kb = k + b * k_bs + (size_t)hk * HD;
  const bf16* vb = v + b * v_bs + (size_t)hk * HD;

  uint32_t qf[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = r0 < SQ ? *reinterpret_cast<const uint32_t*>(qb + r0 * q_ts + c) : 0u;
    qf[kk][1] = r1 < SQ ? *reinterpret_cast<const uint32_t*>(qb + r1 * q_ts + c) : 0u;
    qf[kk][2] = r0 < SQ ? *reinterpret_cast<const uint32_t*>(qb + r0 * q_ts + c + 8) : 0u;
    qf[kk][3] = r1 < SQ ? *reinterpret_cast<const uint32_t*>(qb + r1 * q_ts + c + 8) : 0u;
  }

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m0 = NEG_INF_F, m1 = NEG_INF_F, l0 = 0.f, l1 = 0.f;

  // the global position of the tile's last row: no key past it is read
  const int last_row = q0 + min(SQ, (qt + 1) * BQ) - 1;
  const int n_tiles = min(last_row, SK - 1) / BKV + 1;
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BKV;
    __syncthreads();
    for (int i = tid; i < BKV * HD / 8; i += THREADS) {
      const int tok = i / (HD / 8), d8 = (i % (HD / 8)) * 8;
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
      if (kv0 + tok < SK) {
        kr = *reinterpret_cast<const uint4*>(kb + (kv0 + tok) * k_ts + d8);
        vr = *reinterpret_cast<const uint4*>(vb + (kv0 + tok) * v_ts + d8);
      }
      *reinterpret_cast<uint4*>(&Ks[tok][d8]) = kr;
      *reinterpret_cast<uint4*>(&Vs[tok][d8]) = vr;
    }
    __syncthreads();

    float s[BKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const bf16* kp = &Ks[nt * 8 + g][kk * 16 + 2 * t];
        mma_bf16_16816(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                       *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const float val = (key <= q0 + row && key < SK) ? s[nt][e] * scale : NEG_INF_F;
        s[nt][e] = val;
        if (e < 2) mx0 = fmaxf(mx0, val); else mx1 = fmaxf(mx1, val);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = expf(m0 - mx0), c1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= c0; o[d][1] *= c0; o[d][2] *= c1; o[d][3] *= c1;
    }
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - m0);
      s[nt][1] = expf(s[nt][1] - m0);
      s[nt][2] = expf(s[nt][2] - m1);
      s[nt][3] = expf(s[nt][3] - m1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const int kr = kc * 16 + 2 * t;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int col = d * 8 + g;
        const uint32_t b0 = pack_bf16_pair(Vs[kr][col], Vs[kr + 1][col]);
        const uint32_t b1 = pack_bf16_pair(Vs[kr + 8][col], Vs[kr + 9][col]);
        mma_bf16_16816(o[d], pa, b0, b1);
      }
    }
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  if (lse != nullptr && t == 0) {
    float* lp = lse + ((size_t)b * NQ + hq) * SQ;
    if (r0 < SQ) lp[r0] = m0 + logf(l0);
    if (r1 < SQ) lp[r1] = m1 + logf(l1);
  }
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + 2 * t;
    if (r0 < SQ) {
      bf16* op = out + (((size_t)b * SQ + r0) * NQ + hq) * HD + col;
      *reinterpret_cast<uint32_t*>(op) = pack_bf16x2(o[d][0] * inv0, o[d][1] * inv0);
    }
    if (r1 < SQ) {
      bf16* op = out + (((size_t)b * SQ + r1) * NQ + hq) * HD + col;
      *reinterpret_cast<uint32_t*>(op) = pack_bf16x2(o[d][2] * inv1, o[d][3] * inv1);
    }
  }
}

int launch_fwd(const void* q, long long q_bs, long long q_ts, const void* k, long long k_bs,
               long long k_ts, const void* v, long long v_bs, long long v_ts, void* out, int B,
               int SQ, int SK, int q0, int NQ, int NKV, int HD, float scale, void* lse,
               void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (SQ < 1 || q0 < 0 || q0 + SQ > SK || NKV < 1 || NQ % NKV != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((SQ + BQ - 1) / BQ, NQ, B);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* o = static_cast<bf16*>(out);
  float* l = static_cast<float*>(lse);
  if (HD == 64) {
    flash_fwd_kernel<64><<<grid, THREADS, 0, st>>>(qp, q_bs, q_ts, kp, k_bs, k_ts, vp, v_bs,
                                                   v_ts, o, l, SQ, SK, q0, NQ, NKV, scale);
  } else if (HD == 128) {
    flash_fwd_kernel<128><<<grid, THREADS, 0, st>>>(qp, q_bs, q_ts, kp, k_bs, k_ts, vp, v_bs,
                                                    v_ts, o, l, SQ, SK, q0, NQ, NKV, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, NQ, HD), k/v (B, S, NKV, HD), each with the given batch and token
// strides (elements) and heads contiguous inside a token; out (B, S, NQ, HD)
// contiguous; lse (B, NQ, S) f32 or null (serving passes null). Requires HD
// in {64, 128}, NQ % NKV == 0, even strides.
extern "C" int flash_attention_fwd(const void* q, long long q_bs, long long q_ts,
                                   const void* k, long long k_bs, long long k_ts,
                                   const void* v, long long v_bs, long long v_ts, void* out,
                                   int B, int S, int NQ, int NKV, int HD, float scale,
                                   void* lse, void* stream) {
  return launch_fwd(q, q_bs, q_ts, k, k_bs, k_ts, v, v_bs, v_ts, out, B, S, S, 0, NQ, NKV, HD,
                    scale, lse, stream);
}

// One context-parallel shard: q (B, SQ, NQ, HD) at global positions q0 ..
// q0 + SQ - 1, k/v (B, SK, NKV, HD) the gathered keys (any batch and token
// strides: a token-major gather buffer is read as it is); out (B, SQ, NQ, HD)
// contiguous; lse (B, NQ, SQ) f32 or null. Requires q0 >= 0 and q0 + SQ <= SK,
// and what flash_attention_fwd requires.
extern "C" int flash_attention_cp_fwd(const void* q, long long q_bs, long long q_ts,
                                      const void* k, long long k_bs, long long k_ts,
                                      const void* v, long long v_bs, long long v_ts, void* out,
                                      int B, int SQ, int SK, int q0, int NQ, int NKV, int HD,
                                      float scale, void* lse, void* stream) {
  return launch_fwd(q, q_bs, q_ts, k, k_bs, k_ts, v, v_bs, v_ts, out, B, SQ, SK, q0, NQ, NKV,
                    HD, scale, lse, stream);
}
