// Causal self-attention backward with native GQA: dq, dk, dv of
// csrc/flash_attention.cu's forward.
//
// Replaces: the backward of accessory_tpu/ops/flash_attention.py::
// flash_attention_tpu (:86), JAX's bundled TPU splash kernels
// `_splash_attention_bwd_dq` and `_splash_attention_bwd_dkv`, reached through
// the custom VJP of `_splash_kernel` (:61).
//
// The FlashAttention-2 split, in two launches on one stream:
//   flash_attention_bwd_dq    a block (4 warps, 16 query rows each) per (64-row
//                             query tile, query head, batch row). It first
//                             computes D = rowsum(dO * O) of its rows (f32,
//                             stored for the second pass), then walks the key
//                             tiles up to the diagonal: S = Q K^T, P = exp(S *
//                             scale - lse) from the forward's f32 log-sum-exp,
//                             dP = dO V^T, dS = P (dP - D), dQ += dS K.
//   flash_attention_bwd_dkdv  a block (4 warps, 16 key rows each) per (64-row
//                             key tile, kv head, batch row). It loops over
//                             the group's query heads and the query tiles at
//                             or below the diagonal: S^T = K Q^T, P^T, dV +=
//                             P^T dO, dP^T = V dO^T, dS^T, dK += dS^T Q. A
//                             block owns its key rows for every query head of
//                             the group, so dK and dV are summed over the
//                             group in registers, with no atomics.
// Every product is mma.sync m16n8k16 (bf16 in, f32 accumulate), as in the
// forward; P and dS are rounded to bf16 as the products' inputs. Rows past a
// ragged end (S not a multiple of the tile) are masked in the kernel: they
// get no dq and add nothing to dk / dv. Results are stored in bf16 once.
//
// Bound on the H100: about 2.5x the causal forward's flops (five products of
// 2 * S^2 * HD / 2 per query head, one of them the recompute of S) against
// q, k, v, o, dO read and dq, dk, dv written once; tensor-core bound from a
// few hundred tokens on. This first version stages tiles with plain 16-byte
// loads and no double buffering, and reads B fragments with 16-bit shared
// loads where the layout needs a transpose, so it runs well below the bound
// (wgmma, TMA and pipelining are later work).
//
// The same two bodies are the backward of context-parallel (sequence-sharded)
// attention, entries flash_attention_cp_bwd_dq and flash_attention_cp_bwd_dkdv:
// the custom VJP of accessory_tpu/parallel/context.py::_splash_cp_kernel (:46).
// A shard's SQ query rows sit at global positions q_off .. q_off + SQ - 1 over
// SK gathered keys. dq walks the key tiles up to its rows' diagonal. dk / dv
// covers all SK keys (a block per key tile): a tile before q_off sees every
// row unmasked, one past the shard's last row loops over nothing and stores
// zeros, so the reduce-scatter that returns each shard its own keys' gradient
// adds no stale memory. The unsharded entries are the case q_off = 0,
// SK = SQ of the same bodies.

#include "common.cuh"

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 128;

// A fragment (16 rows x 16 cols) of a bf16 tile in shared memory, row-major.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* base, int row0, int col0,
                                       int g, int t) {
  const bf16* p0 = base + (row0 + g) * LD + col0 + 2 * t;
  const bf16* p1 = p0 + 8 * LD;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// Stage rows [r0, r0 + ROWS) of a (S, heads, HD) tensor's head into shared
// memory (zero past S), 16 bytes a thread per step.
template <int ROWS, int HD, int LD>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, long long ts, int r0, int S,
                                      int tid) {
  for (int i = tid; i < ROWS * HD / 8; i += THREADS) {
    const int row = i / (HD / 8), d8 = (i % (HD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < S) val = *reinterpret_cast<const uint4*>(src + (r0 + row) * ts + d8);
    *reinterpret_cast<uint4*>(dst + row * LD + d8) = val;
  }
}

// ---------------------------------------------------------------- dq (+ D)

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, long long q_bs, long long q_ts,
                    const bf16* __restrict__ k, long long k_bs, long long k_ts,
                    const bf16* __restrict__ v, long long v_bs, long long v_ts,
                    const bf16* __restrict__ o, long long o_bs, long long o_ts,
                    const bf16* __restrict__ dout, long long d_bs, long long d_ts,
                    const float* __restrict__ lse, float* __restrict__ Dbuf,
                    bf16* __restrict__ dq, int SQ, int SK, int q_off, int NQ, int NKV,
                    float scale) {
  constexpr int BKV = HD == 128 ? 32 : 64;  // key columns per step (registers)
  constexpr int LD = HD + 8;
  constexpr int KT = HD / 16, DT = HD / 8, NT = BKV / 8;
  __shared__ __align__(16) bf16 Ks[BKV * LD];
  __shared__ __align__(16) bf16 Vs[BKV * LD];

  const int qt = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (NQ / NKV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = qt * BQ + warp * 16 + g, r1 = r0 + 8;  // local rows, at q_off + r

  const bf16* qb = q + b * q_bs + (size_t)hq * HD;
  const bf16* ob = o + b * o_bs + (size_t)hq * HD;
  const bf16* db = dout + b * d_bs + (size_t)hq * HD;
  const bf16* kb = k + b * k_bs + (size_t)hk * HD;
  const bf16* vb = v + b * v_bs + (size_t)hk * HD;

  // Q and dO fragments in registers; D = rowsum(dO * O) from the same lanes
  uint32_t qf[KT][4], df[KT][4];
  float D0 = 0.f, D1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const int c = kk * 16 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cc = c + 8 * h;
      uint32_t q0 = 0u, q1 = 0u, d0 = 0u, d1 = 0u, o0 = 0u, o1 = 0u;
      if (r0 < SQ) {
        q0 = *reinterpret_cast<const uint32_t*>(qb + r0 * q_ts + cc);
        d0 = *reinterpret_cast<const uint32_t*>(db + r0 * d_ts + cc);
        o0 = *reinterpret_cast<const uint32_t*>(ob + r0 * o_ts + cc);
      }
      if (r1 < SQ) {
        q1 = *reinterpret_cast<const uint32_t*>(qb + r1 * q_ts + cc);
        d1 = *reinterpret_cast<const uint32_t*>(db + r1 * d_ts + cc);
        o1 = *reinterpret_cast<const uint32_t*>(ob + r1 * o_ts + cc);
      }
      qf[kk][2 * h] = q0;
      qf[kk][2 * h + 1] = q1;
      df[kk][2 * h] = d0;
      df[kk][2 * h + 1] = d1;
      const float2 dd0 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&d0));
      const float2 oo0 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&o0));
      const float2 dd1 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&d1));
      const float2 oo1 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&o1));
      D0 += dd0.x * oo0.x + dd0.y * oo0.y;
      D1 += dd1.x * oo1.x + dd1.y * oo1.y;
    }
  }
  D0 += __shfl_xor_sync(0xffffffffu, D0, 1);
  D0 += __shfl_xor_sync(0xffffffffu, D0, 2);
  D1 += __shfl_xor_sync(0xffffffffu, D1, 1);
  D1 += __shfl_xor_sync(0xffffffffu, D1, 2);
  const size_t row_base = ((size_t)b * NQ + hq) * SQ;
  float lse0 = 0.f, lse1 = 0.f;
  if (r0 < SQ) {
    lse0 = lse[row_base + r0];
    if (t == 0) Dbuf[row_base + r0] = D0;
  }
  if (r1 < SQ) {
    lse1 = lse[row_base + r1];
    if (t == 0) Dbuf[row_base + r1] = D1;
  }

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  // the global position of the tile's last row: no key past it is read
  const int last_row = q_off + min(SQ, (qt + 1) * BQ) - 1;
  const int n_tiles = min(last_row, SK - 1) / BKV + 1;
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BKV;
    __syncthreads();
    stage<BKV, HD, LD>(Ks, kb, k_ts, kv0, SK, tid);
    stage<BKV, HD, LD>(Vs, vb, v_ts, kv0, SK, tid);
    __syncthreads();

    float p[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const bf16* kp = Ks + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        const bf16* vp = Vs + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16_16816(p[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                       *reinterpret_cast<const uint32_t*>(kp + 8));
        mma_bf16_16816(dp[nt], df[kk], *reinterpret_cast<const uint32_t*>(vp),
                       *reinterpret_cast<const uint32_t*>(vp + 8));
      }
    }
    // dS = P (dP - D), P recomputed from lse; masked entries are 0
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool ok = key <= q_off + row && row < SQ;
        const float pe = ok ? expf(p[nt][e] * scale - (e < 2 ? lse0 : lse1)) : 0.f;
        p[nt][e] = pe * (dp[nt][e] - (e < 2 ? D0 : D1));
      }
    }
    // dQ += dS K
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(p[2 * kc][0], p[2 * kc][1]);
      pa[1] = pack_bf16x2(p[2 * kc][2], p[2 * kc][3]);
      pa[2] = pack_bf16x2(p[2 * kc + 1][0], p[2 * kc + 1][1]);
      pa[3] = pack_bf16x2(p[2 * kc + 1][2], p[2 * kc + 1][3]);
      const int kr = kc * 16 + 2 * t;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int col = d * 8 + g;
        const uint32_t b0 = pack_bf16_pair(Ks[kr * LD + col], Ks[(kr + 1) * LD + col]);
        const uint32_t b1 = pack_bf16_pair(Ks[(kr + 8) * LD + col], Ks[(kr + 9) * LD + col]);
        mma_bf16_16816(acc[d], pa, b0, b1);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + 2 * t;
    if (r0 < SQ) {
      bf16* op = dq + (((size_t)b * SQ + r0) * NQ + hq) * HD + col;
      *reinterpret_cast<uint32_t*>(op) = pack_bf16x2(acc[d][0] * scale, acc[d][1] * scale);
    }
    if (r1 < SQ) {
      bf16* op = dq + (((size_t)b * SQ + r1) * NQ + hq) * HD + col;
      *reinterpret_cast<uint32_t*>(op) = pack_bf16x2(acc[d][2] * scale, acc[d][3] * scale);
    }
  }
}

// ---------------------------------------------------------------- dk, dv

template <int HD>
struct DkdvSmem {
  static constexpr int LD = HD + 8;
  static constexpr int BQI = HD == 128 ? 32 : 64;  // query rows per step (registers)
  static constexpr int BYTES = (2 * BK * LD + 2 * BQI * LD) * 2 + 2 * BQI * 4;
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, long long q_bs, long long q_ts,
                      const bf16* __restrict__ k, long long k_bs, long long k_ts,
                      const bf16* __restrict__ v, long long v_bs, long long v_ts,
                      const bf16* __restrict__ dout, long long d_bs, long long d_ts,
                      const float* __restrict__ lse, const float* __restrict__ Dbuf,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int SQ, int SK, int q_off,
                      int NQ, int NKV, float scale) {
  constexpr int LD = DkdvSmem<HD>::LD, BQI = DkdvSmem<HD>::BQI;
  constexpr int KT = HD / 16, DT = HD / 8, NT = BQI / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BK * LD;
  bf16* Qs = Vs + BK * LD;
  bf16* Ds = Qs + BQI * LD;  // dO tile
  float* lse_s = reinterpret_cast<float*>(Ds + BQI * LD);
  float* D_s = lse_s + BQI;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int R = NQ / NKV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * BK;
  const int wr = warp * 16;               // the warp's first key row in the tile
  const int kr0 = k0 + wr + g, kr1 = kr0 + 8;

  stage<BK, HD, LD>(Ks, k + b * k_bs + (size_t)hk * HD, k_ts, k0, SK, tid);
  stage<BK, HD, LD>(Vs, v + b * v_bs + (size_t)hk * HD, v_ts, k0, SK, tid);

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    dka[d][0] = dka[d][1] = dka[d][2] = dka[d][3] = 0.f;
    dva[d][0] = dva[d][1] = dva[d][2] = dva[d][3] = 0.f;
  }

  // the first local query tile with a row at or past the tile's first key; a
  // key tile past the shard's last row loops over nothing and stores zeros
  const int i_first = max(0, k0 - q_off) / BQI, i_end = (SQ + BQI - 1) / BQI;
  for (int hq = hk * R; hq < (hk + 1) * R; ++hq) {
    const bf16* qb = q + b * q_bs + (size_t)hq * HD;
    const bf16* db = dout + b * d_bs + (size_t)hq * HD;
    const size_t row_base = ((size_t)b * NQ + hq) * SQ;
    for (int i = i_first; i < i_end; ++i) {
      const int q0 = i * BQI;
      __syncthreads();
      stage<BQI, HD, LD>(Qs, qb, q_ts, q0, SQ, tid);
      stage<BQI, HD, LD>(Ds, db, d_ts, q0, SQ, tid);
      for (int r = tid; r < BQI; r += THREADS) {
        const bool ok = q0 + r < SQ;
        lse_s[r] = ok ? lse[row_base + q0 + r] : 0.f;
        D_s[r] = ok ? Dbuf[row_base + q0 + r] : 0.f;
      }
      __syncthreads();
      // every key row of this warp is past every query row of the tile
      if (q_off + q0 + BQI - 1 < k0 + wr) continue;

      // S^T = K Q^T and dP^T = V dO^T (16 key rows x BQI query columns)
      float p[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t ka[4], va[4];
        load_a<LD>(ka, Ks, wr, kk * 16, g, t);
        load_a<LD>(va, Vs, wr, kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const bf16* qp = Qs + (nt * 8 + g) * LD + kk * 16 + 2 * t;
          const bf16* dp_ = Ds + (nt * 8 + g) * LD + kk * 16 + 2 * t;
          mma_bf16_16816(p[nt], ka, *reinterpret_cast<const uint32_t*>(qp),
                         *reinterpret_cast<const uint32_t*>(qp + 8));
          mma_bf16_16816(dp[nt], va, *reinterpret_cast<const uint32_t*>(dp_),
                         *reinterpret_cast<const uint32_t*>(dp_ + 8));
        }
      }
      // P^T (masked: key <= query < S), then dS^T = P^T (dP^T - D) in dp
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = nt * 8 + 2 * t + (e & 1);
          const int key = e < 2 ? kr0 : kr1;
          const bool ok = key <= q_off + q0 + qc && q0 + qc < SQ;
          const float pe = ok ? expf(p[nt][e] * scale - lse_s[qc]) : 0.f;
          p[nt][e] = pe;
          dp[nt][e] = pe * (dp[nt][e] - D_s[qc]);
        }
      }
      // dV += P^T dO and dK += dS^T Q (B fragments: query rows x head dims)
#pragma unroll
      for (int kc = 0; kc < BQI / 16; ++kc) {
        uint32_t pa[4], sa[4];
        pa[0] = pack_bf16x2(p[2 * kc][0], p[2 * kc][1]);
        pa[1] = pack_bf16x2(p[2 * kc][2], p[2 * kc][3]);
        pa[2] = pack_bf16x2(p[2 * kc + 1][0], p[2 * kc + 1][1]);
        pa[3] = pack_bf16x2(p[2 * kc + 1][2], p[2 * kc + 1][3]);
        sa[0] = pack_bf16x2(dp[2 * kc][0], dp[2 * kc][1]);
        sa[1] = pack_bf16x2(dp[2 * kc][2], dp[2 * kc][3]);
        sa[2] = pack_bf16x2(dp[2 * kc + 1][0], dp[2 * kc + 1][1]);
        sa[3] = pack_bf16x2(dp[2 * kc + 1][2], dp[2 * kc + 1][3]);
        const int qr = kc * 16 + 2 * t;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          const int col = d * 8 + g;
          const uint32_t o0 = pack_bf16_pair(Ds[qr * LD + col], Ds[(qr + 1) * LD + col]);
          const uint32_t o1 = pack_bf16_pair(Ds[(qr + 8) * LD + col], Ds[(qr + 9) * LD + col]);
          mma_bf16_16816(dva[d], pa, o0, o1);
          const uint32_t q0b = pack_bf16_pair(Qs[qr * LD + col], Qs[(qr + 1) * LD + col]);
          const uint32_t q1b = pack_bf16_pair(Qs[(qr + 8) * LD + col], Qs[(qr + 9) * LD + col]);
          mma_bf16_16816(dka[d], sa, q0b, q1b);
        }
      }
    }
  }
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + 2 * t;
    if (kr0 < SK) {
      const size_t off = (((size_t)b * SK + kr0) * NKV + hk) * HD + col;
      *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16x2(dka[d][0] * scale, dka[d][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16x2(dva[d][0], dva[d][1]);
    }
    if (kr1 < SK) {
      const size_t off = (((size_t)b * SK + kr1) * NKV + hk) * HD + col;
      *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16x2(dka[d][2] * scale, dka[d][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16x2(dva[d][2], dva[d][3]);
    }
  }
}

template <int HD>
int launch_dkdv(dim3 grid, cudaStream_t st, const bf16* q, long long q_bs, long long q_ts,
                const bf16* k, long long k_bs, long long k_ts, const bf16* v, long long v_bs,
                long long v_ts, const bf16* dout, long long d_bs, long long d_ts,
                const float* lse, const float* D, bf16* dk, bf16* dv, int SQ, int SK, int q_off,
                int NQ, int NKV, float scale) {
  const int bytes = DkdvSmem<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<HD><<<grid, THREADS, bytes, st>>>(q, q_bs, q_ts, k, k_bs, k_ts, v,
                                                          v_bs, v_ts, dout, d_bs, d_ts, lse, D,
                                                          dk, dv, SQ, SK, q_off, NQ, NKV,
                                                          scale);
  return (int)cudaGetLastError();
}

int launch_dq(const void* q, long long q_bs, long long q_ts, const void* k, long long k_bs,
              long long k_ts, const void* v, long long v_bs, long long v_ts, const void* o,
              long long o_bs, long long o_ts, const void* dout, long long d_bs, long long d_ts,
              const void* lse, void* D, void* dq, int B, int SQ, int SK, int q_off, int NQ,
              int NKV, int HD, float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (SQ < 1 || q_off < 0 || q_off + SQ > SK || NKV < 1 || NQ % NKV != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((SQ + BQ - 1) / BQ, NQ, B);
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *op = static_cast<const bf16*>(o),
             *dp = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* Dp = static_cast<float*>(D);
  bf16* dqp = static_cast<bf16*>(dq);
  if (HD == 64) {
    flash_bwd_dq_kernel<64><<<grid, THREADS, 0, st>>>(qp, q_bs, q_ts, kp, k_bs, k_ts, vp, v_bs,
                                                      v_ts, op, o_bs, o_ts, dp, d_bs, d_ts, lp,
                                                      Dp, dqp, SQ, SK, q_off, NQ, NKV, scale);
  } else if (HD == 128) {
    flash_bwd_dq_kernel<128><<<grid, THREADS, 0, st>>>(qp, q_bs, q_ts, kp, k_bs, k_ts, vp,
                                                       v_bs, v_ts, op, o_bs, o_ts, dp, d_bs,
                                                       d_ts, lp, Dp, dqp, SQ, SK, q_off, NQ,
                                                       NKV, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int launch_dkdv_hd(const void* q, long long q_bs, long long q_ts, const void* k,
                   long long k_bs, long long k_ts, const void* v, long long v_bs,
                   long long v_ts, const void* dout, long long d_bs, long long d_ts,
                   const void* lse, const void* D, void* dk, void* dv, int B, int SQ, int SK,
                   int q_off, int NQ, int NKV, int HD, float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (SQ < 1 || q_off < 0 || q_off + SQ > SK || NKV < 1 || NQ % NKV != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((SK + BK - 1) / BK, NKV, B);
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *dp = static_cast<const bf16*>(dout);
  const float *lp = static_cast<const float*>(lse), *Dp = static_cast<const float*>(D);
  bf16 *dkp = static_cast<bf16*>(dk), *dvp = static_cast<bf16*>(dv);
  if (HD == 64)
    return launch_dkdv<64>(grid, st, qp, q_bs, q_ts, kp, k_bs, k_ts, vp, v_bs, v_ts, dp, d_bs,
                           d_ts, lp, Dp, dkp, dvp, SQ, SK, q_off, NQ, NKV, scale);
  if (HD == 128)
    return launch_dkdv<128>(grid, st, qp, q_bs, q_ts, kp, k_bs, k_ts, vp, v_bs, v_ts, dp, d_bs,
                            d_ts, lp, Dp, dkp, dvp, SQ, SK, q_off, NQ, NKV, scale);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o, dout (B, S, NQ, HD), k / v (B, S, NKV, HD): each with its batch and
// token strides (elements), heads contiguous inside a token; lse and D
// (B, NQ, S) f32 (lse from flash_attention_fwd; D written here); dq
// (B, S, NQ, HD) contiguous. Requires HD in {64, 128}, NQ % NKV == 0, even
// strides. Launch before flash_attention_bwd_dkdv (which reads D).
extern "C" int flash_attention_bwd_dq(const void* q, long long q_bs, long long q_ts,
                                      const void* k, long long k_bs, long long k_ts,
                                      const void* v, long long v_bs, long long v_ts,
                                      const void* o, long long o_bs, long long o_ts,
                                      const void* dout, long long d_bs, long long d_ts,
                                      const void* lse, void* D, void* dq, int B, int S, int NQ,
                                      int NKV, int HD, float scale, void* stream) {
  return launch_dq(q, q_bs, q_ts, k, k_bs, k_ts, v, v_bs, v_ts, o, o_bs, o_ts, dout, d_bs,
                   d_ts, lse, D, dq, B, S, S, 0, NQ, NKV, HD, scale, stream);
}

// The same operands minus o; D as written by flash_attention_bwd_dq; dk / dv
// (B, S, NKV, HD) contiguous, each summed over the NQ / NKV query heads of
// its group.
extern "C" int flash_attention_bwd_dkdv(const void* q, long long q_bs, long long q_ts,
                                        const void* k, long long k_bs, long long k_ts,
                                        const void* v, long long v_bs, long long v_ts,
                                        const void* dout, long long d_bs, long long d_ts,
                                        const void* lse, const void* D, void* dk, void* dv,
                                        int B, int S, int NQ, int NKV, int HD, float scale,
                                        void* stream) {
  return launch_dkdv_hd(q, q_bs, q_ts, k, k_bs, k_ts, v, v_bs, v_ts, dout, d_bs, d_ts, lse, D,
                        dk, dv, B, S, S, 0, NQ, NKV, HD, scale, stream);
}

// One context-parallel shard: q, o, dout (B, SQ, NQ, HD) at global positions
// q_off .. q_off + SQ - 1, k / v (B, SK, NKV, HD) the gathered keys (any batch
// and token strides); lse and D (B, NQ, SQ) f32; dq (B, SQ, NQ, HD)
// contiguous. Requires q_off >= 0 and q_off + SQ <= SK.
extern "C" int flash_attention_cp_bwd_dq(const void* q, long long q_bs, long long q_ts,
                                         const void* k, long long k_bs, long long k_ts,
                                         const void* v, long long v_bs, long long v_ts,
                                         const void* o, long long o_bs, long long o_ts,
                                         const void* dout, long long d_bs, long long d_ts,
                                         const void* lse, void* D, void* dq, int B, int SQ,
                                         int SK, int q_off, int NQ, int NKV, int HD,
                                         float scale, void* stream) {
  return launch_dq(q, q_bs, q_ts, k, k_bs, k_ts, v, v_bs, v_ts, o, o_bs, o_ts, dout, d_bs,
                   d_ts, lse, D, dq, B, SQ, SK, q_off, NQ, NKV, HD, scale, stream);
}

// dk / dv (B, SK, NKV, HD) contiguous: this shard's part of every gathered
// key's gradient, zero for keys past its last row.
extern "C" int flash_attention_cp_bwd_dkdv(const void* q, long long q_bs, long long q_ts,
                                           const void* k, long long k_bs, long long k_ts,
                                           const void* v, long long v_bs, long long v_ts,
                                           const void* dout, long long d_bs, long long d_ts,
                                           const void* lse, const void* D, void* dk, void* dv,
                                           int B, int SQ, int SK, int q_off, int NQ, int NKV,
                                           int HD, float scale, void* stream) {
  return launch_dkdv_hd(q, q_bs, q_ts, k, k_bs, k_ts, v, v_bs, v_ts, dout, d_bs, d_ts, lse, D,
                        dk, dv, B, SQ, SK, q_off, NQ, NKV, HD, scale, stream);
}
