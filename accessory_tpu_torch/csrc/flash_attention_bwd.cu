// Causal self-attention backward with native GQA: dq, dk, dv of
// csrc/flash_attention.cu's forward.
//
// Replaces: the backward of accessory_tpu/ops/flash_attention.py::
// flash_attention_tpu (:86), JAX's bundled TPU splash kernels
// `_splash_attention_bwd_dq` and `_splash_attention_bwd_dkv`, reached through
// the custom VJP of `_splash_kernel` (:61); and the same for
// accessory_tpu/parallel/context.py::_splash_cp_kernel (:46).
//
// The FlashAttention-2 split, in two launches on one stream (no atomics, so
// two calls give the same bits):
//   flash_attention_bwd_dq    an item is 128 query rows of one query head.
//                             It computes D = rowsum(dO * O) of its rows (f32,
//                             stored for the second launch), then walks the
//                             key tiles up to its last row's diagonal: S = Q
//                             K^T, P = 2^(S scale log2(e) - lse log2(e)) from
//                             the forward's f32 log-sum-exp, dP = dO V^T,
//                             dS = P (dP - D), dQ += dS K.
//   flash_attention_bwd_dkdv  an item is 128 key rows of one kv head. It walks
//                             the query tiles at or past its first key, of
//                             each query head of the GQA group: S^T = K Q^T,
//                             P^T, dP^T = V dO^T, dS^T, dV += P^T dO and dK +=
//                             dS^T Q. The group's heads are summed in
//                             registers, or, where the grid would be short of
//                             the card's SMs, split over the `split` blocks of
//                             a thread-block cluster (R / split heads each)
//                             whose f32 partial sums are added in rank order
//                             through distributed shared memory before the
//                             one store.
// P and dS are rounded to bf16 as the products' inputs, sums are f32, dq and
// dk are scaled by `scale` at the store. Query rows past a ragged end get no
// dq and add nothing to dk / dv (their lse is taken as +inf, so P = 0); keys
// past SK are past every query (the causal mask).
//
// Design (csrc/flash_attention.cu's): a producer warpgroup (registers handed
// to the consumers by setmaxnreg) issues TMA boxes of 64 head-dim columns in
// the 128-byte swizzle; two consumer warpgroups of 64 rows run every product on
// wgmma. Operands that run along the head dim (Q, K, V, dO for S / dP and
// their transposes) are K-major shared-memory operands; K, Q and dO as the B
// of dQ += dS K, dK += dS^T Q and dV += P^T dO are MN-major, as the forward
// reads V, with dS / P^T / dS^T as the register operand A (the accumulator
// layout of S is the A-fragment layout). dq loads Q, dO and O once and
// streams K / V tiles through a ring of STAGES stages (mbarriers `full` /
// `empty`); dk / dv loads K / V once and streams Q / dO tiles, with the
// producer's second warp staging each tile's lse (in log2 units) and D. A
// warpgroup skips a tile wholly before its first key and masks only tiles
// that cross the diagonal. Items run longest first (dq: the last query
// tiles; dk / dv: the first key tiles); the plan is mirrored by
// ops/flash_attention.py::bwd_plan.
//
// Context parallelism (the cp entries): a shard's SQ query rows sit at global
// positions q_off .. q_off + SQ - 1 over SK gathered keys. dq's key tiles are
// aligned at key 0 and a row's arithmetic does not depend on the item that
// holds it, so a shard's dq rows are the unsharded kernel's bits. dk / dv
// covers all SK keys: a key tile past the shard's last row walks nothing and
// stores zeros, so the reduce-scatter adds no stale memory. The flash entries
// are the case q_off = 0, SK = SQ of the same bodies and plan.
//
// Bound on the H100: seven causal products of 2 * S^2 * HD / 2 flops per
// query head (dq: S, dP, dQ; dk / dv: S, dP, dV, dK) against q, k, v, o, dO
// read and dq, dk, dv written once; tensor-core bound from a few hundred
// tokens on.
//
// What the card taught (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py
// --phases compare, PERF.md rows 3b and 26): both launches take 820-824 us at
// train_cp's B1 S4096 (59% of the bf16 peak on the seven-product count;
// SDPA's backward 767-819), 230.5 at the 700M's B2 S2048, 16 / 8 heads (SDPA
// 282-285), 263 at the 7B QPEFT's B8 S512 (SDPA 253) and 38 at TinyLlama's
// B4 S256, 32 / 4 heads (SDPA 38.4). There each block walks one to eight
// tiles, and its fixed cost (the loads before its first tile, the f32 sums
// through shared memory, the cluster's barriers) sets the time. Clusters of
// 8 blocks ran fewer at once than the SMs hold blocks, so a one-wave grid
// took two; the plan caps the split at 4.
//
// The design it replaces (4 warps of mma.sync over 64-row tiles, tiles
// staged with plain loads between two barriers, B fragments of the
// transposed products built from 16-bit shared loads, one dk / dv block
// walking its group's R heads) took 1234-1244 us at the 700M's shape and
// 3694-3719 at train_cp's on the same card (the same calls, in turns).

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CONSUMER_WARPS = 8;                     // two consumer warpgroups
constexpr int THREADS = 32 * CONSUMER_WARPS + 128;    // + the producer warpgroup
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;   // setmaxnreg: 64,512 of 65,536
constexpr int STAGES = 2;
constexpr int ROWS = 128;       // an item's rows (dq: queries, dk / dv: keys), 64 a warpgroup
constexpr int BQT = 64;         // dk / dv: query rows a stage (registers: 128 spill at hd 64)
constexpr int SMS = 132;        // the plan's SM count (the H100 SXM's), not the device's
// blocks of a cluster: at 8 (the portable most) the H100 ran fewer clusters
// at once than the SMs hold blocks, and a one-wave grid took two
constexpr int MAX_SPLIT = 4;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// a 64-row warpgroup tile of N = 64 or 128 columns: A and B K-major in
// shared memory (ss), or A in registers and B MN-major (rs)
template <int N>
__device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == 64)
    hopper::wgmma_ss_64x64x16(d, a, b, acc);
  else
    hopper::wgmma_ss_64x128x16(d, a, b, acc);
}

template <int N>
__device__ __forceinline__ void rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int acc) {
  if constexpr (N == 64)
    hopper::wgmma_rs_64x64x16<1>(d, a, b, acc);
  else
    hopper::wgmma_rs_64x128x16<1>(d, a, b, acc);
}

// k16 step kk of a K-major operand (rows of 64-column boxes `half` bytes apart)
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int half, int kk) {
  return hopper::desc_b128(base + (kk >> 2) * half + (kk & 3) * 32, 16, 1024);
}

// k16 step c (16 rows) of an MN-major operand (the next 64 columns `half` on)
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int half, int c) {
  return hopper::desc_b128(base + c * 2048, half, 1024);
}

// d (64 x N) = A B^T over HD: one wgmma group (its descriptors and flags
// pinned before the fence, after `bar` has landed), committed, not waited for
template <int N, int HD>
__device__ __forceinline__ void ss_group(float (&d)[N / 2], uint32_t a, int a_half, uint32_t b,
                                         int b_half, uint64_t* bar, int par) {
  uint64_t da[HD / 16], db[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    da[kk] = desc_k(a, a_half, kk);
    db[kk] = desc_k(b, b_half, kk);
    hopper::pin(da[kk]);
    hopper::pin(db[kk]);
  }
  int zero = 0, one = 1;
  hopper::pin(zero);
  hopper::pin(one);
  if (bar != nullptr) hopper::mbar_wait(bar, par);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) ss<N>(d, da[kk], db[kk], kk > 0 ? one : zero);
  hopper::wgmma_commit();
}

// the accumulator of N columns as the A fragments of a product over them:
// k16 chunk c holds columns 16c .. 16c + 15, rounded to bf16
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&p)[N / 16][4], const float (&s)[N / 2]) {
#pragma unroll
  for (int c = 0; c < N / 16; ++c) {
    p[c][0] = pack_bf16x2(s[8 * c], s[8 * c + 1]);
    p[c][1] = pack_bf16x2(s[8 * c + 2], s[8 * c + 3]);
    p[c][2] = pack_bf16x2(s[8 * c + 4], s[8 * c + 5]);
    p[c][3] = pack_bf16x2(s[8 * c + 6], s[8 * c + 7]);
  }
}

__device__ __forceinline__ float dot8(uint4 x, uint4 y, float acc) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
  }
  return acc;
}

struct BwdArgs {
  // 4-d maps (head dim, heads, then tokens and batch in the order of their
  // strides), boxes of the kernel's rows: q, k, v, dO; dq only: out and dq
  // (a store map of 64-row boxes)
  CUtensorMap qmap, kmap, vmap, dmap, omap, dqmap;
  const float* lse;   // (B, NQ, SQ)
  float* D;           // (B, NQ, SQ): dq writes, dk / dv reads
  bf16 *dk, *dv;      // (B, SK, NKV, HD)
  int SQ, SK, qoff, NQ, NKV, R, B;
  int tiles;          // dq: query tiles of 128 rows; dk / dv: key tiles of 128
  int split;          // dk / dv: blocks of a cluster, R / split query heads each
  int q_tok_inner, k_tok_inner, v_tok_inner, d_tok_inner, o_tok_inner;
  float scale, scale_log2;
};

// ---------------------------------------------------------------- dq (+ D)

template <int HD>
struct Dq {
  static constexpr int BKV = HD == 128 ? 64 : 128;    // keys a stage (registers: dQ, S, dP)
  static constexpr int HALVES = HD / 64;
  static constexpr int ROW_HALF = ROWS * 128;         // a 64-column box of the item's rows
  static constexpr int ROW_BYTES = HALVES * ROW_HALF; // the item's Q, dO or O
  static constexpr int KV_HALF = BKV * 128;
  static constexpr int KV_BYTES = HALVES * KV_HALF;   // a K or V tile
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int SMEM = 3 * ROW_BYTES + STAGES * STAGE + 1024;   // + the alignment
};

// Block w: query tile tiles - 1 - w / (NQ B) (the longest first) of head
// (w % NQ B) % NQ of batch row (w % NQ B) / NQ, and the key tiles up to its
// last row's diagonal.
struct DqItem {
  int b, hq, hk, p0, n_tiles;
  __device__ DqItem(const BwdArgs& a, int w, int bkv) {
    const int per = a.NQ * a.B;
    hq = (w % per) % a.NQ;
    b = (w % per) / a.NQ;
    hk = hq / a.R;
    p0 = (a.tiles - 1 - w / per) * ROWS;
    n_tiles = min(a.qoff + min(a.SQ, p0 + ROWS) - 1, a.SK - 1) / bkv + 1;
  }
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ BwdArgs a) {
  using F = Dq<HD>;
  constexpr int BKV = F::BKV, NS = BKV / 2, NA = HD / 2;   // accumulators a thread: S / dP, dQ
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t rows_full, kfull[STAGES], vfull[STAGES], empty[STAGES];
  __shared__ float Ds[ROWS];
  unsigned char* qs = hopper::align1024(smem_raw);   // Q, dO, O, then the ring
  unsigned char* dos = qs + F::ROW_BYTES;
  unsigned char* os = qs + 2 * F::ROW_BYTES;
  unsigned char* ring = qs + 3 * F::ROW_BYTES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const DqItem im(a, blockIdx.x, BKV);

  if (tid == 0) {
    hopper::mbar_init(&rows_full, 1);
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(&kfull[i], 1);
      hopper::mbar_init(&vfull[i], 1);
      hopper::mbar_init(&empty[i], CONSUMER_WARPS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {   // the producer warpgroup: one lane issues every copy
    hopper::regs_dec<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      hopper::mbar_expect_tx(&rows_full, 3 * F::ROW_BYTES);
#pragma unroll
      for (int h = 0; h < F::HALVES; ++h) {
        const int off = h * F::ROW_HALF;
        hopper::load4(qs + off, &a.qmap, a.q_tok_inner, 64 * h, im.hq, im.p0, im.b, &rows_full);
        hopper::load4(dos + off, &a.dmap, a.d_tok_inner, 64 * h, im.hq, im.p0, im.b, &rows_full);
        hopper::load4(os + off, &a.omap, a.o_tok_inner, 64 * h, im.hq, im.p0, im.b, &rows_full);
      }
      for (int j = 0; j < im.n_tiles; ++j) {
        const int slot = j % STAGES;
        if (j >= STAGES) hopper::mbar_wait(&empty[slot], (j / STAGES - 1) & 1);
        unsigned char* ks = ring + slot * F::STAGE;
        hopper::mbar_expect_tx(&kfull[slot], F::KV_BYTES);
#pragma unroll
        for (int h = 0; h < F::HALVES; ++h)
          hopper::load4(ks + h * F::KV_HALF, &a.kmap, a.k_tok_inner, 64 * h, im.hk, j * BKV,
                        im.b, &kfull[slot]);
        hopper::mbar_expect_tx(&vfull[slot], F::KV_BYTES);
#pragma unroll
        for (int h = 0; h < F::HALVES; ++h)
          hopper::load4(ks + F::KV_BYTES + h * F::KV_HALF, &a.vmap, a.v_tok_inner, 64 * h, im.hk,
                        j * BKV, im.b, &vfull[slot]);
      }
    }
    return;
  }

  hopper::regs_inc<CONSUMER_REGS>();
  // thread (g, t) of warp w of warpgroup wg holds item rows ra and rb = ra + 8
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3, u = tid & 127;
  const int ra = 64 * wg + 16 * (warp & 3) + g, rb = ra + 8;
  const int la = im.p0 + ra, lb = im.p0 + rb;   // local rows (global positions qoff + l)
  const size_t row_base = ((size_t)im.b * a.NQ + im.hq) * a.SQ;
  // the lse in log2 units; rows past SQ take +inf, so their P is 0
  const float lse_a = la < a.SQ ? a.lse[row_base + la] * LOG2E : inf_f();
  const float lse_b = lb < a.SQ ? a.lse[row_base + lb] * LOG2E : inf_f();
  hopper::mbar_wait(&rows_full, 0);
  {  // D = rowsum(dO * O) in f32: two threads a row, half its columns each
    const int r = 64 * wg + (u >> 1), h = u & 1;
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      const int box = HD == 128 ? h : 0, chunk = HD == 128 ? c : 4 * h + c;
      const int off = box * F::ROW_HALF + r * 128 + ((chunk ^ (r & 7)) << 4);
      const uint4 x = *reinterpret_cast<const uint4*>(dos + off);
      d = dot8(x, *reinterpret_cast<const uint4*>(os + off), d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (h == 0) {
      Ds[r] = d;
      if (im.p0 + r < a.SQ) a.D[row_base + im.p0 + r] = d;
    }
  }
  hopper::named_sync(1 + wg, 128);
  const float D_a = Ds[ra], D_b = Ds[rb];

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  const uint32_t qaddr = hopper::smem_addr(qs) + wg * 64 * 128;
  const uint32_t daddr = hopper::smem_addr(dos) + wg * 64 * 128;
  const int wg_first = a.qoff + im.p0 + 64 * wg;   // the warpgroup's first position
  const int pos_a = a.qoff + la, pos_b = a.qoff + lb;
  for (int j = 0; j < im.n_tiles; ++j) {
    const int slot = j % STAGES, par = (j / STAGES) & 1, kv0 = j * BKV;
    const uint32_t kaddr = hopper::smem_addr(ring + slot * F::STAGE);
    float s[NS], dp[NS];
    ss_group<BKV, HD>(s, qaddr, F::ROW_HALF, kaddr, F::KV_HALF, &kfull[slot], par);
    ss_group<BKV, HD>(dp, daddr, F::ROW_HALF, kaddr + F::KV_BYTES, F::KV_HALF, &vfull[slot], par);
    hopper::wgmma_wait<0>();
    hopper::reg_fence(s);
    hopper::reg_fence(dp);
    // the causal mask, only where the tile reaches past the warpgroup's first
    // row (keys past SK are past every row): column c = 8i + 2t + (e & 1)
    if (kv0 + BKV - 1 > wg_first) {
      const int lim_a = pos_a - kv0 - 2 * t, lim_b = pos_b - kv0 - 2 * t;
#pragma unroll
      for (int i = 0; i < NS / 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * i + (e & 1) > (e < 2 ? lim_a : lim_b)) s[4 * i + e] = NEG_INF_F;
      }
    }
    // dS = P (dP - D), P = 2^(s scale log2(e) - lse log2(e))
#pragma unroll
    for (int i = 0; i < NS / 4; ++i) {
      s[4 * i] = hopper::ex2(fmaf(s[4 * i], a.scale_log2, -lse_a)) * (dp[4 * i] - D_a);
      s[4 * i + 1] = hopper::ex2(fmaf(s[4 * i + 1], a.scale_log2, -lse_a)) * (dp[4 * i + 1] - D_a);
      s[4 * i + 2] = hopper::ex2(fmaf(s[4 * i + 2], a.scale_log2, -lse_b)) * (dp[4 * i + 2] - D_b);
      s[4 * i + 3] = hopper::ex2(fmaf(s[4 * i + 3], a.scale_log2, -lse_b)) * (dp[4 * i + 3] - D_b);
    }
    uint32_t ds[BKV / 16][4];
    pack_a<BKV>(ds, s);
    uint64_t bk[BKV / 16];   // K as the MN-major B of dQ += dS K: 16 keys a step
#pragma unroll
    for (int c = 0; c < BKV / 16; ++c) {
      bk[c] = desc_mn(kaddr, F::KV_HALF, c);
      hopper::pin(bk[c]);
      hopper::pin(ds[c]);
    }
    int one = 1;
    hopper::pin(one);
    hopper::reg_fence(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < BKV / 16; ++c) rs<HD>(acc, ds[c], bk[c], one);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < BKV / 16; ++c) hopper::reg_keep(ds[c]);
    hopper::reg_fence(acc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[slot]);
  }

  // dQ scale: the warpgroup's rows into its (now idle) Q rows in the TMA
  // box's swizzled layout (16-byte chunk c of row r at chunk c ^ (r % 8)),
  // then one TMA store a 64-column half (rows past SQ are not written)
#pragma unroll
  for (int i = 0; i < NA / 4; ++i) {
    unsigned char* half = qs + (i / 8) * F::ROW_HALF + 4 * t;
    const int c = i % 8;
    *reinterpret_cast<uint32_t*>(half + ra * 128 + ((c ^ (ra & 7)) << 4)) =
        pack_bf16x2(acc[4 * i] * a.scale, acc[4 * i + 1] * a.scale);
    *reinterpret_cast<uint32_t*>(half + rb * 128 + ((c ^ (rb & 7)) << 4)) =
        pack_bf16x2(acc[4 * i + 2] * a.scale, acc[4 * i + 3] * a.scale);
  }
  hopper::fence_async_shared();
  hopper::named_sync(1 + wg, 128);
  if (u == 0) {
#pragma unroll
    for (int h = 0; h < F::HALVES; ++h)
      hopper::tma_store_4d(&a.dqmap, qs + h * F::ROW_HALF + wg * 64 * 128, 64 * h, im.hq,
                           im.p0 + 64 * wg, im.b);
    hopper::tma_store_wait();
  }
}

// ---------------------------------------------------------------- dk, dv

template <int HD>
struct Dkdv {
  static constexpr int HALVES = HD / 64;
  static constexpr int KV_HALF = ROWS * 128;
  static constexpr int KV_BYTES = HALVES * KV_HALF;   // the item's K or V rows
  static constexpr int QT_HALF = BQT * 128;
  static constexpr int QT_BYTES = HALVES * QT_HALF;   // a Q or dO tile
  static constexpr int STAGE = 2 * QT_BYTES;
  static constexpr int MAIN = 2 * KV_BYTES + STAGES * STAGE;   // then lse and D a stage
  static constexpr int LOADS = MAIN + STAGES * 2 * BQT * 4;
  static constexpr int RED_LD = HD + 4;               // an f32 row of the partial sums
  static constexpr int RED = 2 * ROWS * RED_LD * 4;   // dK and dV, over the loads' memory
  static constexpr int SMEM = (LOADS > RED ? LOADS : RED) + 1024;
};

// Block x: rank x % split of the cluster of item w = x / split, key tile
// w / (NKV B) (the longest first) of kv head (w % NKV B) % NKV of batch row
// (w % NKV B) / NKV; its query heads hk R + rank R / split .., R / split of
// them; the query tiles i_first .. of each.
struct DkdvItem {
  int b, hk, k0, rank, i_first, n_qt;
  __device__ DkdvItem(const BwdArgs& a, int x) {
    const int w = x / a.split, per = a.NKV * a.B;
    rank = x % a.split;
    k0 = (w / per) * ROWS;
    hk = (w % per) % a.NKV;
    b = (w % per) / a.NKV;
    i_first = max(0, k0 - a.qoff) / BQT;
    n_qt = max(0, (a.SQ + BQT - 1) / BQT - i_first);
  }
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ BwdArgs a) {
  using F = Dkdv<HD>;
  constexpr int NS = BQT / 2, NA = HD / 2;   // accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, full[STAGES], empty[STAGES];
  unsigned char* ks = hopper::align1024(smem_raw);   // K, V, the ring, lse and D
  unsigned char* vs = ks + F::KV_BYTES;
  unsigned char* ring = ks + 2 * F::KV_BYTES;
  float* lse_s = reinterpret_cast<float*>(ks + F::MAIN);   // [STAGES][BQT], log2 units
  float* D_s = lse_s + STAGES * BQT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const DkdvItem im(a, blockIdx.x);
  const int heads = a.R / a.split, hq0 = im.hk * a.R + im.rank * heads;

  if (tid == 0) {
    hopper::mbar_init(&kv_full, 1);
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(&full[i], 1 + 32);   // the copies' arrival + the lse / D warp's lanes
      hopper::mbar_init(&empty[i], CONSUMER_WARPS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {   // the producer warpgroup
    hopper::regs_dec<PRODUCER_REGS>();
    const bool issuer = warp == CONSUMER_WARPS && lane == 0;   // every TMA copy
    const bool stager = warp == CONSUMER_WARPS + 1;            // each tile's lse and D
    if (im.n_qt > 0 && (issuer || stager)) {
      if (issuer) {
        hopper::mbar_expect_tx(&kv_full, 2 * F::KV_BYTES);
#pragma unroll
        for (int h = 0; h < F::HALVES; ++h) {
          hopper::load4(ks + h * F::KV_HALF, &a.kmap, a.k_tok_inner, 64 * h, im.hk, im.k0, im.b,
                        &kv_full);
          hopper::load4(vs + h * F::KV_HALF, &a.vmap, a.v_tok_inner, 64 * h, im.hk, im.k0, im.b,
                        &kv_full);
        }
      }
      int it = 0;
      for (int hq = hq0; hq < hq0 + heads; ++hq) {
        const size_t row_base = ((size_t)im.b * a.NQ + hq) * a.SQ;
        for (int i = im.i_first; i < im.i_first + im.n_qt; ++i, ++it) {
          const int slot = it % STAGES;
          if (it >= STAGES) hopper::mbar_wait(&empty[slot], (it / STAGES - 1) & 1);
          if (issuer) {
            unsigned char* qt = ring + slot * F::STAGE;
            hopper::mbar_expect_tx(&full[slot], F::STAGE);
#pragma unroll
            for (int h = 0; h < F::HALVES; ++h) {
              hopper::load4(qt + h * F::QT_HALF, &a.qmap, a.q_tok_inner, 64 * h, hq, i * BQT, im.b,
                            &full[slot]);
              hopper::load4(qt + F::QT_BYTES + h * F::QT_HALF, &a.dmap, a.d_tok_inner, 64 * h, hq,
                            i * BQT, im.b, &full[slot]);
            }
          } else {
            for (int r = lane; r < BQT; r += 32) {
              const int q = i * BQT + r;
              lse_s[slot * BQT + r] = q < a.SQ ? a.lse[row_base + q] * LOG2E : inf_f();
              D_s[slot * BQT + r] = q < a.SQ ? a.D[row_base + q] : 0.f;
            }
            hopper::mbar_arrive(&full[slot]);
          }
        }
      }
    }
    if (a.split > 1) {   // the consumers' two cluster barriers
      __syncwarp();
      cg::this_cluster().sync();
      cg::this_cluster().sync();
    }
    return;
  }

  hopper::regs_inc<CONSUMER_REGS>();
  // thread (g, t) of warp w of warpgroup wg holds keys key_a and key_b
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int ra = 64 * wg + 16 * (warp & 3) + g, rb = ra + 8;
  const int kw0 = im.k0 + 64 * wg;   // the warpgroup's first key
  const int key_a = im.k0 + ra, key_b = im.k0 + rb;
  float dk[NA], dv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dk[i] = dv[i] = 0.f;
  if (im.n_qt > 0) {
    const uint32_t kaddr = hopper::smem_addr(ks) + wg * 64 * 128;
    const uint32_t vaddr = hopper::smem_addr(vs) + wg * 64 * 128;
    hopper::mbar_wait(&kv_full, 0);
    int it = 0;
    for (int hi = 0; hi < heads; ++hi) {
      for (int i = im.i_first; i < im.i_first + im.n_qt; ++i, ++it) {
        const int slot = it % STAGES, par = (it / STAGES) & 1;
        const int qpos0 = a.qoff + i * BQT;   // the tile's first query position
        hopper::mbar_wait(&full[slot], par);
        // a tile wholly before the warpgroup's first key adds nothing
        if (qpos0 + BQT - 1 >= kw0) {
          const uint32_t qaddr = hopper::smem_addr(ring + slot * F::STAGE);
          const uint32_t daddr = qaddr + F::QT_BYTES;
          float s[NS], dp[NS];
          ss_group<BQT, HD>(s, kaddr, F::KV_HALF, qaddr, F::QT_HALF, nullptr, 0);
          ss_group<BQT, HD>(dp, vaddr, F::KV_HALF, daddr, F::QT_HALF, nullptr, 0);
          hopper::wgmma_wait<0>();
          hopper::reg_fence(s);
          hopper::reg_fence(dp);
          // the causal mask (key > query), only where the tile crosses the
          // diagonal: column c = 8j + 2t + (e & 1) is query qpos0 + c
          if (kw0 + 63 > qpos0) {
            const int lim_a = key_a - qpos0 - 2 * t, lim_b = key_b - qpos0 - 2 * t;
#pragma unroll
            for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (8 * j + (e & 1) < (e < 2 ? lim_a : lim_b)) s[4 * j + e] = NEG_INF_F;
            }
          }
          // P^T = 2^(s scale log2(e) - lse log2(e)), dS^T = P^T (dP^T - D)
          const float* ls = lse_s + slot * BQT + 2 * t;
          const float* dd = D_s + slot * BQT + 2 * t;
#pragma unroll
          for (int j = 0; j < NS / 4; ++j) {
            const float2 l = *reinterpret_cast<const float2*>(ls + 8 * j);
            const float2 d = *reinterpret_cast<const float2*>(dd + 8 * j);
            s[4 * j] = hopper::ex2(fmaf(s[4 * j], a.scale_log2, -l.x));
            s[4 * j + 1] = hopper::ex2(fmaf(s[4 * j + 1], a.scale_log2, -l.y));
            s[4 * j + 2] = hopper::ex2(fmaf(s[4 * j + 2], a.scale_log2, -l.x));
            s[4 * j + 3] = hopper::ex2(fmaf(s[4 * j + 3], a.scale_log2, -l.y));
            dp[4 * j] = s[4 * j] * (dp[4 * j] - d.x);
            dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - d.y);
            dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - d.x);
            dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - d.y);
          }
          uint32_t pa[BQT / 16][4], sa[BQT / 16][4];
          pack_a<BQT>(pa, s);
          pack_a<BQT>(sa, dp);
          uint64_t bdo[BQT / 16], bq[BQT / 16];   // dO and Q as MN-major B: 16 queries a step
#pragma unroll
          for (int c = 0; c < BQT / 16; ++c) {
            bdo[c] = desc_mn(daddr, F::QT_HALF, c);
            bq[c] = desc_mn(qaddr, F::QT_HALF, c);
            hopper::pin(bdo[c]);
            hopper::pin(bq[c]);
            hopper::pin(pa[c]);
            hopper::pin(sa[c]);
          }
          int one = 1;
          hopper::pin(one);
          hopper::reg_fence(dk);
          hopper::reg_fence(dv);
          hopper::wgmma_fence();
#pragma unroll
          for (int c = 0; c < BQT / 16; ++c) rs<HD>(dv, pa[c], bdo[c], one);
#pragma unroll
          for (int c = 0; c < BQT / 16; ++c) rs<HD>(dk, sa[c], bq[c], one);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
#pragma unroll
          for (int c = 0; c < BQT / 16; ++c) {
            hopper::reg_keep(pa[c]);
            hopper::reg_keep(sa[c]);
          }
          hopper::reg_fence(dk);
          hopper::reg_fence(dv);
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[slot]);
      }
    }
  }

  // the f32 sums into shared memory over the loads' (both warpgroups are
  // done with K, V and the ring), then block `rank` of the cluster adds its
  // share of the rows (ceil(ROWS / split) from rank ROWS / split on) of every
  // rank's, in rank order, and stores them
  hopper::named_sync(1, 32 * CONSUMER_WARPS);
  float* red_k = reinterpret_cast<float*>(ks);
  float* red_v = red_k + ROWS * F::RED_LD;
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const int a_off = ra * F::RED_LD + 8 * j + 2 * t, b_off = rb * F::RED_LD + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(red_k + a_off) = make_float2(dk[4 * j], dk[4 * j + 1]);
    *reinterpret_cast<float2*>(red_k + b_off) = make_float2(dk[4 * j + 2], dk[4 * j + 3]);
    *reinterpret_cast<float2*>(red_v + a_off) = make_float2(dv[4 * j], dv[4 * j + 1]);
    *reinterpret_cast<float2*>(red_v + b_off) = make_float2(dv[4 * j + 2], dv[4 * j + 3]);
  }
  if (a.split > 1)
    cg::this_cluster().sync();   // every rank's sums are written
  else
    hopper::named_sync(1, 32 * CONSUMER_WARPS);
  const int rows = (ROWS + a.split - 1) / a.split, r0 = im.rank * rows;
  const int units = min(rows, ROWS - r0) * (HD / 8);   // 8 columns a unit
  for (int x = tid; x < units; x += 32 * CONSUMER_WARPS) {
    const int r = r0 + x / (HD / 8), col = (x % (HD / 8)) * 8, key = im.k0 + r;
    const int off = r * F::RED_LD + col;
    // 8 columns of dK and of dV from every rank, all loads in flight at once
    float4 part[MAX_SPLIT][4];
#pragma unroll
    for (int rk = 0; rk < MAX_SPLIT; ++rk) {
      if (rk < a.split) {
        const float* pk = a.split > 1 ? cg::this_cluster().map_shared_rank(red_k, rk) : red_k;
        const float* pv = a.split > 1 ? cg::this_cluster().map_shared_rank(red_v, rk) : red_v;
        part[rk][0] = *reinterpret_cast<const float4*>(pk + off);
        part[rk][1] = *reinterpret_cast<const float4*>(pk + off + 4);
        part[rk][2] = *reinterpret_cast<const float4*>(pv + off);
        part[rk][3] = *reinterpret_cast<const float4*>(pv + off + 4);
      }
    }
#pragma unroll
    for (int rk = 1; rk < MAX_SPLIT; ++rk) {   // in rank order
      if (rk < a.split) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          part[0][i].x += part[rk][i].x;
          part[0][i].y += part[rk][i].y;
          part[0][i].z += part[rk][i].z;
          part[0][i].w += part[rk][i].w;
        }
      }
    }
    if (key < a.SK) {
      const size_t o = (((size_t)im.b * a.SK + key) * a.NKV + im.hk) * HD + col;
      const float sc = a.scale;
      const float4 k0 = part[0][0], k1 = part[0][1], v0 = part[0][2], v1 = part[0][3];
      *reinterpret_cast<uint4*>(a.dk + o) =
          make_uint4(pack_bf16x2(k0.x * sc, k0.y * sc), pack_bf16x2(k0.z * sc, k0.w * sc),
                     pack_bf16x2(k1.x * sc, k1.y * sc), pack_bf16x2(k1.z * sc, k1.w * sc));
      *reinterpret_cast<uint4*>(a.dv + o) =
          make_uint4(pack_bf16x2(v0.x, v0.y), pack_bf16x2(v0.z, v0.w), pack_bf16x2(v1.x, v1.y),
                     pack_bf16x2(v1.z, v1.w));
    }
  }
  if (a.split > 1) cg::this_cluster().sync();   // the sums outlive the other ranks' reads
}

// ---------------------------------------------------------------- host side

// the largest divisor of R (at most MAX_SPLIT) whose clusters still run in
// one wave on the card's SMs (1 where the items alone fill them)
int dkdv_split(int items, int R) {
  int split = 1;
  for (int d = 2; d <= R && d <= MAX_SPLIT && items * d <= SMS; ++d)
    if (R % d == 0) split = d;
  return split;
}

// the maps and shape of one backward call; rows: the kernel's item rows
// (dq: q / dO / O boxes of 128, k / v of BKV; dk / dv: k / v of 128, q / dO
// of BQT)
cudaError_t make_args(BwdArgs* a, bool dq, const void* q, long long q_bs, long long q_ts,
                      const void* k, long long k_bs, long long k_ts, const void* v,
                      long long v_bs, long long v_ts, const void* o, long long o_bs,
                      long long o_ts, const void* dout, long long d_bs, long long d_ts,
                      const void* lse, const void* D, void* dqp, int B, int SQ, int SK, int q_off,
                      int NQ, int NKV, int HD, float scale) {
  if (B < 1 || SQ < 1 || q_off < 0 || q_off + SQ > SK || NKV < 1 || NQ % NKV != 0 ||
      (HD != 64 && HD != 128))
    return cudaErrorInvalidValue;
  cudaError_t e = hopper::bind_device_of(q);
  if (e != cudaSuccess) return e;
  a->lse = static_cast<const float*>(lse);
  a->D = const_cast<float*>(static_cast<const float*>(D));
  a->SQ = SQ;
  a->SK = SK;
  a->qoff = q_off;
  a->NQ = NQ;
  a->NKV = NKV;
  a->R = NQ / NKV;
  a->B = B;
  a->scale = scale;
  a->scale_log2 = scale * LOG2E;
  const int q_rows = dq ? ROWS : BQT;
  const int k_rows = dq ? (HD == 128 ? Dq<128>::BKV : Dq<64>::BKV) : ROWS;
  a->tiles = dq ? (SQ + ROWS - 1) / ROWS : (SK + ROWS - 1) / ROWS;
  // the split counts the items with work: key tiles past a shard's last row
  // only store zeros
  const int work_tiles = min(a->tiles, (q_off + SQ - 1) / ROWS + 1);
  a->split = dq ? 1 : dkdv_split(work_tiles * NKV * B, a->R);
  using hopper::qkv_map;
  if ((e = qkv_map(&a->qmap, &a->q_tok_inner, q, q_bs, q_ts, B, SQ, NQ, HD, 1, q_rows)) !=
          cudaSuccess ||
      (e = qkv_map(&a->dmap, &a->d_tok_inner, dout, d_bs, d_ts, B, SQ, NQ, HD, 1, q_rows)) !=
          cudaSuccess ||
      (e = qkv_map(&a->kmap, &a->k_tok_inner, k, k_bs, k_ts, B, SK, NKV, HD, 1, k_rows)) !=
          cudaSuccess ||
      (e = qkv_map(&a->vmap, &a->v_tok_inner, v, v_bs, v_ts, B, SK, NKV, HD, 1, k_rows)) !=
          cudaSuccess)
    return e;
  if (dq) {
    int dq_tok_inner;
    if ((e = qkv_map(&a->omap, &a->o_tok_inner, o, o_bs, o_ts, B, SQ, NQ, HD, 1, ROWS)) !=
            cudaSuccess ||
        (e = qkv_map(&a->dqmap, &dq_tok_inner, dqp, (long long)SQ * NQ * HD, (long long)NQ * HD,
                     B, SQ, NQ, HD, 1, 64)) != cudaSuccess)
      return e;
  }
  return cudaSuccess;
}

template <int HD>
cudaError_t launch_dq_hd(const BwdArgs& a, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, Dq<HD>::SMEM);
  if (attr != cudaSuccess) return attr;
  flash_bwd_dq_wgmma_kernel<HD><<<a.tiles * a.NQ * a.B, THREADS, Dq<HD>::SMEM, st>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkdv_hd(const BwdArgs& a, cudaStream_t st) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, Dkdv<HD>::SMEM);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.tiles * a.NKV * a.B * a.split, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = Dkdv<HD>::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, flash_bwd_dkdv_wgmma_kernel<HD>, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

int launch_dq(const void* q, long long q_bs, long long q_ts, const void* k, long long k_bs,
              long long k_ts, const void* v, long long v_bs, long long v_ts, const void* o,
              long long o_bs, long long o_ts, const void* dout, long long d_bs, long long d_ts,
              const void* lse, void* D, void* dq, int B, int SQ, int SK, int q_off, int NQ,
              int NKV, int HD, float scale, void* stream) {
  BwdArgs a{};
  cudaError_t e = make_args(&a, true, q, q_bs, q_ts, k, k_bs, k_ts, v, v_bs, v_ts, o, o_bs, o_ts,
                            dout, d_bs, d_ts, lse, D, dq, B, SQ, SK, q_off, NQ, NKV, HD, scale);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(HD == 64 ? launch_dq_hd<64>(a, st) : launch_dq_hd<128>(a, st));
}

int launch_dkdv(const void* q, long long q_bs, long long q_ts, const void* k, long long k_bs,
                long long k_ts, const void* v, long long v_bs, long long v_ts, const void* dout,
                long long d_bs, long long d_ts, const void* lse, const void* D, void* dk,
                void* dv, int B, int SQ, int SK, int q_off, int NQ, int NKV, int HD,
                float scale, void* stream) {
  BwdArgs a{};
  cudaError_t e = make_args(&a, false, q, q_bs, q_ts, k, k_bs, k_ts, v, v_bs, v_ts, nullptr, 0,
                            0, dout, d_bs, d_ts, lse, D, nullptr, B, SQ, SK, q_off, NQ, NKV, HD,
                            scale);
  if (e != cudaSuccess) return (int)e;
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(HD == 64 ? launch_dkdv_hd<64>(a, st) : launch_dkdv_hd<128>(a, st));
}

}  // namespace

// q, o, dout (B, S, NQ, HD), k / v (B, S, NKV, HD): each with its batch and
// token strides (elements, multiples of 8), heads contiguous inside a token,
// 16-byte aligned; lse and D (B, NQ, S) f32 (lse from flash_attention_fwd; D
// written here); dq (B, S, NQ, HD) contiguous. Requires HD in {64, 128},
// NQ % NKV == 0. Launch before flash_attention_bwd_dkdv (which reads D).
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
  return launch_dkdv(q, q_bs, q_ts, k, k_bs, k_ts, v, v_bs, v_ts, dout, d_bs, d_ts, lse, D, dk,
                     dv, B, S, S, 0, NQ, NKV, HD, scale, stream);
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
  return launch_dkdv(q, q_bs, q_ts, k, k_bs, k_ts, v, v_bs, v_ts, dout, d_bs, d_ts, lse, D, dk,
                     dv, B, SQ, SK, q_off, NQ, NKV, HD, scale, stream);
}
