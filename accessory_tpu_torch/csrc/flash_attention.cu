// Causal self-attention forward (prefill at position 0, the training
// forward, and one context-parallel shard) with native GQA.
//
// Replaces: accessory_tpu/ops/flash_attention.py::flash_attention_tpu, which
// calls JAX's bundled TPU splash kernel (`_splash_kernel`), and
// accessory_tpu/parallel/context.py::_splash_cp_kernel (:46), the same
// splash kernel with q_seq_shards, reached through cp_attention (:77).
//
// What it computes: query head hq reads kv head hq / (NQ / NKV); query row i
// (global position q0 + i) sees keys 0 .. q0 + i of SK. The softmax is the
// online (flash) form in f32: per key tile the row max m, the correction
// exp(m_old - m) of the running sum l and of the output, P = exp(s - m)
// rounded to bf16 for the P V product, and an optional lse (B, NQ, SQ) f32
// of m + log(l) taken before that rounding (csrc/flash_attention_bwd.cu
// recomputes P from it). In log2 units: the max is taken on the raw scores
// and scaled by scale * log2(e), each P is ex2 of one fused multiply-add
// (s * scale * log2(e) - m), and lse = (m + log2(l)) * ln(2): the same
// function to f32 rounding. flash_attention_fwd is the case q0 = 0, SK = SQ
// of the one body, so both entries give the same bits there; a row's
// arithmetic does not depend on which block computes it or on the tiles past
// its diagonal (fully masked tiles leave m, l and the output exactly as they
// were), so a shard's rows are the unsharded kernel's bits too.
//
// Bound on the H100: the work is about 2 * S^2 * HD flops per query head
// against 2 * S * HD * (2 + 2 * NKV / NQ) bytes, so S * NQ / (2 * NQ + 2 *
// NKV) flops per byte. With 32/4 heads that passes the card's ~295 bf16 flops
// per byte near S = 660: the 128-token prefill bucket is bound by bytes,
// training and context-parallel rows (512-8192) by the tensor cores.
//
// Design (FlashAttention-3-like): a work item is 128 query rows, two
// consumer warpgroups of 64, beside a producer warpgroup (registers moved to
// the consumers by setmaxnreg). The producer loads an item's Q once and then
// a ring of STAGES key tiles (BKV keys of K and of V, each on its own
// mbarrier, so Q K^T starts while V lands) by TMA: boxes of 64 head-dim
// columns (128 bytes) in the 128-byte swizzle, keys past SK as zeros; the
// consumers hand a stage back on its `empty` mbarrier. A warpgroup computes
// S = Q K^T as wgmma m64n128k16 with both operands in shared memory, the
// softmax in registers (the accumulator layout is the P V product's A
// fragment layout), then O += P V as wgmma with P as the register operand and
// V (keys x head dim, as it lies in memory) as an MN-major shared-memory
// operand. Only the tiles that reach past a warpgroup's first row or past SK
// are masked, and no tile past the item's last row is loaded. The output
// goes back through the warpgroup's Q rows in shared memory and one TMA store
// a 64-column half. Items (a query tile of a head group of a batch row) run
// longest first; a block walks items `ctas` apart with two Q buffers, so the
// next item's Q and first key tiles load while this one computes and stores.
// The wrapper's plan (ops/flash_attention.py fwd_plan) makes that grid
// persistent (one block an SM) where every item is short, and gives long
// items a block each, which the hardware balances over the causal triangle's
// unequal rows better than a round-robin. For short sequences the plan packs
// `ph` query heads of one GQA group into an item (a row is (position,
// head): the Q box takes ph heads of BQ / ph positions), so a short
// prefill's K / V are read by fewer blocks.
//
// What the card taught (throwaway variants timed on an NVIDIA H100 80GB
// HBM3, not kept): the softmax's instructions set the pace, so the mask is
// one compare a value and only on the tiles that need it, the max is taken on
// the raw scores, each P is one ex2 of a fused multiply-add, and O's
// correction is skipped where no row's max moved; computing tile j's scores
// while tile j - 1's P V runs (FlashAttention-3's intra-warpgroup overlap) ran
// slower here. This design takes 261.5 us at train_cp's shape (53% of the
// bf16 peak) and 5.9 / 14.1 us at the two prefills (SDPA 6.0 / 14.3) on an
// NVIDIA H100 80GB HBM3, 700.00 W (PERF.md rows 3 and 26, chip_smoke.py).
//
// The design it replaces (4 warps of mma.sync over 64-row tiles, K / V staged
// with plain loads between two barriers, no double buffering) ran at 7-10% of
// the bf16 peak at long rows: 1852.7 us at train_cp's shape (b 1, S 4096, 32
// heads, head_dim 128) on an NVIDIA H100 80GB HBM3, 700.00 W, and 11.1 / 35.6
// us at the tiny B4 S128 / 7B B8 S128 prefills (PERF.md rows 3 and 26,
// measured by chip_smoke.py).

#include "hopper.cuh"

namespace {

constexpr int BQ = 128;                  // query rows an item: two consumer warpgroups of 64
constexpr int BKV = 128;                 // keys a stage
constexpr int STAGES = 2;
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 32 * CONSUMER_WARPS + 128;  // + the producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;   // setmaxnreg: 64,512 of 65,536
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
struct Fwd {
  static constexpr int HALVES = HD / 64;            // 64-column TMA boxes a row
  static constexpr int Q_HALF = BQ * 128;
  static constexpr int KV_HALF = BKV * 128;
  static constexpr int Q_BYTES = HALVES * Q_HALF;
  static constexpr int KV_BYTES = HALVES * KV_HALF;  // a K or V tile
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int SMEM = 2 * Q_BYTES + STAGES * STAGE + 1024;   // + the alignment
};

struct FwdArgs {
  // 4-d maps (head dim, heads, then tokens and batch in the order of their
  // strides); tok_inner: the token dimension comes before the batch's
  CUtensorMap qmap, kmap, vmap;
  CUtensorMap omap; // out, (HD, NQ, SQ, B), box (64, ph, 64 / ph): a warpgroup's rows
  float* lse;       // (B, NQ, SQ) or null
  int SQ, SK, q0, NQ, R, B;
  int ph, rpb;      // query heads an item (one GQA group's), positions an item (BQ / ph)
  int nqt, groups;  // query tiles of rpb positions; NQ / ph
  int items;        // work items: nqt x groups x B
  int q_tok_inner, k_tok_inner, v_tok_inner;
  float scale_log2; // scale * log2(e)
};

// One work item: a query tile of one head group of one batch row, and the
// key tiles it walks (up to its last row's diagonal). Items run longest first.
struct Item {
  int b, hq0, hk, p0, n_tiles;
  __device__ Item(const FwdArgs& a, int w) {
    const int per = a.groups * a.B;
    const int qt = a.nqt - 1 - w / per, hg = (w % per) % a.groups;
    b = (w % per) / a.groups;
    hq0 = hg * a.ph;
    hk = hq0 / a.R;
    p0 = qt * a.rpb;
    n_tiles = min(a.q0 + min(a.SQ, p0 + a.rpb) - 1, a.SK - 1) / BKV + 1;
  }
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_wgmma_kernel(const __grid_constant__ FwdArgs a) {
  using F = Fwd<HD>;
  constexpr int NS = BKV / 2, NO = HD / 2;   // accumulators a thread: S, O
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t qfull[2], qempty[2], kfull[STAGES], vfull[STAGES],
      empty[STAGES];
  unsigned char* smem = hopper::align1024(smem_raw);   // Q buffers 0 and 1, then the ring
  unsigned char* ring = smem + 2 * F::Q_BYTES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&qfull[i], 1);
      hopper::mbar_init(&qempty[i], 2);   // one arrival a consumer warpgroup
    }
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
      hopper::prefetch_map(&a.qmap);
      hopper::prefetch_map(&a.kmap);
      hopper::prefetch_map(&a.vmap);
      int it = 0, n = 0;   // key tiles and items loaded so far
      for (int w = blockIdx.x; w < a.items; w += gridDim.x, ++n) {
        const Item im(a, w);
        const int qb = n & 1;
        if (n >= 2) hopper::mbar_wait(&qempty[qb], ((n >> 1) - 1) & 1);
        hopper::mbar_expect_tx(&qfull[qb], F::Q_BYTES);
#pragma unroll
        for (int h = 0; h < F::HALVES; ++h)
          hopper::load4(smem + qb * F::Q_BYTES + h * F::Q_HALF, &a.qmap, a.q_tok_inner, 64 * h,
                        im.hq0, im.p0, im.b, &qfull[qb]);
        for (int j = 0; j < im.n_tiles; ++j, ++it) {
          const int slot = it % STAGES;
          if (it >= STAGES) hopper::mbar_wait(&empty[slot], (it / STAGES - 1) & 1);
          unsigned char* ks = ring + slot * F::STAGE;
          hopper::mbar_expect_tx(&kfull[slot], F::KV_BYTES);
#pragma unroll
          for (int h = 0; h < F::HALVES; ++h)
            hopper::load4(ks + h * F::KV_HALF, &a.kmap, a.k_tok_inner, 64 * h, im.hk, j * BKV,
                          im.b, &kfull[slot]);
          hopper::mbar_expect_tx(&vfull[slot], F::KV_BYTES);
#pragma unroll
          for (int h = 0; h < F::HALVES; ++h)
            hopper::load4(ks + F::KV_BYTES + h * F::KV_HALF, &a.vmap, a.v_tok_inner, 64 * h,
                          im.hk, j * BKV, im.b, &vfull[slot]);
        }
      }
    }
    return;
  }

  hopper::regs_inc<CONSUMER_REGS>();
  // consumers: thread (g, t) of warp q of warpgroup wg holds block rows ra
  // and rb = ra + 8; an item's row is (position r / ph, head r % ph)
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int ra = 64 * wg + 16 * (warp & 3) + g, rb = ra + 8;
  int it = 0, n = 0;
  for (int w = blockIdx.x; w < a.items; w += gridDim.x, ++n) {
    const Item im(a, w);
    const int qb = n & 1;
    unsigned char* qs = smem + qb * F::Q_BYTES;
    const int la = im.p0 + ra / a.ph, lb = im.p0 + rb / a.ph;     // local positions
    const int pos_a = a.q0 + la, pos_b = a.q0 + lb;                 // global positions
    const int wg_first = a.q0 + im.p0 + (64 * wg) / a.ph;           // the warpgroup's first
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    // the running max of the raw scores and its scaled form (log2 units),
    // the running sums; rows a (ra) and b (rb)
    float m_a = NEG_INF_F, m_b = NEG_INF_F, ms_a = NEG_INF_F, ms_b = NEG_INF_F;
    float l_a = 0.f, l_b = 0.f;
    const uint32_t qaddr = hopper::smem_addr(qs) + wg * 64 * 128;
    uint64_t dq[HD / 16];   // the warpgroup's Q rows, k16 step kk
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      dq[kk] = hopper::desc_b128(qaddr + (kk >> 2) * F::Q_HALF + (kk & 3) * 32, 16, 1024);
    hopper::mbar_wait(&qfull[qb], (n >> 1) & 1);

    for (int j = 0; j < im.n_tiles; ++j, ++it) {
      const int slot = it % STAGES, par = (it / STAGES) & 1, kv0 = j * BKV;
      const uint32_t kaddr = hopper::smem_addr(ring + slot * F::STAGE);
      const uint32_t vaddr = kaddr + F::KV_BYTES;
      float s[NS];
      uint64_t dk[HD / 16];   // k16 steps: 64-column half kk / 4, 32 bytes each
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        dk[kk] = hopper::desc_b128(kaddr + (kk >> 2) * F::KV_HALF + (kk & 3) * 32, 16, 1024);
        hopper::pin(dk[kk]);
        hopper::pin(dq[kk]);
      }
      int zero = 0, one = 1;   // the accumulate flags, pinned with the descriptors
      hopper::pin(zero);
      hopper::pin(one);
      hopper::mbar_wait(&kfull[slot], par);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hopper::wgmma_ss_64x128x16(s, dq[kk], dk[kk], kk > 0 ? one : zero);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(s);

      // the causal mask and SK, only where the tile reaches past the
      // warpgroup's first row or past SK: column c = 8i + 2t + (e & 1) of the
      // tile is seen by a row iff c <= its limit
      if (kv0 + BKV - 1 > wg_first || kv0 + BKV > a.SK) {
        const int lim_a = min(pos_a, a.SK - 1) - kv0 - 2 * t;
        const int lim_b = min(pos_b, a.SK - 1) - kv0 - 2 * t;
#pragma unroll
        for (int i = 0; i < NS / 4; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * i + (e & 1) > (e < 2 ? lim_a : lim_b)) s[4 * i + e] = NEG_INF_F;
        }
      }
      // row max over the quad (raw scores), then its scaled form
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int i = 0; i < NS / 4; ++i) {
        mx_a = fmaxf(mx_a, fmaxf(s[4 * i], s[4 * i + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float ns_a = mx_a * a.scale_log2, ns_b = mx_b * a.scale_log2;
      const float c_a = hopper::ex2(ms_a - ns_a), c_b = hopper::ex2(ms_b - ns_b);
      m_a = mx_a;
      m_b = mx_b;
      ms_a = ns_a;
      ms_b = ns_b;
      // O scaled by the correction (skipped where no row's max moved: c = 1)
      if (__any_sync(0xffffffffu, c_a != 1.f || c_b != 1.f)) {
#pragma unroll
        for (int i = 0; i < NO / 4; ++i) {
          o[4 * i] *= c_a;
          o[4 * i + 1] *= c_a;
          o[4 * i + 2] *= c_b;
          o[4 * i + 3] *= c_b;
        }
      }
      // P = 2^(s * scale - m) in f32 (summed into l), rounded to bf16 as the A
      // fragments of the P V product: k16 chunk c holds columns 16c .. 16c + 15
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int i = 0; i < NS / 4; ++i) {
        s[4 * i] = hopper::ex2(fmaf(s[4 * i], a.scale_log2, -ns_a));
        s[4 * i + 1] = hopper::ex2(fmaf(s[4 * i + 1], a.scale_log2, -ns_a));
        s[4 * i + 2] = hopper::ex2(fmaf(s[4 * i + 2], a.scale_log2, -ns_b));
        s[4 * i + 3] = hopper::ex2(fmaf(s[4 * i + 3], a.scale_log2, -ns_b));
        sum_a += s[4 * i] + s[4 * i + 1];
        sum_b += s[4 * i + 2] + s[4 * i + 3];
      }
      l_a = l_a * c_a + sum_a;
      l_b = l_b * c_b + sum_b;
      uint32_t p[BKV / 16][4];
#pragma unroll
      for (int c = 0; c < BKV / 16; ++c) {
        p[c][0] = pack_bf16x2(s[8 * c], s[8 * c + 1]);
        p[c][1] = pack_bf16x2(s[8 * c + 2], s[8 * c + 3]);
        p[c][2] = pack_bf16x2(s[8 * c + 4], s[8 * c + 5]);
        p[c][3] = pack_bf16x2(s[8 * c + 6], s[8 * c + 7]);
      }
      uint64_t dv[BKV / 16];   // 16 keys: two 8-row groups of the V tile
#pragma unroll
      for (int c = 0; c < BKV / 16; ++c) {
        dv[c] = hopper::desc_b128(vaddr + c * 2048, F::KV_HALF, 1024);
        hopper::pin(dv[c]);
        hopper::pin(p[c]);
      }
      hopper::pin(one);
      hopper::reg_fence(o);
      hopper::mbar_wait(&vfull[slot], par);
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < BKV / 16; ++c) {
        if constexpr (HD == 128)
          hopper::wgmma_rs_64x128x16<1>(o, p[c], dv[c], one);
        else
          hopper::wgmma_rs_64x64x16<1>(o, p[c], dv[c], one);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < BKV / 16; ++c) hopper::reg_keep(p[c]);
      hopper::reg_fence(o);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[slot]);
    }

    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
    if (a.lse != nullptr && t == 0) {
      const int ha = im.hq0 + ra % a.ph, hb = im.hq0 + rb % a.ph;
      if (la < a.SQ) a.lse[((size_t)im.b * a.NQ + ha) * a.SQ + la] = (ms_a + log2f(l_a)) * LN2;
      if (lb < a.SQ) a.lse[((size_t)im.b * a.NQ + hb) * a.SQ + lb] = (ms_b + log2f(l_b)) * LN2;
    }
    // the output: the warpgroup's rows into its (now idle) Q rows in the TMA
    // box's swizzled layout (16-byte chunk c of row r at chunk c ^ (r % 8)),
    // then one TMA store a 64-column half (positions past SQ are not written)
#pragma unroll
    for (int i = 0; i < NO / 4; ++i) {
      unsigned char* half = qs + (i / 8) * F::Q_HALF + 4 * t;
      const int c = i % 8;
      *reinterpret_cast<uint32_t*>(half + ra * 128 + ((c ^ (ra & 7)) << 4)) =
          pack_bf16x2(o[4 * i] * inv_a, o[4 * i + 1] * inv_a);
      *reinterpret_cast<uint32_t*>(half + rb * 128 + ((c ^ (rb & 7)) << 4)) =
          pack_bf16x2(o[4 * i + 2] * inv_b, o[4 * i + 3] * inv_b);
    }
    hopper::fence_async_shared();
    hopper::named_sync(1 + wg, 128);
    if ((tid & 127) == 0) {
#pragma unroll
      for (int h = 0; h < F::HALVES; ++h)
        hopper::tma_store_4d(&a.omap, qs + h * F::Q_HALF + wg * 64 * 128, 64 * h, im.hq0,
                             im.p0 + (64 * wg) / a.ph, im.b);
      hopper::tma_store_wait();
      hopper::mbar_arrive(&qempty[qb]);   // the buffer is free for the item after next
    }
  }
}

template <int HD>
cudaError_t launch_hd(const FwdArgs& a, int ctas, cudaStream_t st) {
  using F = Fwd<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
  if (attr != cudaSuccess) return attr;
  flash_fwd_wgmma_kernel<HD><<<ctas < a.items ? ctas : a.items, THREADS, F::SMEM, st>>>(a);
  return cudaGetLastError();
}

int launch_fwd(const void* q, long long q_bs, long long q_ts, const void* k, long long k_bs,
               long long k_ts, const void* v, long long v_bs, long long v_ts, void* out, int B,
               int SQ, int SK, int q0, int NQ, int NKV, int HD, float scale, void* lse, int ph,
               int ctas, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B < 1 || SQ < 1 || q0 < 0 || q0 + SQ > SK || NKV < 1 || NQ % NKV != 0 ||
      (HD != 64 && HD != 128) || ph < 1 || 64 % ph != 0 || (NQ / NKV) % ph != 0 || ctas < 1)
    return (int)cudaErrorInvalidValue;
  FwdArgs a{};
  a.lse = static_cast<float*>(lse);
  a.SQ = SQ;
  a.SK = SK;
  a.q0 = q0;
  a.NQ = NQ;
  a.R = NQ / NKV;
  a.B = B;
  a.ph = ph;
  a.rpb = BQ / ph;
  a.nqt = (SQ + a.rpb - 1) / a.rpb;
  a.groups = NQ / ph;
  a.items = a.nqt * a.groups * B;
  a.scale_log2 = scale * 1.4426950408889634f;
  cudaError_t e;
  int out_tok_inner;
  using hopper::qkv_map;
  if ((e = hopper::bind_device_of(q)) != cudaSuccess ||
      (e = qkv_map(&a.qmap, &a.q_tok_inner, q, q_bs, q_ts, B, SQ, NQ, HD, ph, a.rpb)) != cudaSuccess ||
      (e = qkv_map(&a.omap, &out_tok_inner, out, (long long)SQ * NQ * HD, (long long)NQ * HD, B, SQ,
                   NQ, HD, ph, 64 / ph)) != cudaSuccess ||
      (e = qkv_map(&a.kmap, &a.k_tok_inner, k, k_bs, k_ts, B, SK, NKV, HD, 1, BKV)) != cudaSuccess ||
      (e = qkv_map(&a.vmap, &a.v_tok_inner, v, v_bs, v_ts, B, SK, NKV, HD, 1, BKV)) != cudaSuccess)
    return (int)e;
  return (int)(HD == 64 ? launch_hd<64>(a, ctas, st) : launch_hd<128>(a, ctas, st));
}

}  // namespace

// q (B, S, NQ, HD), k/v (B, S, NKV, HD), each with the given batch and token
// strides (elements, multiples of 8) and heads contiguous inside a token,
// 16-byte aligned; out (B, S, NQ, HD) contiguous; lse (B, NQ, S) f32 or null
// (serving passes null); ph: query heads an item, ctas: the blocks
// (the wrapper's plan, ops/flash_attention.py fwd_plan; ph divides NQ / NKV
// and 64). Requires HD in {64, 128}, NQ % NKV == 0.
extern "C" int flash_attention_fwd(const void* q, long long q_bs, long long q_ts,
                                   const void* k, long long k_bs, long long k_ts,
                                   const void* v, long long v_bs, long long v_ts, void* out,
                                   int B, int S, int NQ, int NKV, int HD, float scale,
                                   void* lse, int ph, int ctas, void* stream) {
  return launch_fwd(q, q_bs, q_ts, k, k_bs, k_ts, v, v_bs, v_ts, out, B, S, S, 0, NQ, NKV, HD,
                    scale, lse, ph, ctas, stream);
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
                                      float scale, void* lse, int ph, int ctas,
                                      void* stream) {
  return launch_fwd(q, q_bs, q_ts, k, k_bs, k_ts, v, v_bs, v_ts, out, B, SQ, SK, q0, NQ, NKV,
                    HD, scale, lse, ph, ctas, stream);
}
