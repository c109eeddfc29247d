// Flash-decoding over a KV cache: the one body of the GQA decode attention
// over the static cache (csrc/decode_attention.cu) and of the paged decode
// attention (csrc/paged_decode.cu).
//
// A block owns one (kv head, batch row, tile of query rows) and one rank of a
// cluster of `split` blocks (at most 8, the portable most). A (batch row, kv
// head) has ntiles tiles of up to 16 * MT query rows (the host's plan: 64 at
// head_dim 64, 32 at 128), each its own cluster over the same tokens, so any
// number of query rows is served: Falcon-7B's 71 query heads over one kv head
// take a tile of 64 rows and one of 7. The cached tokens [0, n) are cut into
// chunks of 64, and rank r folds the chunks [nc * r / split, nc * (r + 1) /
// split) of the nc = ceil(n / 64) chunks: n is the static cache's pos, or the
// paged slot's length read on the card, so a rank finds its own range from
// the real length while the launch's shape (split, from S or J * PS:
// ops/decode_attention.py::decode_plan, ops/paged_decode.py::paged_plan) does
// not depend on it. A rank whose range is empty contributes m = -1e30, l = 0.
//
// Inside a rank: 128 threads, 4 warps. K and V chunks stream through a
// 3-stage ring of 16-byte cp.async copies, so two chunks' loads are in flight
// while one is scored; a token at or past n is zero-filled (never read), which
// keeps index pos (the static kernel's write) out of every read. The static
// kernel issues its first chunks at once, its query rows and new k / v in the
// same group; the paged one first reads the slot's length and page ids (one
// round, into shared memory). bf16 rows land XOR-swizzled (16-byte chunk c of
// row r at c ^ (r & 7)), so the ldmatrix reads are free of bank conflicts;
// int8 rows land as they are, with their f32 scales, and are widened to bf16
// (exact) into one swizzled tile.
//
// The products run on the tensor cores (mma.sync m16n8k16, bf16 -> f32). The
// query rows (R * SQ of them, padded to MT m16 tiles, MT = 1, 2 or 4) are
// split over the warps by tile, and each tile's 4 / MT warps split a chunk's
// tokens: a warp scores its tokens against its tile (S = Q K^T, Q's
// fragments held in registers), the scores are scaled (int8: by the token's k
// scale times the softmax scale, after the dot) and masked, the rows' maxima
// are exchanged between the tile's warps through shared memory, so they share
// the rank's running max, and P (rounded to bf16 against that max; int8: p
// times the token's v scale, then rounded) multiplies the warp's tokens of V
// (ldmatrix.trans) into the warp's f32 accumulators. After the last chunk a
// tile's warps add their sums in warp order and every rank writes each real
// row's sums, m and l into the mailbox of the row's owner, rank r % split,
// through distributed shared memory; after a cluster barrier the owner merges
// the ranks in rank order, each rescaled by exp(m_rank - m) in f32, adds the
// new tokens' exact f32 term (row t sees new tokens t' <= t; none for the
// read-only paged form), divides and stores. The mailbox has shared memory of
// its own where a block still fits three to an SM, else it reuses the ring's
// after a first cluster barrier. The same inputs give the same bits on every
// launch: no atomics, every sum in a fixed order.
//
// Bound on the H100: bytes (each cached token's k and v read once, q, the new
// k / v and the output once). The split puts about one or two blocks on each
// of the 132 SMs where one block per (kv head, batch row) left most of them
// idle (32 blocks at B 8, NKV 4). What remains, measured with %globaltimer
// stamps in a throwaway build: a block's fixed chain (the first loads, a
// chunk's products, the cluster barrier, the merge) of 4-5 us, and at long
// ragged slots a single rank's stream of chunks.

#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace dsplit {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int T = 64;           // cached tokens a chunk
constexpr int MAX_SPLIT = 8;    // blocks of a cluster
constexpr int NEW_PAGED = 16;   // a paged slot's new tokens whose k / v sit in shared memory
constexpr int PT_CACHE = 256;   // a slot's page ids held in shared memory (J <= 256)
constexpr float KV_SCALE_EPS = 1e-6f;

// Everything a launch reads, for both caches. Static: kc / vc (B, NKV, S, HD)
// and the scales (B, NKV, S), n = pos, or *pos_dev where that is set (a
// position on the card, which a captured decode step reads at each replay),
// SQ = 1; with the fused write kw / vw / ksw / vsw are the same pools. Paged: pools (NKV, P, PS, HD), scales (NKV,
// P, PS), n = min(lengths[b], J * PS), token tok of slot b in page
// pt[b * PPS + tok / PS]. Both: ntiles tiles of query rows a (row or slot, kv
// head), blockIdx.z = b * ntiles + tile. Query row m is new token m / R,
// group member m % R.
struct Params {
  const bf16* q;
  long long q_bs, q_ts;
  const bf16* kn;
  long long kn_bs, kn_ts;
  const bf16* vn;
  long long vn_bs, vn_ts;
  const void* kc;
  const void* vc;
  const float* ks;
  const float* vs;
  void* kw;
  void* vw;
  float* ksw;
  float* vsw;
  int S, pos;
  const int* pos_dev;   // static: pos on the card (read at block start), or null for pos
  const int* lengths;
  const int* pt;
  int PPS, J, P, PS;
  int NKV, R, SQ, ntiles;
  float scale;
  bf16* out;
};

// 16-byte unit of chunk c of row r in a swizzled tile of HD bf16 a row
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  return r * (HD / 8) + (c ^ (r & 7));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

constexpr int NST = 3;          // ring stages: two chunks in flight besides the one scored
constexpr int al16(int x) { return (x + 15) & ~15; }

// Byte offsets of one block's shared memory: the query rows (swizzled), the
// new tokens' k and v, the max / l exchange of the warps, each row's running
// max, the slot's page ids (paged), then the ring (int8: its scales and the
// widened tile), whose bytes hold the warps' f32 sums after the last chunk.
// The mailbox the ranks write their rows' sums, m and l into has bytes of its
// own where the block still fits three to an SM (DEDICATED: the ranks write
// as soon as they are done); else it takes the ring's bytes after the sums,
// and the ranks first wait until every rank is past its last chunk.
template <int HD, int MT, typename CT, bool PAGED>
struct Smem {
  static constexpr bool INT8 = sizeof(CT) == 1;
  static constexpr int ROWS = 16 * MT;
  static constexpr int NEWMAX = PAGED ? NEW_PAGED : 1;
  static constexpr int MBOX = ROWS + MAX_SPLIT - 1;   // split * ceil(rows / split) at most
  static constexpr int MBOX_BYTES = MBOX * HD * 4 + 2 * MBOX * 4;
  static constexpr int LTILE = T * HD * (int)sizeof(CT);
  static constexpr int knew = ROWS * HD * 2;
  static constexpr int vnew = knew + NEWMAX * HD * 2;
  static constexpr int red = vnew + NEWMAX * HD * 2;
  static constexpr int mrow = red + NWARPS * 16 * 4;
  static constexpr int ptc = al16(mrow + ROWS * 4);
  static constexpr int ring = ptc + (PAGED ? PT_CACHE * 4 : 0);
  static constexpr int scl = ring + NST * 2 * LTILE;
  static constexpr int wide = scl + (INT8 ? NST * 2 * T * 4 : 0);
  static constexpr int ring_end = wide + (INT8 ? 2 * T * HD * 2 : 0);
  static constexpr int part_end = ring + NWARPS * 16 * HD * 4;
  static constexpr int body_end = ring_end > part_end ? ring_end : part_end;
  static constexpr bool DEDICATED = al16(body_end) + MBOX_BYTES <= 75 * 1024;
  static constexpr int mb = DEDICATED ? al16(body_end) : part_end;
  static constexpr int mbm = mb + MBOX * HD * 4;
  static constexpr int mbl = mbm + MBOX * 4;
  static constexpr int bytes = DEDICATED || mbl + MBOX * 4 > body_end ? mbl + MBOX * 4 : body_end;
};

template <int HD, int MT, typename CT, bool PAGED>
constexpr int smem_bytes() {
  return Smem<HD, MT, CT, PAGED>::bytes;
}

// The tiles of `rows` query rows a (row or slot, kv head), both entries'
// (ops/decode_attention.py::TILE_ROWS, row_tiles): up to 64 rows a tile at
// head_dim 64, 32 at 128, and the m16 tiles (1, 2 or 4) of the kernel that
// takes them.
struct RowTiles {
  int ntiles, mt;
};

inline RowTiles row_tiles(int rows, int HD) {
  const int maxm = HD == 64 ? 64 : 32;
  const int tile = min(rows, maxm);
  return {(rows + maxm - 1) / maxm, tile <= 16 ? 1 : tile <= 32 ? 2 : 4};
}

template <int HD, int MT, typename CT, bool PAGED, bool WRITE, bool NEW>
__device__ __forceinline__ void body(const Params& p, int split, unsigned char* smem) {
  using L = Smem<HD, MT, CT, PAGED>;
  constexpr bool INT8 = L::INT8;
  constexpr int ROWS = L::ROWS, NEWMAX = L::NEWMAX, LTILE = L::LTILE;
  constexpr int TG = NWARPS / MT;                  // warps sharing an m16 tile of rows
  constexpr int TW = T / TG;                       // tokens of a chunk a warp scores
  constexpr int PPT = HD * (int)sizeof(CT) / 16;   // 16-byte pieces of a cached row
  constexpr int WTILE = T * HD * 2;                // bytes of a bf16 K or V chunk
  constexpr int N8 = HD / 8;                       // n8 tiles of P V
  constexpr int DPL = HD / 32;                     // output dims a lane
  // a dedicated mailbox is written as soon as a rank is done: every block of
  // the cluster has then started (the matching wait comes before the writes)
  if constexpr (L::DEDICATED)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp / TG, tg = warp % TG;        // the warp's m16 tile and token slice
  const int h = blockIdx.y;
  const int b = blockIdx.z / p.ntiles, tile = blockIdx.z % p.ntiles;
  const int row0 = tile * ROWS;
  const int nrows = min(ROWS, p.SQ * p.R - row0);

  unsigned char* qbytes = smem;
  bf16* knew = reinterpret_cast<bf16*>(smem + L::knew);
  bf16* vnew = reinterpret_cast<bf16*>(smem + L::vnew);
  float* red = reinterpret_cast<float*>(smem + L::red);
  float* mrow = reinterpret_cast<float*>(smem + L::mrow);
  float* mb = reinterpret_cast<float*>(smem + L::mb);
  float* mbm = reinterpret_cast<float*>(smem + L::mbm);
  float* mbl = reinterpret_cast<float*>(smem + L::mbl);
  int* ptc = reinterpret_cast<int*>(smem + L::ptc);
  unsigned char* ring = smem + L::ring;
  float* scl = reinterpret_cast<float*>(smem + L::scl);
  unsigned char* wide = smem + L::wide;
  float* part = reinterpret_cast<float*>(ring);

  // the query rows (zeros past nrows) and the new tokens' k / v, by cp.async
  // where their rows are 16-byte aligned
  auto load_rows = [&]() {
    if (((reinterpret_cast<uintptr_t>(p.q) | (uintptr_t)(p.q_bs * 2) |
          (uintptr_t)(p.q_ts * 2)) & 15) == 0) {
      for (int i = tid; i < ROWS * (HD / 8); i += THREADS) {
        const int r = i / (HD / 8), c = i % (HD / 8), m = row0 + min(r, nrows - 1);
        cp_async<16>(qbytes + swz<HD>(r, c) * 16,
                     p.q + b * p.q_bs + (m / p.R) * p.q_ts +
                         (long long)(h * p.R + m % p.R) * HD + c * 8,
                     r < nrows ? 16 : 0);
      }
    } else {
      for (int i = tid; i < ROWS * HD; i += THREADS) {
        const int r = i / HD, d = i % HD, m = row0 + min(r, nrows - 1);
        const bf16 v =
            p.q[b * p.q_bs + (m / p.R) * p.q_ts + (long long)(h * p.R + m % p.R) * HD + d];
        *reinterpret_cast<bf16*>(qbytes + swz<HD>(r, d >> 3) * 16 + (d & 7) * 2) =
            r < nrows ? v : f2bf(0.f);
      }
    }
    if constexpr (NEW) {
      const int nn = min(p.SQ, NEWMAX);
      if (((reinterpret_cast<uintptr_t>(p.kn) | reinterpret_cast<uintptr_t>(p.vn) |
            (uintptr_t)(p.kn_bs * 2) | (uintptr_t)(p.kn_ts * 2) | (uintptr_t)(p.vn_bs * 2) |
            (uintptr_t)(p.vn_ts * 2)) & 15) == 0) {
        for (int i = tid; i < nn * (HD / 8); i += THREADS) {
          const long long t = i / (HD / 8), off = (long long)h * HD + (i % (HD / 8)) * 8;
          cp_async<16>(knew + i * 8, p.kn + b * p.kn_bs + t * p.kn_ts + off, 16);
          cp_async<16>(vnew + i * 8, p.vn + b * p.vn_bs + t * p.vn_ts + off, 16);
        }
      } else {
        for (int i = tid; i < nn * HD; i += THREADS) {
          const long long t = i / HD, off = (long long)h * HD + i % HD;
          knew[i] = p.kn[b * p.kn_bs + t * p.kn_ts + off];
          vnew[i] = p.vn[b * p.vn_bs + t * p.vn_ts + off];
        }
      }
    }
  };

  int n = 0;
  bool pt_cached = false;
  if constexpr (PAGED) {
    // the length and the slot's page ids in one round, the rows beside them
    const int len = p.lengths[b];
    pt_cached = p.J <= PT_CACHE;
    if (pt_cached)
      for (int i = tid; i < p.J; i += THREADS) ptc[i] = __ldg(p.pt + (long long)b * p.PPS + i);
    load_rows();
    cp_async_commit();
    n = max(0, min(len, p.J * p.PS));
    __syncthreads();
  } else {
    n = p.pos_dev != nullptr ? __ldg(p.pos_dev) : p.pos;
  }
  const int nc = (n + T - 1) / T;
  const int c0 = (int)((long long)nc * rank / split);
  const int nchunks = (int)((long long)nc * (rank + 1) / split) - c0;
  const long long base_row =
      PAGED ? (long long)h * p.P * p.PS : ((long long)b * p.NKV + h) * p.S;

  // pool row of cached token tok (its k / v at row * HD, its scales at row)
  auto token_row = [&](int tok) -> long long {
    if constexpr (PAGED) {
      const int page =
          pt_cached ? ptc[tok / p.PS] : __ldg(p.pt + (long long)b * p.PPS + tok / p.PS);
      if (page < 0 || page >= p.P) __trap();  // a page id the pools do not have
      return base_row + (long long)page * p.PS + tok % p.PS;
    } else {
      return base_row + tok;
    }
  };

  const CT* kc = static_cast<const CT*>(p.kc);
  const CT* vc = static_cast<const CT*>(p.vc);
  // chunk c's K and V (and scales) into stage s; tokens at or past n zeros
  auto issue = [&](int c, int s) {
    const int t0 = c * T, nt = min(T, n - t0);
    unsigned char* kd = ring + s * 2 * LTILE;
    unsigned char* vd = kd + LTILE;
#pragma unroll
    for (int k = 0; k < T * PPT / THREADS; ++k) {
      const int i = tid + k * THREADS, tok = i / PPT, pc = i % PPT;
      const bool ok = tok < nt;
      const long long off = ok ? token_row(t0 + tok) * HD + pc * (16 / (int)sizeof(CT)) : 0;
      const int dst = INT8 ? i * 16 : swz<HD>(tok, pc) * 16;
      cp_async<16>(kd + dst, kc + off, ok ? 16 : 0);
      cp_async<16>(vd + dst, vc + off, ok ? 16 : 0);
    }
    if constexpr (INT8) {
      const int tok = tid % T;
      const bool ok = tok < nt;
      const long long r = ok ? token_row(t0 + tok) : 0;
      cp_async<4>(scl + (s * 2 + tid / T) * T + tok, (tid < T ? p.ks : p.vs) + r, ok ? 4 : 0);
    }
  };

  // the first NST - 1 chunks (static: with the rows, in the first group)
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nchunks) issue(c0 + s, s);
    if (!PAGED && s == 0) load_rows();
    cp_async_commit();
  }

  float m_run[2] = {NEG_INF_F, NEG_INF_F}, l_run[2] = {0.f, 0.f}, acc[N8][4];
#pragma unroll
  for (int j = 0; j < N8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const uint32_t q_s = smem_u32(qbytes);
  const int tok0 = tg * TW;   // the warp's first token of a chunk
  uint32_t qf[HD / 16][4];    // the warp's m16 tile of rows as mma A fragments
  for (int i = 0; i < nchunks; ++i) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // chunk i landed for every thread; every warp is past chunk i - 1
    if (i + NST - 1 < nchunks) issue(c0 + i + NST - 1, (i + NST - 1) % NST);
    cp_async_commit();
    const int s = i % NST;
    const int nt = min(T, n - (c0 + i) * T);
    const unsigned char* landed = ring + s * 2 * LTILE;
    uint32_t k_s, v_s;
    if constexpr (INT8) {
      for (int j = tid; j < 2 * T * PPT; j += THREADS) {
        const int which = j / (T * PPT), i2 = j % (T * PPT), tok = i2 / PPT, pc = i2 % PPT;
        const uint4 raw = *reinterpret_cast<const uint4*>(landed + which * LTILE + i2 * 16);
        const int8_t* v8 = reinterpret_cast<const int8_t*>(&raw);
        uint32_t w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) w[e] = pack_bf16x2((float)v8[2 * e], (float)v8[2 * e + 1]);
        unsigned char* dst = wide + which * WTILE;
        *reinterpret_cast<uint4*>(dst + swz<HD>(tok, 2 * pc) * 16) =
            make_uint4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<uint4*>(dst + swz<HD>(tok, 2 * pc + 1) * 16) =
            make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
      k_s = smem_u32(wide);
      v_s = k_s + WTILE;
    } else {
      k_s = smem_u32(landed);
      v_s = k_s + LTILE;
    }
    const float* ksc = scl + s * 2 * T;
    const float* vsc = ksc + T;

    // S = Q K^T: the warp's m16 tile against its TW tokens
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldsm_x4(qf[kk], q_s + swz<HD>(16 * mt + (lane & 7) + (((lane >> 3) & 1) << 3),
                                      2 * kk + (lane >> 4)) * 16);
    }
    float sc[TW / 8][4];
#pragma unroll
    for (int j = 0; j < TW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int jt = 0; jt < TW / 16; ++jt) {
        uint32_t kf[4];
        ldsm_x4(kf, k_s + swz<HD>(tok0 + 16 * jt + (lane & 7) + ((lane >> 4) << 3),
                                  2 * kk + ((lane >> 3) & 1)) * 16);
        mma_bf16_16816(sc[2 * jt], qf[kk], kf[0], kf[1]);
        mma_bf16_16816(sc[2 * jt + 1], qf[kk], kf[2], kf[3]);
      }
    }
    // scaled (int8: by the k scale, after the dot) and masked; the rows'
    // maxima over the chunk, exchanged between the warps of a tile
    float cmax[2] = {NEG_INF_F, NEG_INF_F};
#pragma unroll
    for (int j = 0; j < TW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = tok0 + 8 * j + 2 * t4 + (e & 1);
        const float v = sc[j][e] * (INT8 ? ksc[tok] * p.scale : p.scale);
        sc[j][e] = tok < nt ? v : NEG_INF_F;
        cmax[e >> 1] = fmaxf(cmax[e >> 1], sc[j][e]);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      cmax[hh] = fmaxf(cmax[hh], __shfl_xor_sync(0xffffffffu, cmax[hh], 1));
      cmax[hh] = fmaxf(cmax[hh], __shfl_xor_sync(0xffffffffu, cmax[hh], 2));
    }
    if constexpr (TG > 1) {
      if (t4 == 0) {
        red[warp * 16 + g] = cmax[0];
        red[warp * 16 + g + 8] = cmax[1];
      }
      __syncthreads();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        cmax[hh] = red[mt * TG * 16 + g + 8 * hh];
#pragma unroll
        for (int w = 1; w < TG; ++w)
          cmax[hh] = fmaxf(cmax[hh], red[(mt * TG + w) * 16 + g + 8 * hh]);
      }
    }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m_run[hh], cmax[hh]);
      corr[hh] = expf(m_run[hh] - m_new);
      m_run[hh] = m_new;
      l_run[hh] *= corr[hh];
    }
#pragma unroll
    for (int j = 0; j < N8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
    // P, rounded to bf16 against the running max (int8: times the v scale first)
    uint32_t pa[TW / 16][4];
#pragma unroll
    for (int ks = 0; ks < TW / 16; ++ks) {
      float pv[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tok = tok0 + 16 * ks + 8 * j + 2 * t4 + (e & 1);
          const float pe = expf(sc[2 * ks + j][e] - m_run[e >> 1]);
          l_run[e >> 1] += pe;
          pv[j][e] = INT8 ? pe * vsc[tok] : pe;
        }
      pa[ks][0] = pack_bf16x2(pv[0][0], pv[0][1]);
      pa[ks][1] = pack_bf16x2(pv[0][2], pv[0][3]);
      pa[ks][2] = pack_bf16x2(pv[1][0], pv[1][1]);
      pa[ks][3] = pack_bf16x2(pv[1][2], pv[1][3]);
    }
    // O += P V over the warp's tokens
#pragma unroll
    for (int ks = 0; ks < TW / 16; ++ks)
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        uint32_t vf[4];
        ldsm_x4_t(vf, v_s + swz<HD>(tok0 + 16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3),
                                    2 * dn + (lane >> 4)) * 16);
        mma_bf16_16816(acc[2 * dn], pa[ks], vf[0], vf[1]);
        mma_bf16_16816(acc[2 * dn + 1], pa[ks], vf[2], vf[3]);
      }
  }
  cp_async_wait<0>();
  __syncthreads();  // the rows landed; every warp is done with the ring, which the sums take over

  // each warp's sums of its tile (one running max for the tile's warps), l
  // over the quad, m
  float* pw = part + warp * 16 * HD;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_run[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (t4 == 0) {
      red[warp * 16 + g + 8 * hh] = l;
      if (tg == 0) mrow[16 * mt + g + 8 * hh] = m_run[hh];
    }
  }
#pragma unroll
  for (int j = 0; j < N8; ++j) {
    const int col = 8 * j + 2 * t4;
    *reinterpret_cast<float2*>(pw + g * HD + col) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(pw + (g + 8) * HD + col) = make_float2(acc[j][2], acc[j][3]);
  }

  // the fused write of the new token at index pos, by rank 0 of the first
  // tile alone (no rank of any tile reads that index: the other tiles take
  // the new k / v from knew / vnew, so the tiles need no order)
  if constexpr (WRITE) {
    if (rank == 0 && tile == 0) {
      const long long woff = (base_row + n) * HD;   // n: the static cache's pos
      CT* kw = static_cast<CT*>(p.kw);
      CT* vw = static_cast<CT*>(p.vw);
      if constexpr (!INT8) {
        for (int d = tid; d < HD; d += THREADS) {
          kw[woff + d] = knew[d];
          vw[woff + d] = vnew[d];
        }
      } else if (warp < 2) {  // warp 0 quantizes k, warp 1 v
        const bf16* src = warp == 0 ? knew : vnew;
        int8_t* dst = (warp == 0 ? kw : vw) + woff;
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
        if (lane == 0) (warp == 0 ? p.ksw : p.vsw)[base_row + n] = sc;
      }
    }
  }
  __syncthreads();
  if constexpr (L::DEDICATED)
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  else
    cluster.sync();  // every rank is past its last chunk: the mailboxes are free

  // each real row's sums (its tile's warps added in order), m and l, into the
  // mailbox of its owner, rank r % split, at slot (rank, r / split)
  const int slots = (nrows + split - 1) / split;
  for (int i = tid; i < nrows * (HD / 4); i += THREADS) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
    const float* pr = part + ((r >> 4) * TG * 16 + (r & 15)) * HD + c;
    float4 a = *reinterpret_cast<const float4*>(pr);
#pragma unroll
    for (int w = 1; w < TG; ++w) {
      const float4 o = *reinterpret_cast<const float4*>(pr + w * 16 * HD);
      a.x += o.x;
      a.y += o.y;
      a.z += o.z;
      a.w += o.w;
    }
    float* dst = cluster.map_shared_rank(mb, r % split);
    *reinterpret_cast<float4*>(dst + (rank * slots + r / split) * HD + c) = a;
  }
  if (tid < nrows) {
    const int r = tid, at = rank * slots + r / split;
    float l = red[(r >> 4) * TG * 16 + (r & 15)];
#pragma unroll
    for (int w = 1; w < TG; ++w) l += red[((r >> 4) * TG + w) * 16 + (r & 15)];
    cluster.map_shared_rank(mbm, r % split)[at] = mrow[r];
    cluster.map_shared_rank(mbl, r % split)[at] = l;
  }
  cluster.sync();  // every rank's rows are in their owners' mailboxes

  // the merge of the rows this rank owns, a row a warp: the ranks in rank
  // order and the new tokens (row t sees new tokens t' <= t; those of the
  // first NEWMAX in shared memory, all scored at once), rescaled to the row's
  // max in f32
  for (int k = warp;; k += NWARPS) {
    const int r = rank + split * k;
    if (r >= nrows) break;
    const int m = row0 + r, t = m / p.R, gq = m % p.R;
    float mr = NEG_INF_F, lr = 0.f;
    if (lane < split) {
      mr = mbm[lane * slots + k];
      lr = mbl[lane * slots + k];
    }
    float mx = warp_max(mr);
    float sn[NEWMAX];
    const int nn = NEW ? min(t + 1, NEWMAX) : 0;
    if constexpr (NEW) {
      float qv[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        qv[j] = bf2f(*reinterpret_cast<const bf16*>(qbytes + swz<HD>(r, d >> 3) * 16 +
                                                    (d & 7) * 2));
      }
#pragma unroll
      for (int tn = 0; tn < NEWMAX; ++tn) {
        sn[tn] = 0.f;
        if (tn < nn) {
#pragma unroll
          for (int j = 0; j < DPL; ++j) sn[tn] += qv[j] * bf2f(knew[tn * HD + lane + 32 * j]);
        }
      }
#pragma unroll
      for (int tn = 0; tn < NEWMAX; ++tn)
        if (tn < nn) {
          sn[tn] = warp_sum(sn[tn]) * p.scale;
          mx = fmaxf(mx, sn[tn]);
        }
    }
    const float wr = lane < split ? expf(mr - mx) : 0.f;   // lane rk: rank rk's weight
    const float wl = wr * lr;
    float L = 0.f, o[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) o[j] = 0.f;
#pragma unroll
    for (int rk = 0; rk < MAX_SPLIT; ++rk) {
      if (rk < split) {
        const float w = __shfl_sync(0xffffffffu, wr, rk);
        L += __shfl_sync(0xffffffffu, wl, rk);
        const float* pr = mb + (rk * slots + k) * HD + lane * DPL;
#pragma unroll
        for (int j = 0; j < DPL; ++j) o[j] += w * pr[j];
      }
    }
    if constexpr (NEW) {
#pragma unroll
      for (int tn = 0; tn < NEWMAX; ++tn)
        if (tn < nn) {
          const float pn = expf(sn[tn] - mx);
          L += pn;
#pragma unroll
          for (int j = 0; j < DPL; ++j) o[j] += pn * bf2f(vnew[tn * HD + lane * DPL + j]);
        }
      // new tokens past the first NEWMAX, online from global memory
      for (int tn = NEWMAX; tn <= t; ++tn) {
        const bf16* knb = p.kn + b * p.kn_bs + tn * p.kn_ts + (long long)h * HD;
        const bf16* vnb = p.vn + b * p.vn_bs + tn * p.vn_ts + (long long)h * HD;
        float dot = 0.f;
        for (int d = lane; d < HD; d += 32)
          dot += bf2f(*reinterpret_cast<const bf16*>(qbytes + swz<HD>(r, d >> 3) * 16 +
                                                     (d & 7) * 2)) * bf2f(knb[d]);
        const float s_new = warp_sum(dot) * p.scale;
        const float m_new = fmaxf(mx, s_new);
        const float corr = expf(mx - m_new), pn = expf(s_new - m_new);
        L = L * corr + pn;
#pragma unroll
        for (int j = 0; j < DPL; ++j) o[j] = o[j] * corr + pn * bf2f(vnb[lane * DPL + j]);
        mx = m_new;
      }
    }
    bf16* ob = p.out + (((long long)b * p.SQ + t) * (p.NKV * p.R) + h * p.R + gq) * HD +
               lane * DPL;
#pragma unroll
    for (int j = 0; j < DPL; ++j) ob[j] = f2bf(L > 0.f ? o[j] / L : 0.f);
  }
}

// One cluster launch of KERN (a kernel taking (Params, split)) with its
// shared memory; the caller has set the kernel's dynamic shared memory limit.
template <typename Kern>
inline cudaError_t launch(Kern kern, int smem, const Params& p, dim3 grid, int split,
                          cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, p, split);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace dsplit
