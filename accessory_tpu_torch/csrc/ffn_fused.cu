// The whole W4 decode FFN in one launch:
//
//   out = bf16( bf16(silu(h1) * h3) @ W2 ) [+ residual in bf16]
//   h   = bf16( x' @ [W1|W3] ),  x' = [rms_norm](x) rounded to bf16
//
// Replaces: accessory_tpu/ops/ffn_fused.py::ffn_qmm (Pallas kernel
// `_ffn_kernel`: phase A x @ [W1|W3] into a VMEM slab h, phase B
// silu(h1) * h3 @ W2 plus the residual, on one sequential grid).
//
// Weights: the port's folded W4 layout, as csrc/w4_matmul.cu takes it:
// packed (in_dim/8, N) uint32 words of 8 nibbles little-endian along K,
// scales and zs = zeros * scales (>= in_dim/gs, N) f32 (rows past the used
// groups are never read). W13 is [W1|W3] fused along N (N13 = 2 * FFN); W2
// is read over its first FFN rows only, so a W2 whose in_dim the quantizer
// padded past FFN (zero activations meet the padded rows) is served as the
// unfused route serves it.
//
// Bound on the H100: bytes at decode (M <= 8 rows: both weights streamed
// once, TinyLlama 19.5 MB, LLaMA2-7B 76.1 MB with f32 scales and zs);
// operations at 128 rows (TinyLlama 8.96 us, 7B 35.0 at the bf16 peak).
//
// Design: row 1's tensor-core GEMV body (qgemv.cuh: a warp's cp.async ring
// of 64-row weight units, x staged once an item and rearranged into the
// B fragments' order, mma.sync m16n8k16 with the folded W4 dequant as the A
// operand, the group fold s * acc - zs * sum(x)) in a persistent
// cooperative kernel. The grid holds no more blocks than are resident at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs); each block
// walks work items (a 128-column tile x a K rank, the wrapper's plan,
// ops/ffn_fused.py ffn_plan) of phase A, meets the others at
// cooperative_groups::this_grid().sync(), then walks phase B's items.
//  * Phase A (x @ W13): a tile's 128 columns pair W1's 64 columns j * 64 ..
//    (warps 0, 1) with W3's FFN + j * 64 .. (warps 2, 3). The RMSNorm is the
//    prologue: each block sums the squares of every row over all of K in one
//    fixed order (the same bits in every block) while its first item's
//    copies are in flight. K is split over ranks in 64-row units (a rank
//    that cuts a quantization group folds its part: exact in the folded
//    algebra).
//  * Every rank writes its f32 partial tile to a scratch the wrapper
//    allocates and arrives at the tile's counter; the last to arrive sums
//    the ranks' partials in rank order (the same bits whichever rank is
//    last; no float atomics) and runs the epilogue. The counters come back
//    to zero in every launch (the last arriver resets its tile's).
//  * Phase A's epilogue is the SwiGLU: h1 and h3 rounded to bf16 (the TPU
//    kernel's slab), silu(h1) * h3 in f32 rounded once to bf16: hh (M, FFN),
//    written once to the scratch, not recomputed by every phase-B tile.
//  * Phase B (hh @ W2 over W2's first FFN rows, then the residual): the
//    block's first item's weight stages are issued before the grid barrier
//    (only hh depends on it); hh is read after it by cp.async.cg (L2 only:
//    other SMs wrote it in this launch). K is split so that N2 / 128
//    column tiles (16 at TinyLlama, 32 at 7B) fill the card.
//  * M from 17 to 128: each weight unit is staged once and the rows go in
//    passes of 16 over it (qgemv.cuh walk_units_rows), each 32-row half of
//    the unit dequantized once and folded on its own.
// The host side refuses (an error code the wrapper raises) where the device
// has no cooperative launch, the block cannot be resident or the plan's grid
// exceeds the resident blocks, rather than splitting the work into two
// launches.
//
// On an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md, row 23, measured by
// chip_smoke.py in turns with the design it replaced): TinyLlama's FFN at 1 /
// 8 rows 22.4 / 24.1 us and LLaMA2-7B's 52.8 / 55.0, against the unfused
// chain's 26.2 / 29.2 and 59.1 / 63.1 and the replaced kernel's 51.9 / 114.5
// and 116.2 / 252.3; at 128 rows 183 and 557 (replaced 1374 and 3225). The
// replaced kernel ran its own copy of row 1's CUDA-core GEMV (a thread a
// column, scalar FMAs against every row), no copy in flight during the
// products, N2 / 64 phase-B tiles with no K split, the SwiGLU recomputed by
// every phase-B tile and the weights read again per 16-row pass. What bounds
// this one now is the GEMV body's stream, which both phases share.

#include "qgemv.cuh"

namespace cg = cooperative_groups;

namespace {

using P = qgemv::W4Folded;
using S = qgemv::Shape<P>;
using qgemv::BN;
using qgemv::THREADS;
using qgemv::UNIT;
constexpr int MAX_ROWS = 128;
constexpr int VEC = 16;   // 16-byte copy pieces: every operand 16-byte aligned

struct Params {
  const bf16* x;
  long long x_stride;
  int M, K;
  qgemv::Weights w13;   // N = 2 * ffn
  qgemv::Weights w2;    // N = N2, over its first ffn rows
  int ffn;
  const float* norm;    // (K,) or null
  float eps;
  const bf16* residual; // (M, N2) or null
  bf16* hh;             // (M, ffn) scratch
  float* part;          // f32 partial tiles [item][M][128] of the running phase
  unsigned* arrivals;   // [tiles_a + tiles_b] counters, zero between launches
  bf16* out;            // (M, N2)
  int tiles_a, split_a, tiles_b, split_b;
};

// x rows staged a unit (8 H MP), units of x a pass (32 KB of x), the warp
// groups that share the weight stages (two at 128 rows: each thread holds
// 64 rows' sums) and the dynamic shared memory (MP > 1: sums of each unit's
// two 32-row halves)
template <int H, int MP>
struct Rows {
  static constexpr int R = 8 * H * MP;
  static constexpr int XU = 256 / R;
  static constexpr int WG = MP == 8 ? 2 : 1;
  static constexpr int NT = THREADS * WG, NW = NT / 32, PW = MP / WG;
  static constexpr int SMEM = qgemv::smem_bytes(S::RING, R, XU) + (MP > 1 ? XU * R * 4 : 0);
};

// an item's column tile, its rank's units [u0, u0 + nunits) and the first
// weight column of stage warp sw (warp % 4)
struct Item {
  int tile, u0, nunits, wn0;
};

template <bool B>
__device__ __forceinline__ Item item_of(const Params& p, int i, int sw) {
  const int split = B ? p.split_b : p.split_a, units = (B ? p.ffn : p.K) / UNIT;
  const int rank = i % split;
  Item it;
  it.tile = i / split;
  it.u0 = (int)((long long)rank * units / split);
  it.nunits = (int)((long long)(rank + 1) * units / split) - it.u0;
  it.wn0 = B ? it.tile * BN + 32 * sw : (sw >> 1) * p.ffn + it.tile * 64 + 32 * (sw & 1);
  return it;
}

// 1 / rms of every row over all of K: the same loads and sums in the same
// order in every block, so every block rounds the same normalized x
template <int NW>
__device__ void row_rinv(const Params& p, float* rinv, int warp, int lane) {
  constexpr int BATCH = 8;   // 16-byte loads in flight a lane
  const int chunks = p.K / 8;
  for (int m = warp; m < p.M; m += NW) {
    const uint4* row = reinterpret_cast<const uint4*>(p.x + (size_t)m * p.x_stride);
    float ss = 0.f;
    for (int c0 = lane; c0 < chunks; c0 += 32 * BATCH) {
      uint4 raw[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b)
        raw[b] = c0 + 32 * b < chunks ? __ldg(row + c0 + 32 * b) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const uint32_t wv[4] = {raw[b].x, raw[b].y, raw[b].z, raw[b].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float lo = __uint_as_float(wv[k] << 16), hi = __uint_as_float(wv[k] & 0xffff0000u);
          ss = fmaf(lo, lo, ss);
          ss = fmaf(hi, hi, ss);
        }
      }
    }
    ss = warp_sum(ss);
    if (lane == 0) rinv[m] = 1.f / sqrtf(ss / (float)p.K + p.eps);
  }
}

// One work item of phase A (B false) or B: stage x (first pass; with
// `prefetched` the ring's first stages are already in flight), walk the
// rank's units, write the partial tile, arrive; the tile's last arriver sums
// the ranks and runs the phase's epilogue.
template <int H, int MP, bool B>
__device__ void run_item(const Params& p, const qgemv::Ring<P, VEC>& ring, const Item& it, int item,
                         bool prefetched, bool want_rinv, unsigned char* smem, float* rinv,
                         int* last) {
  using RW = Rows<H, MP>;
  constexpr int R = RW::R, XU = RW::XU, NT = RW::NT, PW = RW::PW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, sw = warp & 3;
  const int t = lane & 3, c4 = 4 * (lane >> 2), p0 = (warp >> 2) * PW;   // p0: first row pass
  unsigned char* xraw = smem + S::RING;
  const uint2* xs = reinterpret_cast<const uint2*>(xraw);
  float* nrm = reinterpret_cast<float*>(xraw + qgemv::x_bytes(R, XU));
  float* usum = nrm + XU * UNIT;
  const bf16* x = B ? p.hh : p.x;
  const long long stride = B ? (long long)p.ffn : p.x_stride;
  const float* norm = B ? nullptr : p.norm;

  qgemv::load_x<R, NT>(xraw, nrm, x, stride, p.M, it.u0, min(XU, it.nunits), norm, tid);
  if (prefetched) {
    cp_async_wait<0>();   // x (the ring's stages went out before it)
  } else {
#pragma unroll
    for (int s = 0; s < P::STAGES - 1; ++s) {   // warps past 4 commit empty groups
      if (warp < 4 && s < it.nunits) ring.load(qgemv::stage_of<P>(smem, s, sw), it.u0 + s, lane);
      cp_async_commit();
    }
    if (want_rinv) row_rinv<RW::NW>(p, rinv, warp, lane);
    cp_async_wait<P::STAGES - 1>();   // x; the ring's stages may be in flight
  }

  float acc[PW][2][H][4];
  float gacc[2][H][2][4];   // MP == 1: the group's products, two chains
  float xg[H][2];           // MP == 1: sum(x) of the group's part so far
#pragma unroll
  for (int pp = 0; pp < PW; ++pp)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[pp][i][h][e] = 0.f;
          gacc[i][h][0][e] = gacc[i][h][1][e] = 0.f;
        }
#pragma unroll
  for (int h = 0; h < H; ++h) xg[h][0] = xg[h][1] = 0.f;

  for (int c0 = 0; c0 < it.nunits; c0 += XU) {
    const int nu = min(XU, it.nunits - c0);
    if (c0 > 0) {
      __syncthreads();   // every warp is done with the last pass's x
      qgemv::load_x<R, NT>(xraw, nrm, x, stride, p.M, it.u0 + c0, nu, norm, tid);
      cp_async_wait<0>();
    }
    __syncthreads();   // the pass's raw rows (and rinv) are in place
    qgemv::rearrange<P, H, MP, RW::NW>(xraw, nu, nrm, norm != nullptr ? rinv : nullptr, p.M, usum,
                                       warp, lane);
    __syncthreads();
    if constexpr (MP == 1)
      qgemv::walk_units<P, H, VEC>(ring, smem, xs, usum, it.u0, it.nunits, c0, nu, p.w13.gs,
                                   warp, lane, acc[0], gacc, xg);
    else
      qgemv::walk_units_rows<P, MP, RW::WG, VEC>(ring, smem, xs, usum, it.u0, it.nunits, c0, nu,
                                                 warp, lane, acc);
  }
  cp_async_wait<0>();

  // the partial tile [row][column], rows < M, then the arrival
  float* part = p.part + (size_t)item * p.M * BN;
#pragma unroll
  for (int pp = 0; pp < PW; ++pp)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int row = (p0 + pp) * 8 * H + 8 * h + 2 * t, col = 32 * sw + c4 + 2 * i;
        if (row < p.M)
          *reinterpret_cast<float2*>(part + (size_t)row * BN + col) =
              make_float2(acc[pp][i][h][0], acc[pp][i][h][2]);
        if (row + 1 < p.M)
          *reinterpret_cast<float2*>(part + (size_t)(row + 1) * BN + col) =
              make_float2(acc[pp][i][h][1], acc[pp][i][h][3]);
      }
  __threadfence();   // the partial reaches L2 before the arrival
  __syncthreads();
  const int split = B ? p.split_b : p.split_a;
  unsigned* count = p.arrivals + (B ? p.tiles_a : 0) + it.tile;
  if (tid == 0) {
    const bool is_last = atomicAdd(count, 1u) == (unsigned)(split - 1);
    if (is_last) {
      atomicExch(count, 0u);   // for the next launch
      __threadfence();         // the other ranks' partials before this block's reads
    }
    *last = is_last;
  }
  __syncthreads();
  if (!*last) return;

  // the tile's ranks summed in rank order, read through L2 (ld.global.cg)
  const float* base = p.part + (size_t)it.tile * split * p.M * BN;
  if constexpr (!B) {
    // SwiGLU: h1 (columns 0..63 of the tile) and h3 (64..127) rounded to bf16
    for (int q = tid; q < p.M * 16; q += NT) {
      const int m = q >> 4, c = 4 * (q & 15);
      float v1[4] = {0.f, 0.f, 0.f, 0.f}, v3[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int rk = 0; rk < split; ++rk) {
        const float* pr = base + ((size_t)rk * p.M + m) * BN + c;
        const float4 a = __ldcg(reinterpret_cast<const float4*>(pr));
        const float4 b = __ldcg(reinterpret_cast<const float4*>(pr + 64));
        v1[0] += a.x, v1[1] += a.y, v1[2] += a.z, v1[3] += a.w;
        v3[0] += b.x, v3[1] += b.y, v3[2] += b.z, v3[3] += b.w;
      }
      bf16 o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float h1 = round_bf16(v1[e]), h3 = round_bf16(v3[e]);
        o[e] = f2bf(h1 * (1.f / (1.f + expf(-h1))) * h3);
      }
      uint2 ov;
      ov.x = pack_bf16_pair(o[0], o[1]);
      ov.y = pack_bf16_pair(o[2], o[3]);
      *reinterpret_cast<uint2*>(p.hh + (size_t)m * p.ffn + it.tile * 64 + c) = ov;
    }
  } else {
    // QB tasks (4 columns of a row) a thread, RB ranks' loads in flight
    constexpr int QB = 2, RB = 8;
    const int n2 = p.w2.N, ntask = p.M * (BN / 4);
    for (int q0 = tid; q0 < ntask; q0 += QB * NT) {
      float v[QB][4];
#pragma unroll
      for (int b = 0; b < QB; ++b) v[b][0] = v[b][1] = v[b][2] = v[b][3] = 0.f;
      for (int rk0 = 0; rk0 < split; rk0 += RB) {
        float4 a[RB][QB];
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int b = 0; b < QB; ++b) {   // past the tasks or ranks: a valid address, unused
            const int q = min(q0 + b * NT, ntask - 1), rk = min(rk0 + r, split - 1);
            a[r][b] = __ldcg(reinterpret_cast<const float4*>(
                base + ((size_t)rk * p.M + q / (BN / 4)) * BN + 4 * (q % (BN / 4))));
          }
#pragma unroll
        for (int r = 0; r < RB; ++r)
          if (rk0 + r < split)
#pragma unroll
            for (int b = 0; b < QB; ++b) {
              v[b][0] += a[r][b].x, v[b][1] += a[r][b].y;
              v[b][2] += a[r][b].z, v[b][3] += a[r][b].w;
            }
      }
#pragma unroll
      for (int b = 0; b < QB; ++b) {
        const int q = q0 + b * NT;
        const int m = q / (BN / 4), n = it.tile * BN + 4 * (q % (BN / 4));
        if (q >= ntask || n >= n2) continue;
        bf16 o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[e] = f2bf(v[b][e]);
          if (p.residual != nullptr)
            o[e] = f2bf(bf2f(p.residual[(size_t)m * n2 + n + e]) + bf2f(o[e]));
        }
        uint2 ov;
        ov.x = pack_bf16_pair(o[0], o[1]);
        ov.y = pack_bf16_pair(o[2], o[3]);
        *reinterpret_cast<uint2*>(p.out + (size_t)m * n2 + n) = ov;
      }
    }
  }
}

template <int H, int MP>
__global__ void __launch_bounds__(Rows<H, MP>::NT) ffn_fused_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float rinv[MAX_ROWS];
  __shared__ int last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, sw = warp & 3;
  const int items_a = p.tiles_a * p.split_a, items_b = p.tiles_b * p.split_b;
  bool want_rinv = p.norm != nullptr;
  for (int i = blockIdx.x; i < items_a; i += gridDim.x) {
    const Item it = item_of<false>(p, i, sw);
    const qgemv::Ring<P, VEC> ring(p.w13, it.wn0, lane);
    run_item<H, MP, false>(p, ring, it, i, false, want_rinv, smem, rinv, &last);
    want_rinv = false;
  }
  // the weight stages of the block's first phase-B item go out before the
  // barrier: only hh depends on it
  const int b0 = blockIdx.x;
  const Item itb = item_of<true>(p, b0 < items_b ? b0 : 0, sw);
  const qgemv::Ring<P, VEC> ringb(p.w2, itb.wn0, lane);
  if (b0 < items_b) {
#pragma unroll
    for (int s = 0; s < P::STAGES - 1; ++s) {
      if (warp < 4 && s < itb.nunits)
        ringb.load(qgemv::stage_of<P>(smem, s, sw), itb.u0 + s, lane);
      cp_async_commit();
    }
  }
  cg::this_grid().sync();   // every hh tile is written
  if (b0 < items_b) run_item<H, MP, true>(p, ringb, itb, b0, true, false, smem, rinv, &last);
  for (int i = b0 + gridDim.x; i < items_b; i += gridDim.x) {
    const Item it = item_of<true>(p, i, sw);
    const qgemv::Ring<P, VEC> ring(p.w2, it.wn0, lane);
    run_item<H, MP, true>(p, ring, it, i, false, false, smem, rinv, &last);
  }
}

constexpr int MAX_DEVICES = 64;

// blocks of ffn_fused_kernel<H, MP> the device holds at once, taken once per device
template <int H, int MP>
cudaError_t resident(int* blocks) {
  static int cached[MAX_DEVICES];   // blocks + 1; 0: not taken yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return e;
    if (!coop) return cudaErrorNotSupported;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(ffn_fused_kernel<H, MP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Rows<H, MP>::SMEM);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ffn_fused_kernel<H, MP>,
                                                      Rows<H, MP>::NT, Rows<H, MP>::SMEM);
    if (e != cudaSuccess) return e;
    cached[dev] = per_sm * sms + 1;
  }
  *blocks = cached[dev] - 1;
  return *blocks < 1 ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

template <int H, int MP>
cudaError_t launch(const Params& p, int grid, cudaStream_t st) {
  int blocks = 0;
  cudaError_t e = resident<H, MP>(&blocks);
  if (e != cudaSuccess) return e;
  if (grid > blocks) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {const_cast<Params*>(&p)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ffn_fused_kernel<H, MP>),
                                  dim3(grid), dim3(Rows<H, MP>::NT), args, Rows<H, MP>::SMEM, st);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// the calls of the row templates: 8 or 16 rows in one pass, else passes of 16
struct ResidentOf {
  int* blocks;
  template <int H, int MP>
  cudaError_t run() const { return resident<H, MP>(blocks); }
};

struct LaunchOf {
  const Params* p;
  int grid;
  cudaStream_t st;
  template <int H, int MP>
  cudaError_t run() const { return launch<H, MP>(*p, grid, st); }
};

template <class F>
cudaError_t by_rows(int M, const F& f) {
  if (M <= 8) return f.template run<1, 1>();
  if (M <= 16) return f.template run<2, 1>();
  if (M <= 32) return f.template run<2, 2>();
  if (M <= 64) return f.template run<2, 4>();
  return f.template run<2, 8>();
}

}  // namespace

// The blocks a cooperative launch of the kernel for M rows may hold (the
// plan's grid is at most this), into *blocks.
extern "C" int ffn_fused_resident(int M, int* blocks) {
  if (M < 1 || M > MAX_ROWS) return (int)cudaErrorInvalidValue;
  return (int)by_rows(M, ResidentOf{blocks});
}

// x (M, K) bf16 with 16-byte aligned rows of stride x_stride; W13 packed
// (>= K/8, N13) with scales / zs (>= K/gs, N13); W2 packed (>= N13/16, N2)
// with scales / zs (>= N13/2/gs, N2), every weight operand 16-byte aligned;
// norm (K,) f32 or null; residual (M, N2) bf16 contiguous or null; hh (M,
// N13/2) bf16 scratch; part f32 scratch of max(tiles_a * split_a, tiles_b *
// split_b) x M x 128 (tiles_a = N13/128, tiles_b = ceil(N2/128));
// arrivals: tiles_a + tiles_b zeroed counters, left zeroed; out (M, N2)
// bf16. The plan (ops/ffn_fused.py ffn_plan): split_a in [1, K/64], split_b
// in [1, N13/128], grid in [1, ffn_fused_resident]. Requires 1 <= M <= 128,
// gs % 64 == 0, K % gs == 0, (N13 / 2) % gs == 0, N2 % 64 == 0.
extern "C" int ffn_fused(const void* x, int M, int K, int x_stride, const void* p13,
                         const void* s13, const void* z13, int N13, const void* p2,
                         const void* s2, const void* z2, int N2, int gs, const void* norm,
                         float eps, const void* residual, void* hh, void* part, void* arrivals,
                         void* out, int split_a, int split_b, int grid, void* stream) {
  if (M < 1 || M > MAX_ROWS || gs <= 0 || gs % 64 != 0 || K <= 0 || K % gs != 0 ||
      N13 <= 0 || N13 % 2 != 0 || (N13 / 2) % gs != 0 || N2 <= 0 || N2 % 64 != 0 ||
      x_stride % 8 != 0 || split_a < 1 || split_a > K / UNIT || split_b < 1 ||
      split_b > N13 / 2 / UNIT || grid < 1 || hh == nullptr || part == nullptr ||
      arrivals == nullptr)
    return (int)cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(p13) |
                          reinterpret_cast<uintptr_t>(s13) | reinterpret_cast<uintptr_t>(z13) |
                          reinterpret_cast<uintptr_t>(p2) | reinterpret_cast<uintptr_t>(s2) |
                          reinterpret_cast<uintptr_t>(z2) | reinterpret_cast<uintptr_t>(hh);
  if ((align & 15) != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.x_stride = x_stride;
  p.M = M;
  p.K = K;
  p.w13 = qgemv::Weights{p13, static_cast<const float*>(s13), static_cast<const float*>(z13), N13,
                         gs};
  p.w2 = qgemv::Weights{p2, static_cast<const float*>(s2), static_cast<const float*>(z2), N2, gs};
  p.ffn = N13 / 2;
  p.norm = static_cast<const float*>(norm);
  p.eps = eps;
  p.residual = static_cast<const bf16*>(residual);
  p.hh = static_cast<bf16*>(hh);
  p.part = static_cast<float*>(part);
  p.arrivals = static_cast<unsigned*>(arrivals);
  p.out = static_cast<bf16*>(out);
  p.tiles_a = p.ffn / 64;
  p.split_a = split_a;
  p.tiles_b = (N2 + BN - 1) / BN;
  p.split_b = split_b;
  return (int)by_rows(M, LaunchOf{&p, grid, reinterpret_cast<cudaStream_t>(stream)});
}
