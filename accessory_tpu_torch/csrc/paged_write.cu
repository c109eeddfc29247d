// Paged KV-cache writes: every layer's new k and v of a forward, S tokens per
// slot, stored at each token's page and offset; bf16 pools, or int8 pools
// with the tokens quantized on the way and their f32 scales stored beside.
//
// Replaces, in accessory_tpu/ops/paged_write.py:
//   _write_kv      (`_kernel`, via paged_write_tokens)          paged_write, paged_write_q8
//   _write_scales  (`_kernel_scales`, via paged_write_tokens)   paged_write_q8
// (the int8 entry quantizes, stores the values and stores the scales in one
// launch, as kv_write.cu's kv_write_stacked_q8 does for the static cache).
//
// New k/v (L, B, S, NKV, HD) bf16, given with layer, batch and token strides
// (contiguous heads); pools (L, NKV, P, PS, HD), scale pools (L, NKV, P, PS).
// Token s of slot b goes to position pos = start[b] + s: logical page pos /
// PS of the slot's row of the page table (B, PPS), offset pos % PS; a
// position past the table's last page goes to the TRASH page 0. start and
// the table are device tensors read here.
//
// The TPU kernel read-modify-writes a whole row tile of the page because its
// DMAs move tiles; a token's row of a head is contiguous here, so this is a
// pure store per (layer, slot, token, kv head), any S (the decode step, the
// speculative verify width, a whole prefill bucket). Idle slots and a
// bucket's tail land in the TRASH page from many blocks at once: plain
// stores, no reduction, and a value and its scale never read each other, so
// the junk there is never more than junk (never read unmasked).
//
// Bound on the H100: bytes (each element read once and written once; int8:
// 2 * HD read, HD + 4 written per vector). bf16: one thread per 16-byte
// piece, neighbouring threads on one token's heads. int8: the quantizing body
// of kv_quant.cuh (bit-equal to ops/decode_attention.py::quantize_kv_chunk),
// with this file's addressing: vector i is token s = i % S of (layer, slot,
// head), stored at pool_row (the body looks up every vector's page after its
// loads are in flight).

#include "common.cuh"
#include "kv_quant.cuh"

namespace {

struct Src {
  const bf16* p;
  long long ls, bs, ts;  // layer, batch and token strides in elements
};

// Pool row (((l * NKV + h) * P + page) * PS + off) of token s of slot b; a
// position past the table, or before 0, goes to the TRASH page 0.
__device__ __forceinline__ size_t pool_row(const int* __restrict__ start,
                                           const int* __restrict__ pt, int PPS, int l, int b,
                                           int s, int h, int NKV, int P, kvq::FastDiv ps) {
  const int pos = start[b] + s;
  const int lp = pos >= 0 ? ps.div(pos) : PPS;
  const int page = lp < PPS ? pt[(long long)b * PPS + lp] : 0;
  if (page < 0 || page >= P) __trap();  // a page id the pools do not have
  return (((size_t)l * NKV + h) * P + page) * ps.d + (pos >= 0 ? pos - lp * ps.d : 0);
}

__global__ void paged_write_kernel(Src k, Src v, bf16* __restrict__ kp, bf16* __restrict__ vp,
                                   const int* __restrict__ start, const int* __restrict__ pt,
                                   int PPS, int L, int B, int S, int NKV, int HD, int P,
                                   kvq::FastDiv ps) {
  const Src src = blockIdx.y == 0 ? k : v;
  bf16* dst = blockIdx.y == 0 ? kp : vp;
  const int v8 = HD / 8;
  const long long total = (long long)L * B * S * NKV * v8;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int d8 = (int)(i % v8) * 8;
    long long rest = i / v8;
    const int h = (int)(rest % NKV);
    rest /= NKV;
    const int s = (int)(rest % S);
    rest /= S;
    const int b = (int)(rest % B);
    const int l = (int)(rest / B);
    const uint4 val = *reinterpret_cast<const uint4*>(src.p + l * src.ls + b * src.bs +
                                                      s * src.ts + (long long)h * HD + d8);
    const size_t row = pool_row(start, pt, PPS, l, b, s, h, NKV, P, ps);
    *reinterpret_cast<uint4*>(dst + row * HD + d8) = val;
  }
}

// The paged pools' addressing of the quantizing body: vector i is token
// s = i % S of (layer, slot, head) ((l * B + b) * NKV + h) = i / S; the
// divisions by S, NKV, B and the page size are multiplications (FastDiv).
struct PagedMap {
  Src src_;
  const int* start;
  const int* pt;
  kvq::FastDiv S, nkv, B, ps;
  int PPS, P, HD;
  __device__ __forceinline__ const bf16* src(int i) const {
    const int g = S.div(i), lb = nkv.div(g), l = B.div(lb);
    return src_.p + l * src_.ls + (lb - l * B.d) * src_.bs + (i - g * S.d) * src_.ts +
           (long long)(g - lb * nkv.d) * HD;
  }
  __device__ __forceinline__ size_t row(int i) const {
    const int g = S.div(i), lb = nkv.div(g), l = B.div(lb);
    return pool_row(start, pt, PPS, l, lb - l * B.d, i - g * S.d, g - lb * nkv.d, nkv.d, P, ps);
  }
};

template <int HD>
__global__ void __launch_bounds__(kvq::THREADS)
paged_write_q8_kernel(Src k, Src v, int8_t* __restrict__ kp, int8_t* __restrict__ vp,
                      float* __restrict__ ksp, float* __restrict__ vsp,
                      const int* __restrict__ start, const int* __restrict__ pt, int total,
                      kvq::FastDiv S, kvq::FastDiv nkv, kvq::FastDiv B, kvq::FastDiv ps,
                      int PPS, int P, int un) {
  const bool isk = blockIdx.y == 0;
  const PagedMap map{isk ? k : v, start, pt, S, nkv, B, ps, PPS, P, HD};
  kvq::quantize_vectors<HD>(map, total, un, isk ? kp : vp, isk ? ksp : vsp);
}

template <int HD>
cudaError_t launch_q8(Src k, Src v, int8_t* kp, int8_t* vp, float* ks, float* vs, const int* sp,
                      const int* tp, int PPS, int L, int B, int S, int NKV, int P, int PS,
                      cudaStream_t st) {
  static const int resident = kvq::resident_blocks(paged_write_q8_kernel<HD>);
  const int total = L * B * S * NKV;
  const kvq::Plan pl = kvq::plan(total, HD, 2, resident);
  paged_write_q8_kernel<HD><<<dim3(pl.blocks, 2), kvq::THREADS, 0, st>>>(
      k, v, kp, vp, ks, vs, sp, tp, total, kvq::fast_div(S), kvq::fast_div(NKV),
      kvq::fast_div(B), kvq::fast_div(PS), PPS, P, pl.un);
  return cudaGetLastError();
}

bool dims_ok(int PPS, int L, int B, int S, int NKV, int P, int PS) {
  return PPS >= 1 && L >= 1 && B >= 1 && S >= 1 && NKV >= 1 && P >= 1 && PS >= 1;
}

}  // namespace

// New k/v (L, B, S, NKV, HD) bf16 with layer / batch / token strides in
// elements (multiples of 8, 16-byte aligned, contiguous heads) into bf16
// pools (L, NKV, P, PS, HD) contiguous; start (B,) int32 positions of each
// slot's first new token; page table (B, PPS) int32 rows. HD % 8 == 0.
extern "C" int paged_write(const void* nk, long long nk_ls, long long nk_bs, long long nk_ts,
                           const void* nv, long long nv_ls, long long nv_bs, long long nv_ts,
                           void* k_pages, void* v_pages, const void* start,
                           const void* page_table, int PPS, int L, int B, int S, int NKV, int HD,
                           int P, int PS, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (HD % 8 != 0 || !dims_ok(PPS, L, B, S, NKV, P, PS)) return (int)cudaErrorInvalidValue;
  const int threads = S == 1 ? 128 : 256;
  const long long total = (long long)L * B * S * NKV * (HD / 8);
  const long long want = (total + threads - 1) / threads;
  dim3 grid((unsigned)(want < 8192 ? want : 8192), 2);
  paged_write_kernel<<<grid, threads, 0, st>>>(
      Src{static_cast<const bf16*>(nk), nk_ls, nk_bs, nk_ts},
      Src{static_cast<const bf16*>(nv), nv_ls, nv_bs, nv_ts}, static_cast<bf16*>(k_pages),
      static_cast<bf16*>(v_pages), static_cast<const int*>(start),
      static_cast<const int*>(page_table), PPS, L, B, S, NKV, HD, P, kvq::fast_div(PS));
  return (int)cudaGetLastError();
}

// The int8 form: the same bf16 sources (16-byte aligned, strides multiples
// of 8 elements) quantized into int8 pools (L, NKV, P, PS, HD)
// and f32 scale pools (L, NKV, P, PS), all contiguous. HD 64, 128 or 256.
extern "C" int paged_write_q8(const void* nk, long long nk_ls, long long nk_bs, long long nk_ts,
                              const void* nv, long long nv_ls, long long nv_bs, long long nv_ts,
                              void* k_pages, void* v_pages, void* ks_pages, void* vs_pages,
                              const void* start, const void* page_table, int PPS, int L, int B,
                              int S, int NKV, int HD, int P, int PS, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (!dims_ok(PPS, L, B, S, NKV, P, PS) || (long long)L * B * S * NKV > 0x3fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Src k{static_cast<const bf16*>(nk), nk_ls, nk_bs, nk_ts};
  const Src v{static_cast<const bf16*>(nv), nv_ls, nv_bs, nv_ts};
  int8_t* kp = static_cast<int8_t*>(k_pages);
  int8_t* vp = static_cast<int8_t*>(v_pages);
  float* ks = static_cast<float*>(ks_pages);
  float* vs = static_cast<float*>(vs_pages);
  const int* sp = static_cast<const int*>(start);
  const int* tp = static_cast<const int*>(page_table);
  if (HD == 64)
    return (int)launch_q8<64>(k, v, kp, vp, ks, vs, sp, tp, PPS, L, B, S, NKV, P, PS, st);
  if (HD == 128)
    return (int)launch_q8<128>(k, v, kp, vp, ks, vs, sp, tp, PPS, L, B, S, NKV, P, PS, st);
  if (HD == 256)
    return (int)launch_q8<256>(k, v, kp, vp, ks, vs, sp, tp, PPS, L, B, S, NKV, P, PS, st);
  return (int)cudaErrorInvalidValue;
}
