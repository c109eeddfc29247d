// KV-cache writes: new K and V into the cache, as bf16 or quantized to int8 on
// the way; a prefill chunk or one decode token; one layer's cache or all
// layers' stacked (L, B, NKV, S, HD) cache in one launch.
//
// Replaces, in accessory_tpu/ops/decode_attention.py:
//   _write_slab_layer    (`_write_kernel4`, via write_kv_layer)      kv_write_slab
//   _write_slab_layer_q8 (`_write_kernel4_q8`, via write_kv_layer8)  kv_write_slab_q8
//   _write_col_layer     (`_col_write_kernel4`, write_kv_layer at one token)
//                                                                    kv_write_col
//   _write_col_layer_q8  (`_col_write_kernel4_q8`, write_kv_layer8 at one token)
//                                                                    kv_write_col_q8
//   _write_col_inplace   (`_col_write_kernel`, write_kv_t at one token)
//                                                                    kv_write_stacked_col
//   _write_inplace       (`_write_kernel`, write_kv_t for a slab)    kv_write_stacked
//   write_kv_t8          (dynamic_update_slice there)                kv_write_stacked_q8
//
// The one-token writes are a masked read-modify-write of a 128-lane tile on
// the TPU because its cache is lane-major; here a token's row of a head is
// contiguous, so they are the slab kernels at sq = 1 (bf16: with a launch
// shape of their own, blocks of 128 threads). A stacked cache is the
// per-layer problem with L * B batch rows: the new k/v come stacked
// (L, B, sq, NKV, HD), layer stride B batch strides.
//
// Copies new K/V (B, sq, NKV, HD), given with batch and token strides so a
// strided view of the fused qkv projection needs no copy, into the caches
// (B, NKV, S, HD) at token rows [pos, pos + sq). Both pools go in one launch
// (blockIdx.y selects the pool). Any sq and any pos are served: the TPU
// kernel's 128-aligned pos rule was a lane-tiling constraint.
//
// Bound on the H100: bytes (each element is read once and written once).
// Each thread moves 16 bytes; neighbouring threads take neighbouring 16-byte
// pieces of one token's heads, so reads are contiguous per token and writes
// are contiguous per (head, token) row of HD * 2 bytes.
//
// The int8 form. The TPU kernel is four DMAs of a chunk that XLA quantized in
// a pass before it. On this card such a pass would write the quantized chunk
// and read it back, so the kernel takes the bf16 chunk itself (the same
// strided views) and quantizes on the way with the body of kv_quant.cuh
// (whose header gives its design); this file gives it only the addressing:
// vector i is token s = i % sq of (batch row, head) g = i / sq, read at
// row * bs + s * ts + head * HD, stored at pool row g * S + pos + s. k and v
// pools and their scale pools go in one launch. Bound: bytes (2 * HD read,
// HD + 4 written per vector).

#include "common.cuh"
#include "kv_quant.cuh"

namespace {

__global__ void kv_write_kernel(const bf16* __restrict__ nk, long long nk_bs, long long nk_ts,
                                const bf16* __restrict__ nv, long long nv_bs, long long nv_ts,
                                bf16* __restrict__ ck, bf16* __restrict__ cv, int B, int sq,
                                int NKV, int HD, int S, int pos_host,
                                const int* __restrict__ pos_dev) {
  const int pos = pos_dev != nullptr ? __ldg(pos_dev) : pos_host;
  const bf16* src = blockIdx.y == 0 ? nk : nv;
  const long long bs = blockIdx.y == 0 ? nk_bs : nv_bs;
  const long long ts = blockIdx.y == 0 ? nk_ts : nv_ts;
  bf16* dst = blockIdx.y == 0 ? ck : cv;
  const int v8 = HD / 8;
  const long long total = (long long)B * sq * NKV * v8;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int d8 = (int)(i % v8) * 8;
    const int h = (int)((i / v8) % NKV);
    const int s = (int)((i / ((long long)v8 * NKV)) % sq);
    const int b = (int)(i / ((long long)v8 * NKV * sq));
    const uint4 val = *reinterpret_cast<const uint4*>(src + b * bs + s * ts + (long long)h * HD + d8);
    *reinterpret_cast<uint4*>(dst + (((size_t)b * NKV + h) * S + pos + s) * HD + d8) = val;
  }
}

// The static cache's addressing of the quantizing body: vector i is token
// s = i % sq of (batch row, head) g = i / sq.
struct SlabMap {
  const bf16* p;
  long long bs, ts;
  kvq::FastDiv sq, nkv;
  int S, pos, HD;
  __device__ __forceinline__ const bf16* src(int i) const {
    const int g = sq.div(i), r = nkv.div(g);
    return p + r * bs + (i - g * sq.d) * ts + (long long)(g - r * nkv.d) * HD;
  }
  __device__ __forceinline__ size_t row(int i) const {
    const int g = sq.div(i);
    return (size_t)g * S + pos + (i - g * sq.d);
  }
};

template <int HD>
__global__ void __launch_bounds__(kvq::THREADS)
kv_write_q8_kernel(const bf16* __restrict__ nk, long long nk_bs, long long nk_ts,
                   const bf16* __restrict__ nv, long long nv_bs, long long nv_ts,
                   int8_t* __restrict__ ck, int8_t* __restrict__ cv, float* __restrict__ cks,
                   float* __restrict__ cvs, int total, kvq::FastDiv sq, kvq::FastDiv nkv, int S,
                   int pos, const int* __restrict__ pos_dev, int un) {
  const bool k = blockIdx.y == 0;
  if (pos_dev != nullptr) pos = __ldg(pos_dev);
  const SlabMap map{k ? nk : nv, k ? nk_bs : nv_bs, k ? nk_ts : nv_ts, sq, nkv, S, pos, HD};
  kvq::quantize_vectors<HD>(map, total, un, k ? ck : cv, k ? cks : cvs);
}

// Launch helpers: `rows` batch rows (B, or L * B for a stacked cache).
cudaError_t launch_bf16(const void* nk, long long nk_bs, long long nk_ts, const void* nv,
                        long long nv_bs, long long nv_ts, void* cache_k, void* cache_v,
                        long long rows, int sq, int NKV, int HD, int S, int pos,
                        const void* pos_dev, int threads, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (HD % 8 != 0 || rows < 1 || rows > 0x7fffffffLL || sq < 1 || sq > S ||
      (pos_dev == nullptr && (pos < 0 || pos + sq > S)))
    return cudaErrorInvalidValue;
  const long long total = rows * sq * NKV * (HD / 8);
  const long long want = (total + threads - 1) / threads;
  dim3 grid((unsigned)(want < 4096 ? want : 4096), 2);
  kv_write_kernel<<<grid, threads, 0, st>>>(
      static_cast<const bf16*>(nk), nk_bs, nk_ts, static_cast<const bf16*>(nv), nv_bs, nv_ts,
      static_cast<bf16*>(cache_k), static_cast<bf16*>(cache_v), (int)rows, sq, NKV, HD, S, pos,
      static_cast<const int*>(pos_dev));
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_q8_hd(const bf16* k, long long nk_bs, long long nk_ts, const bf16* v,
                         long long nv_bs, long long nv_ts, int8_t* ck, int8_t* cv, float* ks,
                         float* vs, int B, int sq, int NKV, int S, int pos, const int* pos_dev,
                         cudaStream_t st) {
  static const int resident = kvq::resident_blocks(kv_write_q8_kernel<HD>);
  const int total = B * sq * NKV;
  const kvq::Plan pl = kvq::plan(total, HD, 2, resident);
  kv_write_q8_kernel<HD><<<dim3(pl.blocks, 2), kvq::THREADS, 0, st>>>(
      k, nk_bs, nk_ts, v, nv_bs, nv_ts, ck, cv, ks, vs, total, kvq::fast_div(sq),
      kvq::fast_div(NKV), S, pos, pos_dev, pl.un);
  return cudaGetLastError();
}

cudaError_t launch_q8(const void* nk, long long nk_bs, long long nk_ts, const void* nv,
                      long long nv_bs, long long nv_ts, void* cache_k, void* cache_v,
                      void* cache_ks, void* cache_vs, long long rows, int sq, int NKV, int HD,
                      int S, int pos, const void* pos_dev, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (rows < 1 || NKV < 1 || sq < 1 || sq > S ||
      (pos_dev == nullptr && (pos < 0 || pos + sq > S)) || rows * sq * NKV > 0x3fffffffLL)
    return cudaErrorInvalidValue;
  const int* pd = static_cast<const int*>(pos_dev);
  const int B = (int)rows;
  const bf16* k = static_cast<const bf16*>(nk);
  const bf16* v = static_cast<const bf16*>(nv);
  int8_t* ck = static_cast<int8_t*>(cache_k);
  int8_t* cv = static_cast<int8_t*>(cache_v);
  float* ks = static_cast<float*>(cache_ks);
  float* vs = static_cast<float*>(cache_vs);
  if (HD == 64)
    return launch_q8_hd<64>(k, nk_bs, nk_ts, v, nv_bs, nv_ts, ck, cv, ks, vs, B, sq, NKV, S, pos,
                            pd, st);
  if (HD == 128)
    return launch_q8_hd<128>(k, nk_bs, nk_ts, v, nv_bs, nv_ts, ck, cv, ks, vs, B, sq, NKV, S,
                             pos, pd, st);
  if (HD == 256)
    return launch_q8_hd<256>(k, nk_bs, nk_ts, v, nv_bs, nv_ts, ck, cv, ks, vs, B, sq, NKV, S,
                             pos, pd, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Every entry takes pos_dev after pos: null, or an int32 on the card (or the
// low word of an int64) that the kernel reads in place of pos, so that a
// captured launch writes at each replay's position (kept in range by the
// caller).

// A chunk (B, sq, NKV, HD), batch and token strides in elements, into the
// bf16 caches (B, NKV, S, HD) at token rows [pos, pos + sq). Requires
// HD % 8 == 0, 16-byte aligned sources with strides that are multiples of 8
// elements, and pos + sq <= S.
extern "C" int kv_write_slab(const void* nk, long long nk_bs, long long nk_ts, const void* nv,
                             long long nv_bs, long long nv_ts, void* cache_k, void* cache_v,
                             int B, int sq, int NKV, int HD, int S, int pos, const void* pos_dev,
                             void* stream) {
  return (int)launch_bf16(nk, nk_bs, nk_ts, nv, nv_bs, nv_ts, cache_k, cache_v, B, sq, NKV, HD, S,
                          pos, pos_dev, 256, stream);
}

// The int8 form: nk/nv as above (bf16, strided); cache_k/cache_v int8
// (B, NKV, S, HD) and cache_ks/cache_vs f32 (B, NKV, S), all contiguous.
// Requires HD in {64, 128, 256}, 16-byte aligned sources with strides that
// are multiples of 8 elements, and pos + sq <= S.
extern "C" int kv_write_slab_q8(const void* nk, long long nk_bs, long long nk_ts, const void* nv,
                                long long nv_bs, long long nv_ts, void* cache_k, void* cache_v,
                                void* cache_ks, void* cache_vs, int B, int sq, int NKV, int HD,
                                int S, int pos, const void* pos_dev, void* stream) {
  return (int)launch_q8(nk, nk_bs, nk_ts, nv, nv_bs, nv_ts, cache_k, cache_v, cache_ks, cache_vs,
                        B, sq, NKV, HD, S, pos, pos_dev, stream);
}

// One token (B, 1, NKV, HD) into the bf16 caches at row pos.
extern "C" int kv_write_col(const void* nk, long long nk_bs, const void* nv, long long nv_bs,
                            void* cache_k, void* cache_v, int B, int NKV, int HD, int S, int pos,
                            const void* pos_dev, void* stream) {
  return (int)launch_bf16(nk, nk_bs, 0, nv, nv_bs, 0, cache_k, cache_v, B, 1, NKV, HD, S, pos,
                          pos_dev, 128, stream);
}

// One token quantized into the int8 caches and the scale pools at row pos.
extern "C" int kv_write_col_q8(const void* nk, long long nk_bs, const void* nv, long long nv_bs,
                               void* cache_k, void* cache_v, void* cache_ks, void* cache_vs,
                               int B, int NKV, int HD, int S, int pos, const void* pos_dev,
                               void* stream) {
  return (int)launch_q8(nk, nk_bs, 0, nv, nv_bs, 0, cache_k, cache_v, cache_ks, cache_vs, B, 1,
                        NKV, HD, S, pos, pos_dev, stream);
}

// All layers in one launch: new k/v (L, B, sq, NKV, HD) with layer stride
// B * batch stride, into stacked bf16 caches (L, B, NKV, S, HD) contiguous.
extern "C" int kv_write_stacked(const void* nk, long long nk_bs, long long nk_ts, const void* nv,
                                long long nv_bs, long long nv_ts, void* cache_k, void* cache_v,
                                int L, int B, int sq, int NKV, int HD, int S, int pos,
                                const void* pos_dev, void* stream) {
  return (int)launch_bf16(nk, nk_bs, nk_ts, nv, nv_bs, nv_ts, cache_k, cache_v, (long long)L * B,
                          sq, NKV, HD, S, pos, pos_dev, 256, stream);
}

// The same for one token per layer (L, B, 1, NKV, HD).
extern "C" int kv_write_stacked_col(const void* nk, long long nk_bs, const void* nv,
                                    long long nv_bs, void* cache_k, void* cache_v, int L, int B,
                                    int NKV, int HD, int S, int pos, const void* pos_dev,
                                    void* stream) {
  return (int)launch_bf16(nk, nk_bs, 0, nv, nv_bs, 0, cache_k, cache_v, (long long)L * B, 1, NKV,
                          HD, S, pos, pos_dev, 128, stream);
}

// All layers quantized into stacked int8 caches (L, B, NKV, S, HD) and scale
// pools (L, B, NKV, S), any sq.
extern "C" int kv_write_stacked_q8(const void* nk, long long nk_bs, long long nk_ts,
                                   const void* nv, long long nv_bs, long long nv_ts,
                                   void* cache_k, void* cache_v, void* cache_ks, void* cache_vs,
                                   int L, int B, int sq, int NKV, int HD, int S, int pos,
                                   const void* pos_dev, void* stream) {
  return (int)launch_q8(nk, nk_bs, nk_ts, nv, nv_bs, nv_ts, cache_k, cache_v, cache_ks, cache_vs,
                        (long long)L * B, sq, NKV, HD, S, pos, pos_dev, stream);
}
