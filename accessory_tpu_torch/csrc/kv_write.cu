// KV-cache slab write: a prefill chunk's K and V into the per-layer cache.
//
// Replaces: accessory_tpu/ops/decode_attention.py::_write_slab_layer (Pallas
// kernel `_write_kernel4`, via write_kv_layer).
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

#include "common.cuh"

namespace {

__global__ void kv_write_kernel(const bf16* __restrict__ nk, long long nk_bs, long long nk_ts,
                                const bf16* __restrict__ nv, long long nv_bs, long long nv_ts,
                                bf16* __restrict__ ck, bf16* __restrict__ cv, int B, int sq,
                                int NKV, int HD, int S, int pos) {
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

}  // namespace

// Requires HD % 8 == 0, 16-byte aligned sources with strides that are
// multiples of 8 elements, and pos + sq <= S.
extern "C" int kv_write_slab(const void* nk, long long nk_bs, long long nk_ts, const void* nv,
                             long long nv_bs, long long nv_ts, void* cache_k, void* cache_v,
                             int B, int sq, int NKV, int HD, int S, int pos, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (HD % 8 != 0 || pos < 0 || sq < 1 || pos + sq > S) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * sq * NKV * (HD / 8);
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  dim3 grid((unsigned)(want < 4096 ? want : 4096), 2);
  kv_write_kernel<<<grid, threads, 0, st>>>(
      static_cast<const bf16*>(nk), nk_bs, nk_ts, static_cast<const bf16*>(nv), nv_bs, nv_ts,
      static_cast<bf16*>(cache_k), static_cast<bf16*>(cache_v), B, sq, NKV, HD, S, pos);
  return (int)cudaGetLastError();
}
