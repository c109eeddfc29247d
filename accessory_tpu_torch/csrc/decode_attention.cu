// GQA decode attention over the static KV cache, bf16 or int8 with per-token
// f32 scales, fused with the cache write of the new token or read-only.
//
// Replaces, in accessory_tpu/ops/decode_attention.py:
//   _kernel_bloop_w   (via _decode_attn_bloop_w / decode_attention_update)
//   _kernel_bloop_w8  (via _decode_attn_bloop_w8 / decode_attention_update8)
//   _kernel_bloop     (via _decode_attn_bloop / cached_attention_t) and
//   _kernel           (via _decode_attn_pallas, the same function on a
//                      (B, NKV) grid; here each (b, kv head) is one cluster)
//   _kernel_bloop8    (via _decode_attn_bloop8 / cached_attention_t8)
// One kernel, csrc/decode_split.cuh's flash-decoding body, three compile-time
// switches: the cache's element type, WRITE (with it off the pools are only
// read) and the m16 tiles of a block's query rows (1, 2 or 4). A group's R
// query rows are cut into tiles of up to 64 (head_dim 64) or 32 (128) rows,
// as the paged entry cuts its rows, each tile a cluster of its own over the
// same cached tokens (ops/decode_attention.py::TILE_ROWS, decode_plan): the
// TPU kernel's (b_blk, 1, r, hd) block takes any R, and Falcon-7B's 71 query
// heads over one kv head are a tile of 64 rows and one of 7. The second
// tile reads every K / V chunk the first reads, mostly from L2 (its blocks
// are launched beside the first's); the tiles' shared memory and registers
// stay those of one 64-row tile. Only the first tile's rank 0 writes the new
// token.
//
// The cache is (B, NKV, S, HD), every cached token of a head one contiguous
// row. The R = NQ / NKV query rows of a group share every K / V read; the
// cached tokens < pos are split over a cluster of `split` blocks (the host's
// plan from S alone, ops/decode_attention.py::decode_plan; each rank's range
// from pos), scored on the tensor cores and merged in rank order; the new
// token's k / v (not yet in the cache) enter exactly, as the second part of
// the softmax, as in the TPU kernel. P is rounded to bf16 against the rank's
// running max before the P.V product (the TPU kernel's p_old.astype(bf16));
// the new token's term stays f32. With WRITE rank 0 of the first tile then
// stores k / v at index pos: no rank of any tile reads index >= pos and only
// the (b, head)'s clusters touch its slice, so there is no race. Any cache
// length S is served.
//
// int8 form: a token's cached row is HD bytes; it lands as it is and is
// widened to bf16 (exact) in shared memory. The token's k scale multiplies the
// score (with the softmax scale) after the dot, the v scale multiplies p
// before p is rounded to bf16, never an element (the TPU kernel's rank-1
// epilogues). With WRITE the new token's k and v are amax-reduced by a warp
// each, quantized (scale = max(amax, 1e-6) / 127, q = clip(rint(x / scale),
// +-127), IEEE division) and stored with their two f32 scales at index pos.
//
// Bound on the H100: bytes (2 * pos * HD * 2 bytes of cache per (b, kv head),
// read once). The split puts B * NKV * ntiles * split blocks on the card (128
// at the decode shape, B 8, NKV 4, split 4, where one block per (b, head) left
// 100 of the 132 SMs idle; 128 at Falcon-7B's B 8, NKV 1, two tiles, split 8)
// and the ring keeps two chunks' loads in flight in each.

#include "decode_split.cuh"

namespace {

template <int HD, int MT, typename CT, bool WRITE>
__global__ void __launch_bounds__(dsplit::THREADS)
decode_attn_kernel(const dsplit::Params p, int split) {
  extern __shared__ __align__(128) unsigned char smem[];
  dsplit::body<HD, MT, CT, false, WRITE, true>(p, split, smem);
}

// grid (split, NKV, B * ntiles): blockIdx.z = b * ntiles + tile
template <int HD, int MT, typename CT, bool WRITE>
cudaError_t run(const dsplit::Params& p, int nz, int split, cudaStream_t st) {
  constexpr int smem = dsplit::smem_bytes<HD, MT, CT, false>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attn_kernel<HD, MT, CT, WRITE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  return dsplit::launch(decode_attn_kernel<HD, MT, CT, WRITE>, smem, p,
                        dim3(split, p.NKV, nz), split, st);
}

template <typename CT, bool WRITE>
cudaError_t launch(const void* q, long long q_bstride, const void* kn, long long kn_bstride,
                   const void* vn, long long vn_bstride, const void* cache_k,
                   const void* cache_v, const void* cache_ks, const void* cache_vs, int B,
                   int NKV, int S, int R, int HD, int pos, const void* pos_dev, int split,
                   float scale, void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if ((HD != 64 && HD != 128) || R < 1) return cudaErrorInvalidValue;
  const dsplit::RowTiles rt = dsplit::row_tiles(R, HD);
  // the fused kernels write index pos; a read-only call may find the cache full
  // (a position on the card is the caller's to keep in range)
  if (B < 1 || NKV < 1 || NKV > 65535 || (long long)B * rt.ntiles > 65535 ||
      (pos_dev == nullptr && (pos < 0 || pos > (WRITE ? S - 1 : S))) || split < 1 ||
      split > dsplit::MAX_SPLIT)
    return cudaErrorInvalidValue;
  dsplit::Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.q_bs = q_bstride;
  p.kn = static_cast<const bf16*>(kn);
  p.kn_bs = kn_bstride;
  p.vn = static_cast<const bf16*>(vn);
  p.vn_bs = vn_bstride;
  p.kc = cache_k;
  p.vc = cache_v;
  p.ks = static_cast<const float*>(cache_ks);
  p.vs = static_cast<const float*>(cache_vs);
  if (WRITE) {
    p.kw = const_cast<void*>(cache_k);
    p.vw = const_cast<void*>(cache_v);
    p.ksw = static_cast<float*>(const_cast<void*>(cache_ks));
    p.vsw = static_cast<float*>(const_cast<void*>(cache_vs));
  }
  p.S = S;
  p.pos = pos;
  p.pos_dev = static_cast<const int*>(pos_dev);
  p.NKV = NKV;
  p.R = R;
  p.SQ = 1;
  p.ntiles = rt.ntiles;
  p.scale = scale;
  p.out = static_cast<bf16*>(out);
  const int nz = B * rt.ntiles;
  if (HD == 64) {
    if (rt.mt == 1) return run<64, 1, CT, WRITE>(p, nz, split, st);
    return rt.mt == 2 ? run<64, 2, CT, WRITE>(p, nz, split, st)
                      : run<64, 4, CT, WRITE>(p, nz, split, st);
  }
  return rt.mt == 1 ? run<128, 1, CT, WRITE>(p, nz, split, st)
                    : run<128, 2, CT, WRITE>(p, nz, split, st);
}

}  // namespace

// q: (B, NKV*R*HD) rows with batch stride q_bstride (elements); kn/vn: (B,
// NKV*HD) rows with their batch strides; caches (B, NKV, S, HD) contiguous,
// 16-byte aligned; out (B, NKV, R, HD) contiguous. Requires HD in {64, 128},
// B * ceil(R / (64 at HD 64, 32 at HD 128)) <= 65535 (the grid's z: a cluster
// a tile of query rows), 0 <= pos < S, 1 <= split <= 8 (the blocks of a
// cluster, decode_plan's). Attends, then writes k/v at pos. pos_dev: null, or
// an int32 on the card (or the low word of an int64) that the kernel reads
// in place of pos, so that a captured launch takes each replay's position.
extern "C" int decode_attention(const void* q, long long q_bstride, const void* kn,
                                long long kn_bstride, const void* vn, long long vn_bstride,
                                void* cache_k, void* cache_v, int B, int NKV, int S, int R,
                                int HD, int pos, const void* pos_dev, int split, float scale,
                                void* out, void* stream) {
  return (int)launch<bf16, true>(q, q_bstride, kn, kn_bstride, vn, vn_bstride, cache_k, cache_v,
                                 nullptr, nullptr, B, NKV, S, R, HD, pos, pos_dev, split, scale,
                                 out, stream);
}

// The same attention with the caches only read (0 <= pos <= S).
extern "C" int decode_attention_ro(const void* q, long long q_bstride, const void* kn,
                                   long long kn_bstride, const void* vn, long long vn_bstride,
                                   const void* cache_k, const void* cache_v, int B, int NKV,
                                   int S, int R, int HD, int pos, const void* pos_dev, int split,
                                   float scale, void* out, void* stream) {
  return (int)launch<bf16, false>(q, q_bstride, kn, kn_bstride, vn, vn_bstride, cache_k, cache_v,
                                  nullptr, nullptr, B, NKV, S, R, HD, pos, pos_dev, split, scale,
                                  out, stream);
}

// Over int8 caches (B, NKV, S, HD) with f32 scale pools cache_ks / cache_vs
// (B, NKV, S) contiguous: attends, then quantizes k/v and writes them and
// their two scales at pos.
extern "C" int decode_attention8(const void* q, long long q_bstride, const void* kn,
                                 long long kn_bstride, const void* vn, long long vn_bstride,
                                 void* cache_k, void* cache_v, void* cache_ks, void* cache_vs,
                                 int B, int NKV, int S, int R, int HD, int pos,
                                 const void* pos_dev, int split, float scale, void* out,
                                 void* stream) {
  return (int)launch<int8_t, true>(q, q_bstride, kn, kn_bstride, vn, vn_bstride, cache_k,
                                   cache_v, cache_ks, cache_vs, B, NKV, S, R, HD, pos, pos_dev,
                                   split, scale, out, stream);
}

// The int8 attention with the four pools only read (0 <= pos <= S).
extern "C" int decode_attention8_ro(const void* q, long long q_bstride, const void* kn,
                                    long long kn_bstride, const void* vn, long long vn_bstride,
                                    const void* cache_k, const void* cache_v,
                                    const void* cache_ks, const void* cache_vs, int B, int NKV,
                                    int S, int R, int HD, int pos, const void* pos_dev,
                                    int split, float scale, void* out, void* stream) {
  return (int)launch<int8_t, false>(q, q_bstride, kn, kn_bstride, vn, vn_bstride, cache_k,
                                    cache_v, cache_ks, cache_vs, B, NKV, S, R, HD, pos, pos_dev,
                                    split, scale, out, stream);
}
