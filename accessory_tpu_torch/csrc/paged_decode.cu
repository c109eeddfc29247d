// Decode attention over a paged KV cache: SQ new tokens per slot attend to
// the slot's cached tokens, read through its page table from read-only
// pools, plus (causally) to each other; bf16 pools, or int8 pools with
// per-token f32 scales.
//
// Replaces, in accessory_tpu/ops/paged_decode.py:
//   _paged_kernel   (via _paged_decode / paged_decode_attention)   paged_decode
//   _paged_kernel8  (via _paged_decode8 / paged_decode_attention)  paged_decode8
// and their shared epilogue _finish (the new tokens' part of the softmax);
// and, in accessory_tpu/engine/kvcache.py, JAX's bundled paged_attention
// kernel (via paged_attention_decode :414)                         paged_decode_ro
// the read-only form: one query token a slot whose k/v the pools already
// hold (its length counts it), so the new-token part is skipped and a slot
// of length 0 gets zeros. It is scaled by hd^-0.5 as the reference's oracle
// paged_attention_xla is (the bundled kernel applies no scale).
//
// Pools (NKV, P, PS, HD): one layer of the port's stacked (L, NKV, P, PS, HD)
// pools, every cached token of a head one contiguous row; int8 pools carry
// f32 scale pools (NKV, P, PS). The page table (B, PPS) int32 and the
// lengths (B,) int32 are device tensors read here, so a host loop of decode
// steps that advances the lengths on the device never waits for the card.
//
// One kernel, csrc/decode_split.cuh's flash-decoding body. A slot's query
// rows are cut into tiles of up to MAXM (64 at head_dim 64, 32 at 128), each
// tile of one kv head a cluster of `split` blocks (the host's plan from J * PS,
// never the lengths: ops/paged_decode.py::paged_plan). Query row m = t * R + g
// is new token t, group member g (the TPU kernel's row order); the R rows of a
// token share every K/V read. Each rank reads the slot's length on the card
// and folds its own range of the cached tokens [0, min(length, J * PS)) in
// chunks of 64: each token's pool row is found from its page
// (page_indices[b, tok / PS]) and offset and copied with 16-byte cp.async
// pieces (any PS; a page of PS >= 64 tokens is whole chunks), scored on the
// tensor cores and folded into an online softmax, P rounded to bf16 against
// the rank's running max before the P.V product (the TPU kernel's
// p.astype(bf16)). Pages past the length are not read at all: the TPU kernel
// reads them (TRASH page 0 for an idle slot) and masks every score with the
// finite -1e30, which gives the same result. int8: the token's k scale
// multiplies the score after the dot (with the softmax scale), the v scale
// multiplies p before its bf16 rounding, never an element. The ranks merge in
// rank order; then the new tokens' k/v, given apart (not yet in the pools, so
// exact and, for int8 pools, unquantized), enter as the second part of the
// softmax: row t sees new tokens t' <= t, in f32.
//
// Bound on the H100: bytes (each cached token's k and v read once per tile of
// rows, q and the new k/v once, the output written once). The split puts
// 128-264 blocks on the card at the serving shapes (8 slots x 4 kv heads x 8
// ranks), where one block per (slot, kv head) left most of the 132 SMs idle.

#include "decode_split.cuh"

namespace {

template <int HD, int MT, typename CT, bool RO>
__global__ void __launch_bounds__(dsplit::THREADS)
paged_decode_kernel(const dsplit::Params p, int split) {
  extern __shared__ __align__(128) unsigned char smem[];
  dsplit::body<HD, MT, CT, true, false, !RO>(p, split, smem);
}

template <int HD, int MT, typename CT, bool RO>
cudaError_t run(const dsplit::Params& p, dim3 grid, int split, cudaStream_t st) {
  constexpr int smem = dsplit::smem_bytes<HD, MT, CT, true>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_decode_kernel<HD, MT, CT, RO>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  return dsplit::launch(paged_decode_kernel<HD, MT, CT, RO>, smem, p, grid, split, st);
}

template <typename CT, bool RO>
cudaError_t launch(const void* q, long long q_bs, long long q_ts, const void* kn, long long kn_bs,
                   long long kn_ts, const void* vn, long long vn_bs, long long vn_ts,
                   const void* kp, const void* vp, const void* ksp, const void* vsp,
                   const void* lengths, const void* pt, int PPS, int J, int B, int NKV, int P,
                   int PS, int SQ, int R, int HD, int split, float scale, void* out,
                   void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B < 1 || NKV < 1 || NKV > 65535 || P < 1 || PS < 1 || SQ < 1 || R < 1 || J < 1 ||
      J > PPS || split < 1 || split > dsplit::MAX_SPLIT || (HD != 64 && HD != 128))
    return cudaErrorInvalidValue;
  const dsplit::RowTiles rt = dsplit::row_tiles(SQ * R, HD);
  if ((long long)B * rt.ntiles > 65535) return cudaErrorInvalidValue;
  dsplit::Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.q_bs = q_bs;
  p.q_ts = q_ts;
  p.kn = static_cast<const bf16*>(kn);
  p.kn_bs = kn_bs;
  p.kn_ts = kn_ts;
  p.vn = static_cast<const bf16*>(vn);
  p.vn_bs = vn_bs;
  p.vn_ts = vn_ts;
  p.kc = kp;
  p.vc = vp;
  p.ks = static_cast<const float*>(ksp);
  p.vs = static_cast<const float*>(vsp);
  p.lengths = static_cast<const int*>(lengths);
  p.pt = static_cast<const int*>(pt);
  p.PPS = PPS;
  p.J = J;
  p.P = P;
  p.PS = PS;
  p.NKV = NKV;
  p.R = R;
  p.SQ = SQ;
  p.ntiles = rt.ntiles;
  p.scale = scale;
  p.out = static_cast<bf16*>(out);
  const dim3 grid(split, NKV, B * rt.ntiles);
  if (HD == 64) {
    if (rt.mt == 1) return run<64, 1, CT, RO>(p, grid, split, st);
    return rt.mt == 2 ? run<64, 2, CT, RO>(p, grid, split, st)
                      : run<64, 4, CT, RO>(p, grid, split, st);
  }
  return rt.mt == 1 ? run<128, 1, CT, RO>(p, grid, split, st)
                    : run<128, 2, CT, RO>(p, grid, split, st);
}

}  // namespace

// q (B, SQ, NKV * R, HD) and k_new / v_new (B, SQ, NKV, HD), bf16, each with
// batch and token strides in elements and contiguous heads; pools (NKV, P, PS,
// HD) bf16 contiguous, 16-byte aligned; lengths (B,) int32 (cached tokens
// before the new ones); page table (B, PPS) int32 rows; the first J logical
// pages are read. out (B, SQ, NKV * R, HD) bf16 contiguous. HD 64 or 128;
// 1 <= split <= 8 (the blocks of a cluster, paged_plan's).
extern "C" int paged_decode(const void* q, long long q_bs, long long q_ts, const void* kn,
                            long long kn_bs, long long kn_ts, const void* vn, long long vn_bs,
                            long long vn_ts, const void* k_pages, const void* v_pages,
                            const void* lengths, const void* page_table, int PPS, int J, int B,
                            int NKV, int P, int PS, int SQ, int R, int HD, int split,
                            float scale, void* out, void* stream) {
  return (int)launch<bf16, false>(q, q_bs, q_ts, kn, kn_bs, kn_ts, vn, vn_bs, vn_ts, k_pages,
                                  v_pages, nullptr, nullptr, lengths, page_table, PPS, J, B,
                                  NKV, P, PS, SQ, R, HD, split, scale, out, stream);
}

// The same over int8 pools (NKV, P, PS, HD) with f32 scale pools (NKV, P, PS).
extern "C" int paged_decode8(const void* q, long long q_bs, long long q_ts, const void* kn,
                             long long kn_bs, long long kn_ts, const void* vn, long long vn_bs,
                             long long vn_ts, const void* k_pages, const void* v_pages,
                             const void* ks_pages, const void* vs_pages, const void* lengths,
                             const void* page_table, int PPS, int J, int B, int NKV, int P,
                             int PS, int SQ, int R, int HD, int split, float scale, void* out,
                             void* stream) {
  return (int)launch<int8_t, false>(q, q_bs, q_ts, kn, kn_bs, kn_ts, vn, vn_bs, vn_ts, k_pages,
                                    v_pages, ks_pages, vs_pages, lengths, page_table, PPS, J, B,
                                    NKV, P, PS, SQ, R, HD, split, scale, out, stream);
}

// The read-only form (bf16 pools): q (B, NKV * R, HD) bf16, batch stride
// q_bs in elements, contiguous heads; lengths (B,) int32 counting the token
// whose k/v the pools already hold; page table rows of stride PPS, of
// which the first J pages may be read. out (B, NKV * R, HD) bf16 contiguous.
extern "C" int paged_decode_ro(const void* q, long long q_bs, const void* k_pages,
                               const void* v_pages, const void* lengths, const void* page_table,
                               int PPS, int J, int B, int NKV, int P, int PS, int R, int HD,
                               int split, float scale, void* out, void* stream) {
  return (int)launch<bf16, true>(q, q_bs, 0, nullptr, 0, 0, nullptr, 0, 0, k_pages, v_pages,
                                 nullptr, nullptr, lengths, page_table, PPS, J, B, NKV, P, PS,
                                 1, R, HD, split, scale, out, stream);
}
