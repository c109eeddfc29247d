// Native host-side hot loops of the port (a copy of the JAX package's
// native/packing.cc, built on its own):
//   * pack_stream: slice a concatenated token stream into fixed-length
//     training sequences (tools/generate_packed_data.py)
//   * pad_batch: assemble variable-length sequences into a padded batch
//   * pack_u4 / unpack_u4: nibble (un)packing along k
//
// A plain shared library with a C interface; accessory_tpu_torch/native.py
// builds it with g++ at first use into accessory_tpu_torch/build/ (named by
// the source's hash) and binds it with ctypes on numpy buffers.
//
// Build by hand: g++ -O3 -shared -fPIC -o libpacking.so packing.cc

#include <cstdint>
#include <cstring>

extern "C" {

// Slice tokens[0..n) into consecutive max_words-length sequences.
// out must hold (n / max_words) * max_words int32s.
// Returns the number of complete sequences written.
long pack_stream(const int32_t* tokens, long n, long max_words, int32_t* out) {
    long n_seqs = n / max_words;
    std::memcpy(out, tokens, static_cast<size_t>(n_seqs) * max_words * sizeof(int32_t));
    return n_seqs;
}

// Batch assembly with padding: for each of n_items sequences (lengths[i],
// concatenated in items), copy min(len, max_words) tokens into row i of
// out (n_items x max_words), pad the rest with pad_id.
void pad_batch(const int32_t* items, const long* offsets, long n_items,
               long max_words, int32_t pad_id, int32_t* out) {
    for (long i = 0; i < n_items; ++i) {
        long start = offsets[i];
        long len = offsets[i + 1] - start;
        long copy = len < max_words ? len : max_words;
        std::memcpy(out + i * max_words, items + start,
                    static_cast<size_t>(copy) * sizeof(int32_t));
        for (long j = copy; j < max_words; ++j) out[i * max_words + j] = pad_id;
    }
}

// Pack q (k x n, values in [0,16)) into uint32 words along k:
// out word (w, j) holds rows w*8..w*8+7 at 4-bit fields (little-endian).
// k must be a multiple of 8.
void pack_u4(const int32_t* q, long k, long n, uint32_t* out) {
    long words = k / 8;
    for (long w = 0; w < words; ++w) {
        for (long j = 0; j < n; ++j) {
            uint32_t acc = 0;
            for (int p = 0; p < 8; ++p) {
                acc |= (static_cast<uint32_t>(q[(w * 8 + p) * n + j]) & 0xF)
                       << (4 * p);
            }
            out[w * n + j] = acc;
        }
    }
}

// Inverse of pack_u4.
void unpack_u4(const uint32_t* packed, long k, long n, int32_t* out) {
    long words = k / 8;
    for (long w = 0; w < words; ++w) {
        for (long j = 0; j < n; ++j) {
            uint32_t word = packed[w * n + j];
            for (int p = 0; p < 8; ++p) {
                out[(w * 8 + p) * n + j] =
                    static_cast<int32_t>((word >> (4 * p)) & 0xF);
            }
        }
    }
}

}  // extern "C"
