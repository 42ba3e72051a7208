// Host build of the entropy kernels' bodies (entropy.cuh), for the tests
// only: g++ -fwrapv compiles it on a machine without a card, and the tests
// hold each body against the plain PyTorch scans and the host coder. Same
// parameters as the C entries of entropy.cu, with `fixed` in place of the
// stream: fixed 1 takes the compile-time channel count the kernel would
// take for C 1 and 2, fixed 0 the run-time one. Each block runs on its own,
// in order, as one thread of the kernel does.
#include <stdint.h>

#include "entropy.cuh"

namespace {

template <int CT>
void encode_blocks(const int32_t* x, int L, const int32_t* row0, const int32_t* counts,
                   const int64_t* init, int B, int C, const int64_t* offsets, uint8_t* out,
                   int64_t* sizes, int emit) {
  for (int b = 0; b < B; ++b) {
    const int32_t* rows = x + (int64_t)row0[b] * L;
    if (emit) {
      sla::rice::encode_block<CT, true>(rows, L, C, counts[b], init + (int64_t)b * C,
                                        reinterpret_cast<uint32_t*>(out + offsets[b]));
    } else {
      sizes[b] = (sla::rice::encode_block<CT, false>(rows, L, C, counts[b],
                                                     init + (int64_t)b * C, nullptr) + 7) >> 3;
    }
  }
}

template <int CT>
void decode_blocks(const uint8_t* stream, int64_t nwords, const int64_t* bit_offsets, int W,
                   const int32_t* counts, const int64_t* init, int B, int C, int n_max,
                   int32_t* out, uint8_t* bad) {
  const sla::rice::StreamWords sw{stream, nwords};
  for (int b = 0; b < B; ++b) {
    const int64_t bp = bit_offsets[b];
    bad[b] = sla::rice::decode_block<CT>(sw, bp, ((bp >> 5) + W) * 32, counts[b], n_max, C,
                                         init + (int64_t)b * C, out + (int64_t)b * C * n_max);
  }
}

}  // namespace

extern "C" {

void sla_host_rice_encode_blocks(const int32_t* x, int L, const int32_t* row0,
                                 const int32_t* counts, const int64_t* init, int B, int C,
                                 const int64_t* offsets, uint8_t* out, int64_t* sizes, int emit,
                                 int fixed) {
  if (fixed && C == 1) return encode_blocks<1>(x, L, row0, counts, init, B, C, offsets, out, sizes, emit);
  if (fixed && C == 2) return encode_blocks<2>(x, L, row0, counts, init, B, C, offsets, out, sizes, emit);
  encode_blocks<0>(x, L, row0, counts, init, B, C, offsets, out, sizes, emit);
}

void sla_host_rice_decode_blocks(const uint8_t* stream, int64_t nwords,
                                 const int64_t* bit_offsets, int W, const int32_t* counts,
                                 const int64_t* init, int B, int C, int n_max, int32_t* out,
                                 uint8_t* bad, int fixed) {
  if (fixed && C == 1)
    return decode_blocks<1>(stream, nwords, bit_offsets, W, counts, init, B, C, n_max, out, bad);
  if (fixed && C == 2)
    return decode_blocks<2>(stream, nwords, bit_offsets, W, counts, init, B, C, n_max, out, bad);
  decode_blocks<0>(stream, nwords, bit_offsets, W, counts, init, B, C, n_max, out, bad);
}

}  // extern "C"
