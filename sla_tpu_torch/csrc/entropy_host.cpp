// Host build of the entropy kernels' schedules (entropy.cuh), for the tests
// only: g++ -fwrapv compiles it on a machine without a card, and the tests
// hold it against the plain PyTorch scans and the host coder. Same
// parameters as the C entries of entropy.cu, with `fixed` in place of the
// stream: fixed 1 takes the compile-time channel count the kernel would
// take for C 1 and 2, fixed 0 the run-time one. Each launch's blocks run one
// after another, each with every thread of its warps or block: K8's chain
// pass with its three roles (the chain warp, the warps staging tiles and
// writing record tiles), its emit blocks with their scan and word buffer;
// K9's warps with their staging ring and output tile.
#include <stdint.h>

#include <vector>

#include "entropy.cuh"

namespace {

using namespace sla::rice;

template <int CT>
void encode_blocks(const int32_t* x, int L, const int32_t* row0, const int32_t* counts,
                   const int64_t* init, int B, int C, const int64_t* offsets, uint8_t* out,
                   int64_t* sizes, uint16_t* recs, int emit) {
  if (emit) {
    const HostCta<kEmitThreads> cta;
    std::vector<uint32_t> words(kEmitWords);
    uint32_t sums[kEmitThreads / 32];
    for (int b = 0; b < B; ++b) {
      emit_block<CT>(cta, b, x, L, row0, counts, C, offsets, out, recs, words.data(), sums);
    }
  } else {
    const HostRoles roles;
    std::vector<int32_t> stage(kStageInts);
    std::vector<uint16_t> rtile(kRecShorts);
    int64_t row_off[kChainRows], row_bits[kChainRows];
    const int G = kChainRows / C;
    for (int cta = 0; cta * G < B; ++cta) {
      chain_blocks<CT>(roles, cta, x, L, row0, counts, init, B, C, sizes, recs, stage.data(),
                       rtile.data(), row_off, row_bits);
    }
  }
}

template <int CT>
void decode_blocks(const uint8_t* stream, int64_t nwords, const int64_t* bit_offsets, int W,
                   const int32_t* counts, const int64_t* init, int B, int C, int n_max,
                   int32_t* out, uint8_t* bad) {
  const HostWarp warp;
  uint32_t ring[kRingSlots];
  int32_t tile[kMaxChannels * kDecodeTile];
  for (int b = 0; b < B; ++b) {
    bad[b] = decode_block<CT>(warp, stream, nwords, bit_offsets[b], W, counts[b], n_max, C,
                              init + (int64_t)b * C, out + (int64_t)b * C * n_max, ring, tile);
  }
}

}  // namespace

extern "C" {

void sla_host_rice_encode_blocks(const int32_t* x, int L, const int32_t* row0,
                                 const int32_t* counts, const int64_t* init, int B, int C,
                                 const int64_t* offsets, uint8_t* out, int64_t* sizes,
                                 uint16_t* recs, int emit, int fixed) {
  if (fixed && C == 1)
    return encode_blocks<1>(x, L, row0, counts, init, B, C, offsets, out, sizes, recs, emit);
  if (fixed && C == 2)
    return encode_blocks<2>(x, L, row0, counts, init, B, C, offsets, out, sizes, recs, emit);
  encode_blocks<0>(x, L, row0, counts, init, B, C, offsets, out, sizes, recs, emit);
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
