// The entropy coder's two CUDA kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (sla_tpu_torch/kernels/build.py,
// sla_tpu_torch/kernels/cuda_entropy.py). Their bodies and schedules live in
// entropy.cuh, where the host build (entropy_host.cpp) runs them too.
//
// K8 `rice_encode_blocks` replaces sla_tpu/rice_device.py rice_encode_parts
// (a lax.scan under XLA, not a Pallas kernel) together with the host pack
// after it (native sla_pack_parts): it writes each COMPRESSDATA block's
// byte-aligned payload itself, so only payload bytes cross PCIe, not the
// TPU's 32 bytes of (value, length) parts per residual. K9
// `rice_decode_blocks` replaces rice_device.py rice_decode_blocks (a
// lax.scan): it reads the whole stream where it lies on the card and writes
// the (blocks x channels, n_max) synthesis rows directly.
//
// What bounds them. A symbol moves 4 bytes of residual and a byte or two of
// payload, so the bytes bound a launch of a thousand blocks at about 0.05
// ms; what a design has to beat is the serial chains. In K9 the cursor is
// serial within a block (a symbol's length depends on parameters that
// depend on every value before it); in K8 only each channel's two
// parameters are, and they depend on the residuals alone.
//
// Design. K9 (rice_decode_kernel): a warp a block, a thousand independent
// instruction streams over all 132 SMs (some 8 warps an SM). The warp's
// lanes run the cursor in step, so its chain is one thread's with no
// divergence: a 32-bit bit count, a 64-bit window from three ring words by
// two funnel shifts, a 32-bit clz, the remainder from the same window, a
// sample's symbols as one branch-free block with an exact re-decode where
// one escapes or flags; the lanes stage the payload's words into a 128-word
// shared ring, 8 symbols' worst case ahead of the cursor, tested once every
// 8 symbols (each word loaded one staging earlier, so no global load sits
// on the chain), and store the decoded samples from a shared tile of 32 a
// row as coalesced rows. K8 in two launches, count then emit, with the
// host's exclusive sum of the sizes between them (the payload buffer is
// sized from it): rice_chain_kernel runs each channel's parameter chain
// alone, one lane of its chain warp a (block, channel) row, over residuals
// a second warp stages into shared memory a tile ahead, and writes a 10-bit
// record a symbol (the two Rice parameters' log2), which a third warp
// writes out, and each block's size; rice_emit_kernel, 256 threads a block, turns u and its record into
// the symbol's code, places it by a block-wide exclusive scan of the
// lengths and ORs it into shared words that it stores whole, big-endian.
#include <cuda_runtime.h>
#include <stdint.h>

#include "entropy.cuh"

namespace {

using namespace sla::rice;

template <int CT>
__global__ void __launch_bounds__(kChainThreads)
rice_chain_kernel(const int32_t* __restrict__ x, int L, const int32_t* __restrict__ row0,
                  const int32_t* __restrict__ counts, const int64_t* __restrict__ init, int B,
                  int C, int64_t* __restrict__ sizes, uint16_t* __restrict__ recs) {
  __shared__ int32_t stage[kStageInts];
  __shared__ uint16_t rtile[kRecShorts];
  __shared__ int64_t row_off[kChainRows], row_bits[kChainRows];
  chain_blocks<CT>(CudaRoles{(int)threadIdx.x >> 5, (int)threadIdx.x & 31}, blockIdx.x, x, L, row0,
                   counts, init, B, C, sizes, recs, stage, rtile, row_off, row_bits);
}

template <int CT>
__global__ void __launch_bounds__(kEmitThreads)
rice_emit_kernel(const int32_t* __restrict__ x, int L, const int32_t* __restrict__ row0,
                 const int32_t* __restrict__ counts, int C, const int64_t* __restrict__ offsets,
                 uint8_t* __restrict__ out, const uint16_t* __restrict__ recs) {
  __shared__ uint32_t words[kEmitWords];
  __shared__ uint32_t sums[kEmitThreads / 32];
  emit_block<CT>(CudaCta<kEmitThreads>{}, blockIdx.x, x, L, row0, counts, C, offsets, out, recs,
                 words, sums);
}

template <int CT>
int launch_encode(const int32_t* x, int L, const int32_t* row0, const int32_t* counts,
                  const int64_t* init, int B, int C, const int64_t* offsets, uint8_t* out,
                  int64_t* sizes, uint16_t* recs, int emit, cudaStream_t s) {
  if (emit) {
    rice_emit_kernel<CT><<<B, kEmitThreads, 0, s>>>(x, L, row0, counts, C, offsets, out, recs);
  } else {
    const int G = kChainRows / C;  // blocks a warp
    rice_chain_kernel<CT>
        <<<(B + G - 1) / G, kChainThreads, 0, s>>>(x, L, row0, counts, init, B, C, sizes, recs);
  }
  return (int)cudaGetLastError();
}

template <int CT>
__global__ void __launch_bounds__(32)
rice_decode_kernel(const uint8_t* __restrict__ stream, int64_t nwords,
                   const int64_t* __restrict__ bit_offsets, int W,
                   const int32_t* __restrict__ counts, const int64_t* __restrict__ init, int C,
                   int n_max, int32_t* __restrict__ out, uint8_t* __restrict__ bad) {
  constexpr int kCap = CT > 0 ? CT : kMaxChannels;
  __shared__ uint32_t ring[kRingSlots];
  __shared__ int32_t tile[kCap * kDecodeTile];
  const int b = blockIdx.x;
  const bool flagged =
      decode_block<CT>(CudaWarp{(int)threadIdx.x}, stream, nwords, bit_offsets[b], W, counts[b],
                       n_max, C, init + (int64_t)b * C, out + (int64_t)b * C * n_max, ring, tile);
  if (threadIdx.x == 0) bad[b] = flagged;
}

template <int CT>
int launch_decode(const uint8_t* stream, int64_t nwords, const int64_t* bit_offsets, int W,
                  const int32_t* counts, const int64_t* init, int B, int C, int n_max,
                  int32_t* out, uint8_t* bad, cudaStream_t s) {
  rice_decode_kernel<CT>
      <<<B, 32, 0, s>>>(stream, nwords, bit_offsets, W, counts, init, C, n_max, out, bad);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() as an int
// (0 = cudaSuccess); it neither allocates nor synchronizes.
extern "C" {

// K8 over B blocks of the (R, L) int32 rows x: block b's channels are rows
// row0[b] .. row0[b] + C - 1, its first counts[b] samples, its initial
// parameters init[b * C ..]. emit 0 (the count) writes each payload's size
// in bytes to sizes and every symbol's record to recs (B * L * C uint16,
// block b's at (b * L + s) * C + c); emit 1 reads the records and writes
// each payload at out + offsets[b] (4-byte aligned), zero-padded to a
// whole word.
int sla_rice_encode_blocks(const int32_t* x, int L, const int32_t* row0, const int32_t* counts,
                           const int64_t* init, int B, int C, const int64_t* offsets,
                           uint8_t* out, int64_t* sizes, uint16_t* recs, int emit, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 1)
    return launch_encode<1>(x, L, row0, counts, init, B, C, offsets, out, sizes, recs, emit, s);
  if (C == 2)
    return launch_encode<2>(x, L, row0, counts, init, B, C, offsets, out, sizes, recs, emit, s);
  return launch_encode<0>(x, L, row0, counts, init, B, C, offsets, out, sizes, recs, emit, s);
}

// K9 over B blocks of the stream's nwords big-endian words (the last one
// zero): block b's payload starts at bit bit_offsets[b]; W is the group's
// window width in words (the cursor limit). Writes the (B * C, n_max) rows
// (row b * C + c is block b's channel c) and bad[b] (0 or 1). The cursor
// counts 32 bits: n_max * C * 103 + 31 must stay below 2^31.
int sla_rice_decode_blocks(const uint8_t* stream, int64_t nwords, const int64_t* bit_offsets,
                           int W, const int32_t* counts, const int64_t* init, int B, int C,
                           int n_max, int32_t* out, uint8_t* bad, void* stream_) {
  cudaStream_t s = (cudaStream_t)stream_;
  if (C == 1)
    return launch_decode<1>(stream, nwords, bit_offsets, W, counts, init, B, C, n_max, out, bad, s);
  if (C == 2)
    return launch_decode<2>(stream, nwords, bit_offsets, W, counts, init, B, C, n_max, out, bad, s);
  return launch_decode<0>(stream, nwords, bit_offsets, W, counts, init, B, C, n_max, out, bad, s);
}

}  // extern "C"
