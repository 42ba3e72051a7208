// The entropy coder's two CUDA kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (sla_tpu_torch/kernels/build.py,
// sla_tpu_torch/kernels/cuda_entropy.py). The per-block code lives in
// entropy.cuh.
//
// K8 `rice_encode_blocks_kernel` replaces sla_tpu/rice_device.py
// rice_encode_parts (a lax.scan under XLA, not a Pallas kernel) together
// with the host pack after it (native sla_pack_parts): it writes each
// COMPRESSDATA block's byte-aligned payload itself, so only payload bytes
// cross PCIe, not the TPU's 32 bytes of (value, length) parts per residual.
// K9 `rice_decode_blocks_kernel` replaces rice_device.py rice_decode_blocks
// (a lax.scan): it reads the whole stream where it lies on the card and
// writes the (blocks x channels, n_max) synthesis rows directly.
//
// Design. Blocks are independent bitstreams, but inside a block every
// symbol's bit position depends on all symbols before it (the channels
// interleave in one stream), and the parameters adapt per symbol. So one
// thread owns one block and walks its symbols in stream order, with the
// C channels' parameters in registers (C is a template argument for mono
// and stereo), in 32-bit arithmetic (the fixed-point parameters stay below
// 2^32; only 119 p takes a wide multiply). K8 runs its body twice: a count
// pass writes each block's payload size, the host takes an exclusive sum
// (4-byte aligned offsets), and an emit pass writes the bits MSB-first
// through a 64-bit accumulator as big-endian words. K9 reads through a
// 64-bit bit reservoir refilled a word at a time, the next word loaded one
// refill ahead, so no load sits on the cursor's chain.
//
// What bounds them on this card is not the work: a symbol is 37-97 int32
// operations on its path (chip_smoke.py ENTROPY_OPS) and moves 4 bytes of
// residual and a byte or two of payload, and both kernels run at under 1 % of
// that bound. A clip's launch has about a thousand blocks, so with one
// warp a CTA its 32-odd CTAs fill about 32 of the 132 SMs and leave 100
// idle, and a warp's time is one block's chain of dependent symbols. The
// first candidates for its cost: occupancy (a warp alone on its SM, nothing
// to hide the chain), and divergence (each warp serialises 32 independent
// bitstreams along data-dependent stage-0, stage-1 and escape branches, and
// K9 stores to 32 different rows a symbol). chip_smoke.py times each kernel
// at 1 block (one lane) and 32 (a whole warp) to tell them apart.
#include <cuda_runtime.h>
#include <stdint.h>

#include "entropy.cuh"

namespace {

// one warp a CTA: a thousand blocks make some 32 CTAs, one warp on each of
// 32 SMs, the other SMs idle
constexpr int kThreads = 32;

template <int CT, bool EMIT>
__global__ void __launch_bounds__(kThreads)
rice_encode_blocks_kernel(const int32_t* __restrict__ x, int L, const int32_t* __restrict__ row0,
                          const int32_t* __restrict__ counts, const int64_t* __restrict__ init,
                          int B, int C, const int64_t* __restrict__ offsets,
                          uint8_t* __restrict__ out, int64_t* __restrict__ sizes) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const int32_t* rows = x + (int64_t)row0[b] * L;
  uint32_t* dst = EMIT ? reinterpret_cast<uint32_t*>(out + offsets[b]) : nullptr;
  const int64_t bits =
      sla::rice::encode_block<CT, EMIT>(rows, L, C, counts[b], init + (int64_t)b * C, dst);
  if (!EMIT) sizes[b] = (bits + 7) >> 3;
}

template <int CT>
int launch_encode(const int32_t* x, int L, const int32_t* row0, const int32_t* counts,
                  const int64_t* init, int B, int C, const int64_t* offsets, uint8_t* out,
                  int64_t* sizes, int emit, cudaStream_t s) {
  const dim3 g((unsigned)((B + kThreads - 1) / kThreads));
  if (emit) {
    rice_encode_blocks_kernel<CT, true>
        <<<g, kThreads, 0, s>>>(x, L, row0, counts, init, B, C, offsets, out, sizes);
  } else {
    rice_encode_blocks_kernel<CT, false>
        <<<g, kThreads, 0, s>>>(x, L, row0, counts, init, B, C, offsets, out, sizes);
  }
  return (int)cudaGetLastError();
}

template <int CT>
__global__ void __launch_bounds__(kThreads)
rice_decode_blocks_kernel(const uint8_t* __restrict__ stream, int64_t nwords,
                          const int64_t* __restrict__ bit_offsets, int W,
                          const int32_t* __restrict__ counts, const int64_t* __restrict__ init,
                          int B, int C, int n_max, int32_t* __restrict__ out,
                          uint8_t* __restrict__ bad) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const int64_t bp = bit_offsets[b];
  const int64_t limit = ((bp >> 5) + W) * 32;
  const sla::rice::StreamWords sw{stream, nwords};
  bad[b] = sla::rice::decode_block<CT>(sw, bp, limit, counts[b], n_max, C, init + (int64_t)b * C,
                                      out + (int64_t)b * C * n_max);
}

template <int CT>
int launch_decode(const uint8_t* stream, int64_t nwords, const int64_t* bit_offsets, int W,
                  const int32_t* counts, const int64_t* init, int B, int C, int n_max,
                  int32_t* out, uint8_t* bad, cudaStream_t s) {
  const dim3 g((unsigned)((B + kThreads - 1) / kThreads));
  rice_decode_blocks_kernel<CT>
      <<<g, kThreads, 0, s>>>(stream, nwords, bit_offsets, W, counts, init, B, C, n_max, out, bad);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() as an int
// (0 = cudaSuccess); it neither allocates nor synchronizes.
extern "C" {

// K8 over B blocks of the (R, L) int32 rows x: block b's channels are rows
// row0[b] .. row0[b] + C - 1, its first counts[b] samples, its initial
// parameters init[b * C ..]. emit 0 writes each payload's size in bytes to
// sizes; emit 1 writes each payload at out + offsets[b] (4-byte aligned),
// zero-padded to a whole word.
int sla_rice_encode_blocks(const int32_t* x, int L, const int32_t* row0, const int32_t* counts,
                           const int64_t* init, int B, int C, const int64_t* offsets,
                           uint8_t* out, int64_t* sizes, int emit, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 1) return launch_encode<1>(x, L, row0, counts, init, B, C, offsets, out, sizes, emit, s);
  if (C == 2) return launch_encode<2>(x, L, row0, counts, init, B, C, offsets, out, sizes, emit, s);
  return launch_encode<0>(x, L, row0, counts, init, B, C, offsets, out, sizes, emit, s);
}

// K9 over B blocks of the stream's nwords big-endian words (the last one
// zero): block b's payload starts at bit bit_offsets[b]; W is the group's
// window width in words (the cursor limit). Writes the (B * C, n_max) rows
// (row b * C + c is block b's channel c) and bad[b] (0 or 1).
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
