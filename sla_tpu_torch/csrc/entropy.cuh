// Bodies and schedules of the two entropy kernels (entropy.cu), written once
// as __host__ __device__ code: nvcc builds them into K8 and K9, and a host
// build (entropy_host.cpp, g++ -fwrapv) runs the same schedules on the CPU
// (K9's warp with its staging ring and output tile, K8's chain warp and its
// emit block with the scan), so the tests hold them against the plain
// PyTorch scans (sla_tpu_torch/rice_device.py) and the host coder without a
// card. The pattern is filters.cuh's HostLanes / WarpLanes: a Warp or Cta
// type holds one thread on the card (kCount 1) and all of them in the host
// build (kCount 32 or the block's size), whose loops run them one after
// another between the sync() points.
//
// Semantics are the reference coder's (src/SLACoder.c, as sla_tpu/rice.py
// and sla_tpu/rice_device.py state them): two fixed-point parameters per
// channel with 8 fraction bits, adapted per symbol as
// p <- (119 p + u32(9 * u32(code << 8)) + 64) >> 7; the Rice parameter
// roundup_pow2(max(round(p / 2), 1)) with the x86 masking of the shift
// count (an h - 1 of 2^31 or more gives k = 1); a unary run capped at 16,
// past which the tail quotient escapes to an Elias-gamma code; symbols
// channel-interleaved, sample-major and channel-minor.
#pragma once

#include <stdint.h>

#ifndef SLA_HD
#if defined(__CUDACC__)
#define SLA_HD __host__ __device__ __forceinline__
#define SLA_UNROLL _Pragma("unroll")
#else
#define SLA_HD inline
#define SLA_UNROLL
#endif
#endif

namespace sla {
namespace rice {

constexpr int kFrac = 8;
constexpr uint64_t kHalf = 1u << (kFrac - 1);
constexpr int kQuotThreshold = 16;  // CODER_QUOTPART_THRESHOLD
constexpr int kMaxChannels = 8;     // SLA_MAX_CHANNELS
// the longest symbol: a unary run of 16 and its one, a gamma code of 2 x 32
// - 1 digits, a remainder of 23 bits
constexpr int kMaxSymbolBits = kQuotThreshold + 1 + 63 + 23;

SLA_HD int clz32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __clz((int)x);  // __clz(0) == 32
#else
  return x ? __builtin_clz(x) : 32;  // __builtin_clz(0) is undefined
#endif
}

SLA_HD uint32_t bswap32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(x, 0, 0x0123);
#else
  return __builtin_bswap32(x);
#endif
}

// the top 32 bits of (hi:lo) << (sh & 31), as SHF.L.W masks its count
SLA_HD uint32_t funnel_l(uint32_t lo, uint32_t hi, int sh) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_l(lo, hi, sh);
#else
  return (uint32_t)(((((uint64_t)hi << 32) | lo) << (sh & 31)) >> 32);
#endif
}

// the top k bits of w, k in [0, 31]: 0 for k = 0, where PTX's shr clamps
// the count of 32 (C++ shifts by 31 - k after one)
SLA_HD uint32_t top_bits(uint32_t w, int k) {
#if defined(__CUDA_ARCH__)
  uint32_t r;
  asm("shr.u32 %0, %1, %2;" : "=r"(r) : "r"(w), "r"(32 - k));
  return r;
#else
  return (w >> 1) >> (31 - k);
#endif
}

SLA_HD uint32_t zigzag(int32_t v) { return ((uint32_t)v << 1) ^ (uint32_t)(v >> 31); }

SLA_HD int32_t unzigzag(uint32_t u) { return (int32_t)((u >> 1) ^ (0u - (u & 1u))); }

// The fixed-point parameters fit 32 bits: PARAMETER_SET stores u32(init << 8),
// and an update of p < 2^32 gives less than 2^32 (its fixed point is under
// 2^29), so only 119 p needs 64 bits.
SLA_HD uint32_t param_init(int64_t init) { return (uint32_t)init << kFrac; }

// a * b + c in 64 bits: one IMAD.WIDE.U32 with a 64-bit addend on the card
SLA_HD uint64_t mad_wide(uint32_t a, uint32_t b, uint64_t c) {
#if defined(__CUDA_ARCH__)
  uint64_t d;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
#else
  return (uint64_t)a * b + c;
#endif
}

// The exponential-smoothing update; the 9 * (code << 8) term wraps to 32
// bits (rice.py param_update), so only code's low 32 bits matter. It wraps
// to a multiple of 2^8, so the + 64 stays inside 32 bits: the addend is one
// IMAD off the parameter's chain, which is one widening multiply-add and
// one shift.
SLA_HD uint32_t param_update(uint32_t p, uint32_t code) {
  const uint32_t addend = 9u * (code << kFrac) + 64u;
  return (uint32_t)(mad_wide(p, 119u, addend) >> 7);
}

// log2 of the stage's Rice parameter k = roundup_pow2(max(round(p/2), 1)),
// the shift count masked to 5 bits as x86 executes `1U << 32`. With
// p < 2^32, h - 1 < 2^23, so k <= 2^23. The max is not needed: h = 0
// gives h - 1 = 2^32 - 1 and (32 - 0) & 31 = 0, as h = 1 does.
SLA_HD int rice_bits(uint32_t p) {
  const uint32_t h = ((p >> 1) + (uint32_t)kHalf) >> kFrac;
  return (32 - clz32(h - 1)) & 31;
}

// -- the threads of a warp or a block, as the code of one thread sees them --

// HostWarp / HostCta hold every thread of a warp or a block, their loops
// over i running the threads in turn; on the card CudaWarp / CudaCta hold
// the calling thread alone. thread(i): the thread of the i-th slot. sync():
// the threads meet and their shared-memory writes become visible.
struct HostWarp {
  static constexpr int kCount = 32;
  int thread(int i) const { return i; }
  void sync() const {}
};

template <int N>
struct HostCta {
  static constexpr int kCount = N;
  int thread(int i) const { return i; }
  void sync() const {}
  // v[i] <- the sum of v over the threads before i; returns the sum of all
  uint32_t exclusive_scan(uint32_t* v, uint32_t*) const {
    uint32_t s = 0;
    for (int i = 0; i < N; ++i) {
      const uint32_t t = v[i];
      v[i] = s;
      s += t;
    }
    return s;
  }
};

#if defined(__CUDACC__)
struct CudaWarp {
  static constexpr int kCount = 1;
  int self;
  SLA_HD int thread(int) const { return self; }
  SLA_HD void sync() const {
#if defined(__CUDA_ARCH__)
    __syncwarp();
#endif
  }
};

template <int N>
struct CudaCta {
  static constexpr int kCount = 1;
  SLA_HD int thread(int) const {
#if defined(__CUDA_ARCH__)
    return threadIdx.x;
#else
    return 0;
#endif
  }
  SLA_HD void sync() const {
#if defined(__CUDA_ARCH__)
    __syncthreads();
#endif
  }
  // a shuffle scan within each warp, the warps' totals through `sums`
  // (N / 32 words of shared memory; the caller syncs before its next use)
  SLA_HD uint32_t exclusive_scan(uint32_t* v, uint32_t* sums) const {
#if defined(__CUDA_ARCH__)
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint32_t incl = v[0];
    SLA_UNROLL
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane == 31) sums[warp] = incl;
    __syncthreads();
    uint32_t before = 0, total = 0;
    SLA_UNROLL
    for (int w = 0; w < N / 32; ++w) {
      const uint32_t s = sums[w];
      before += w < warp ? s : 0u;
      total += s;
    }
    v[0] = before + incl - v[0];
    return total;
#else
    return 0;
#endif
  }
};
#endif

// The chain pass's three warps (K8): one walks the chains, one stages the
// residuals, one writes the records out. HostRoles runs the three roles one
// after another, each with all 32 lanes; on the card CudaRoles holds one
// thread of one warp.
struct HostRoles {
  using Warp = HostWarp;
  bool chain() const { return true; }
  bool stager() const { return true; }
  bool flusher() const { return true; }
  HostWarp warp() const { return {}; }
  void sync() const {}
};

#if defined(__CUDACC__)
struct CudaRoles {
  using Warp = CudaWarp;
  int warp_index, lane;
  SLA_HD bool chain() const { return warp_index == 0; }
  SLA_HD bool stager() const { return warp_index == 1; }
  SLA_HD bool flusher() const { return warp_index == 2; }
  SLA_HD CudaWarp warp() const { return CudaWarp{lane}; }
  SLA_HD void sync() const {
#if defined(__CUDA_ARCH__)
    __syncthreads();
#endif
  }
};
#endif

// -- K8: encode ---------------------------------------------------------------
//
// The only serial state is each channel's two parameters, and they depend on
// the residuals alone: stage 0 adapts to every u, stage 1 to u - k0 where
// u >= k0. So a chain pass walks each (block, channel) row once, one thread
// a row, and records per symbol the two Rice parameters' log2 (b0 | b1 << 5,
// 10 bits) together with each block's payload size; an emit pass then
// computes every symbol's code from u and its record, places it by an
// exclusive scan of the code lengths in stream order, and ORs it into
// shared-memory words that whole warps store.

// A symbol's code: len bits in all, the last n of them `tail` (the bits
// before the tail are zeros: the unary run's, the escape's 16).
struct Code {
  int len, n;
  uint64_t tail;
};

// One symbol of the two-stage recursive Rice code (rice.py
// put_recursive_rice) from its zigzag value u and its record: stage 0 is a
// one and log2(k0) bits of u; stage 1 a run of q + 1 zeros, a one and b1
// bits of u - k0; past a tail quotient of 15, the escape: 16 zeros, a one,
// the gamma code of q - 14 (ndigit - 1 zeros, its ndigit bits) and the b1
// bits. ndigit <= 32 - b1, so the tail takes at most 64 bits. All three
// forms are computed and selected, so neighbouring threads on different
// paths do not diverge (the escape's shift is masked where it is unused).
SLA_HD Code symbol_code(uint32_t u, uint32_t rec) {
  const int b0 = (int)(rec & 31), b1 = (int)(rec >> 5 & 31);
  const uint32_t k0 = 1u << b0;
  const uint32_t reduced = u - k0;
  const uint32_t q = reduced >> b1;  // tail_quot - 1
  const uint32_t rest = reduced & ((1u << b1) - 1);
  const uint32_t gamma = q - (kQuotThreshold - 2);
  const int nd = 32 - clz32(gamma);
  const uint64_t esc = ((uint64_t)1 << ((2 * nd - 1 + b1) & 63)) | ((uint64_t)gamma << b1) | rest;
  const bool stage1 = u >= k0, escape = q >= kQuotThreshold - 1;
  Code c;
  c.len = !stage1 ? 1 + b0 : !escape ? (int)q + 2 + b1 : kQuotThreshold + 2 * nd + b1;
  c.n = !stage1 ? 1 + b0 : !escape ? b1 + 1 : 2 * nd + b1;
  c.tail = !stage1 ? (uint64_t)(k0 | u) : !escape ? (uint64_t)((1u << b1) | rest) : esc;
  return c;
}

// One step of a channel's parameter chain on its symbol u: the record the
// code needs, and both parameters adapted.
SLA_HD uint32_t chain_step(uint32_t& pa, uint32_t& pb, uint32_t u) {
  const int b0 = rice_bits(pa), b1 = rice_bits(pb);
  const uint32_t k0 = 1u << b0;
  pa = param_update(pa, u);
  const uint32_t pb1 = param_update(pb, u - k0);
  pb = u >= k0 ? pb1 : pb;
  return (uint32_t)b0 | (uint32_t)b1 << 5;
}

// The chain pass: three warps a CTA over 32 / C blocks, one lane of the
// chain warp a (block, channel) row. The staging warp loads the rows'
// residuals into shared memory a tile of 64 samples ahead (coalesced
// loads, every row's in flight together) and the flushing warp writes the
// tile before's records out as whole blocks' runs in stream order, so the
// chains read and write shared memory only and neither memory job waits on
// the other. One barrier a tile.
constexpr int kChainRows = 32;
constexpr int kChainThreads = 96;
constexpr int kChainTile = 64;
constexpr int kChainPitch = kChainTile + 1;  // a lane's row, off the others' banks
constexpr int kStageInts = 2 * kChainRows * kChainPitch;
constexpr int kStageBatch = kChainRows;  // rows whose loads are in flight together
// a block's records in the tile, padded so that the blocks' lanes write
// different banks; two tiles
SLA_HD int rec_stride(int nc) { return kChainTile * nc + 2; }
constexpr int kRecTile = kChainRows * (kChainTile + 2);  // the most: C 1
constexpr int kRecShorts = 2 * kRecTile;

// Records: recs[(b * L + s) * C + c] (uint16), each block's symbols in
// stream order; sizes[b]: its payload in bytes. row_off, row_bits: 32 of
// shared memory.
template <int CT, class Roles>
SLA_HD void chain_blocks(const Roles& cta, int index, const int32_t* x, int L, const int32_t* row0,
                         const int32_t* counts, const int64_t* init, int B, int C,
                         int64_t* sizes, uint16_t* recs, int32_t* stage, uint16_t* rtile,
                         int64_t* row_off, int64_t* row_bits) {
  using Warp = typename Roles::Warp;
  constexpr int N = Warp::kCount;
  const Warp w = cta.warp();
  const int nc = CT > 0 ? CT : C;
  const int G = kChainRows / nc;
  const int first = index * G;
  const int nb = B - first < G ? B - first : G;
  const int rows = nb * nc;
  const int rs = rec_stride(nc);
  int n = 0;
  for (int g = 0; g < nb; ++g) n = counts[first + g] > n ? counts[first + g] : n;
  const int tiles = (n + kChainTile - 1) / kChainTile;

  // the staging warp's job, tile k into stage buffer k & 1, and the
  // flushing warp's, the records of tile k from record buffer k & 1 out
  auto stage_tile = [&](int k) {
    int32_t* dst = stage + (k & 1) * kChainRows * kChainPitch;
    const int s0 = k * kChainTile;
    for (int r0 = 0; r0 < rows; r0 += kStageBatch) {
      int32_t v[N][kStageBatch][2];
      for (int i = 0; i < N; ++i) {
        SLA_UNROLL
        for (int r = 0; r < kStageBatch; ++r) {
          SLA_UNROLL
          for (int h = 0; h < 2; ++h) {
            const int s = s0 + w.thread(i) + 32 * h;
            v[i][r][h] = r0 + r < rows && s < L ? x[row_off[r0 + r] + s] : 0;
          }
        }
      }
      for (int i = 0; i < N; ++i) {
        SLA_UNROLL
        for (int r = 0; r < kStageBatch; ++r) {
          SLA_UNROLL
          for (int h = 0; h < 2; ++h) {
            if (r0 + r < rows) dst[(r0 + r) * kChainPitch + w.thread(i) + 32 * h] = v[i][r][h];
          }
        }
      }
    }
  };
  auto flush_tile = [&](int k) {
    const uint16_t* src = rtile + (k & 1) * kRecTile;
    const int s0 = k * kChainTile;
    for (int g = 0; g < nb; ++g) {
      const int m = counts[first + g] - s0 < kChainTile ? counts[first + g] - s0 : kChainTile;
      uint16_t* dst = recs + ((int64_t)(first + g) * L + s0) * C;
      for (int i = 0; i < N; ++i) {
        for (int j = w.thread(i); j < m * nc; j += 32) dst[j] = src[g * rs + j];
      }
    }
  };

  if (cta.stager()) {
    for (int i = 0; i < N; ++i) {
      const int t = w.thread(i), g = t / nc;
      if (t < rows) row_off[t] = (int64_t)(row0[first + g] + t - g * nc) * L;
    }
  }
  cta.sync();
  if (cta.stager() && tiles) stage_tile(0);
  // the chain warp's lanes: parameters, samples, bits
  uint32_t pa[N], pb[N];
  int cnt[N];
  int64_t bits[N];
  for (int i = 0; i < N; ++i) {
    const int t = w.thread(i), g = t / nc;
    const bool live = cta.chain() && t < rows;
    pa[i] = pb[i] = live ? param_init(init[(int64_t)(first + g) * C + t - g * nc]) : 0;
    cnt[i] = live ? counts[first + g] : 0;
    bits[i] = 0;
  }
  cta.sync();
  for (int k = 0; k < tiles; ++k) {
    const int s0 = k * kChainTile;
    if (cta.chain()) {
      const int32_t* st = stage + (k & 1) * kChainRows * kChainPitch;
      for (int i = 0; i < N; ++i) {
        const int t = w.thread(i), g = t / nc;
        const int m = cnt[i] - s0 < kChainTile ? cnt[i] - s0 : kChainTile;
        if (m <= 0) continue;  // past the row's count, or no row
        uint16_t* rt = rtile + (k & 1) * kRecTile + g * rs + t - g * nc;
#if defined(__CUDA_ARCH__)
#pragma unroll 8
#endif
        for (int j = 0; j < m; ++j) {
          const uint32_t u = zigzag(st[t * kChainPitch + j]);
          const uint32_t rec = chain_step(pa[i], pb[i], u);
          bits[i] += symbol_code(u, rec).len;
          rt[j * nc] = (uint16_t)rec;
        }
      }
    }
    if (cta.stager() && k + 1 < tiles) stage_tile(k + 1);
    if (cta.flusher() && k) flush_tile(k - 1);
    cta.sync();
  }
  if (cta.flusher() && tiles) flush_tile(tiles - 1);
  if (cta.chain()) {
    for (int i = 0; i < N; ++i) row_bits[w.thread(i)] = bits[i];
  }
  cta.sync();
  if (cta.chain()) {
    for (int i = 0; i < N; ++i) {
      const int g = w.thread(i);
      if (g < nb) {
        int64_t total = 0;
        for (int c = 0; c < nc; ++c) total += row_bits[g * nc + c];
        sizes[first + g] = (total + 7) >> 3;
      }
    }
  }
}

// The emit pass: a block of 256 threads a COMPRESSDATA block, 4 symbols a
// thread, tiles of 1,024 symbols in stream order. Each tile: codes from u
// and the records, an exclusive scan of their lengths (the bit positions),
// the codes ORed into shared words after the previous tile's partial last
// word, the whole words stored big-endian, the partial one carried.
constexpr int kEmitThreads = 256;
constexpr int kEmitPer = 4;
constexpr int kEmitTile = kEmitThreads * kEmitPer;
constexpr int kEmitWords = (32 + kEmitTile * kMaxSymbolBits + 31) / 32 + 2;

SLA_HD void or_word(uint32_t* w, uint32_t v) {
#if defined(__CUDA_ARCH__)
  if (v) atomicOr(w, v);
#else
  *w |= v;
#endif
}

// ORs the n-bit `tail` (1 <= n <= 64) into the MSB-first words at bits
// [start, start + n); (start & 31) + n <= 95, so it spans three words at most
SLA_HD void or_code(uint32_t* words, uint32_t start, uint64_t tail, int n) {
  uint32_t* w = words + (start >> 5);
  const int end = (int)(start & 31) + n;
  if (end <= 64) {
    const uint64_t v = tail << (64 - end);
    or_word(w, (uint32_t)(v >> 32));
    or_word(w + 1, (uint32_t)v);
  } else {
    const int d = end - 64;  // 1 .. 31
    const uint64_t v = tail >> d;
    or_word(w, (uint32_t)(v >> 32));
    or_word(w + 1, (uint32_t)v);
    or_word(w + 2, (uint32_t)tail << (32 - d));
  }
}

// Block b's payload at out + offsets[b], zero-padded to a whole word.
// words: kEmitWords of shared memory; sums: kEmitThreads / 32.
template <int CT, class Cta>
SLA_HD void emit_block(const Cta& cta, int b, const int32_t* x, int L, const int32_t* row0,
                       const int32_t* counts, int C, const int64_t* offsets, uint8_t* out,
                       const uint16_t* recs, uint32_t* words, uint32_t* sums) {
  constexpr int N = Cta::kCount;
  const int nc = CT > 0 ? CT : C;
  const int n_sym = counts[b] * nc;
  const int32_t* xb = x + (int64_t)row0[b] * L;
  const uint16_t* rb = recs + (int64_t)b * L * C;
  uint32_t* dst = reinterpret_cast<uint32_t*>(out + offsets[b]);
  for (int i = 0; i < N; ++i) {
    for (int k = cta.thread(i); k < kEmitWords; k += kEmitThreads) words[k] = 0;
  }
  cta.sync();
  uint32_t carry = 0;  // bits of words[0] from the tiles before
  int64_t stored = 0;  // words stored
  for (int i0 = 0; i0 < n_sym; i0 += kEmitTile) {
    uint32_t before[N];
    Code code[N][kEmitPer];
    for (int i = 0; i < N; ++i) {
      before[i] = 0;
      SLA_UNROLL
      for (int v = 0; v < kEmitPer; ++v) {
        const int k = i0 + cta.thread(i) * kEmitPer + v;
        code[i][v] = {0, 0, 0};
        if (k < n_sym) {
          const int s = k / nc, c = k - s * nc;
          code[i][v] = symbol_code(zigzag(xb[(int64_t)c * L + s]), rb[k]);
        }
        before[i] += code[i][v].len;
      }
    }
    const uint32_t total = cta.exclusive_scan(before, sums);
    for (int i = 0; i < N; ++i) {
      uint32_t pos = carry + before[i];
      SLA_UNROLL
      for (int v = 0; v < kEmitPer; ++v) {
        pos += code[i][v].len;
        if (code[i][v].n) or_code(words, pos - code[i][v].n, code[i][v].tail, code[i][v].n);
      }
    }
    cta.sync();
    const uint32_t nbits = carry + total, full = nbits >> 5;
    for (int i = 0; i < N; ++i) {
      for (uint32_t k = cta.thread(i); k < full; k += kEmitThreads) {
        dst[stored + k] = bswap32(words[k]);
        words[k] = 0;
      }
    }
    cta.sync();
    if (full) {
      for (int i = 0; i < N; ++i) {
        if (cta.thread(i) == 0) {
          words[0] = words[full];
          words[full] = 0;
        }
      }
    }
    cta.sync();
    carry = nbits & 31;
    stored += full;
  }
  if (carry) {
    for (int i = 0; i < N; ++i) {
      if (cta.thread(i) == 0) dst[stored] = bswap32(words[0]);
    }
  }
}

// -- K9: decode ---------------------------------------------------------------
//
// Inside a block the cursor is serial: a symbol's length depends on
// parameters that depend on every value before it. So a warp decodes one
// block, its 32 lanes running the same cursor in step (one instruction
// stream a block, no divergence), and the lanes share the memory work: each
// stages one word of every 32 into a shared-memory ring ahead of the
// cursor, the word loaded one staging earlier, and each stores one sample
// of every row from a shared tile of 32 samples, so the cursor's chain
// meets only shared-memory reads. The cursor is a 32-bit bit count from the
// block's first word; its window is two words joined by a funnel shift. A
// sample's C symbols first take the common path as one branch-free block of
// code, so the next symbol's cursor issues beside this one's value and
// parameter updates; a sample where one symbol left that path (an escape or
// a flag) is decoded again exactly.

constexpr int kRingWords = 128;
constexpr int kRingMask = kRingWords - 1;
// slots 0 and 1 again after the last, so a window's three words need one
// masked index
constexpr int kRingSlots = kRingWords + 2;
constexpr int kDecodeTile = 32;
// samples decoded as one branch-free block of code (decode_block's U).
// entropy_probe.cu times 1, 2 and 4 at the main path's shape, eight warps
// an SM: 2 and 4 take 7 and 13 % longer than 1.
constexpr int kGroup = 1;

// words `samples` may read past the cursor's word: 103 bits a symbol and
// two words of window. The ring is refilled, 32 words at a time, while
// fewer lie ahead, tested once every few samples of 8 symbols or fewer (one
// sample of 8 channels, 4 stereo samples): the most it holds ahead is this
// and 31, 60 words, inside the 128.
SLA_HD int words_ahead(int samples, int nc) {
  return (samples * nc * kMaxSymbolBits + 31) / 32 + 3;
}

// word i of the stream, big-endian; indexes past it clamp to its last word,
// which the upload keeps zero
SLA_HD uint32_t stream_word(const uint8_t* bytes, int64_t nwords, int64_t i) {
  if (i > nwords - 1) i = nwords - 1;
  return bswap32(*reinterpret_cast<const uint32_t*>(bytes + 4 * i));
}

// bits [pos, pos + 32) of the ring
SLA_HD uint32_t ring_window(const uint32_t* ring, uint32_t pos) {
  const uint32_t* w = ring + ((pos >> 5) & kRingMask);
  return funnel_l(w[1], w[0], (int)(pos & 31));
}

// One symbol at bit `pos` (rice.py get_recursive_rice) on the common path:
// a unary run under 16 and an end within `lim` bits from the block's first
// word. Branch-free: it always advances the cursor and adapts the
// parameters, and returns whether the symbol was on that path; where it
// was not, the caller restores pos, p0 and p1 and takes decode_symbol.
// The cursor's chain: the window's ring index (a shift and a mask), three
// shared-memory loads, a funnel shift, the leading one's position (top =
// 31 - the run), the end. The stage-1 value wraps to 32 bits as the
// reference's uint64 does when cast.
SLA_HD bool common_symbol(const uint32_t* ring, uint32_t& pos, uint32_t lim, uint32_t& p0,
                          uint32_t& p1, int32_t& v) {
  const int b0 = rice_bits(p0), b1 = rice_bits(p1);
  const uint32_t* w = ring + ((pos >> 5) & kRingMask);
  const int o = (int)(pos & 31);
  const uint32_t hi = funnel_l(w[1], w[0], o), lo = funnel_l(w[2], w[1], o);
  const int top = 31 - clz32(hi);
  const bool stage1 = hi < 0x80000000u;  // a run of one zero or more
  const int kb = stage1 ? b1 : b0;
  const uint32_t end = pos + (uint32_t)(32 + kb) - (uint32_t)top;  // pos + run + 1 + kb
  const uint32_t rest = top_bits(funnel_l(lo, hi, 32 - top), kb);
  const uint32_t k0 = 1u << b0;
  const uint32_t val = stage1 ? k0 + ((uint32_t)(30 - top) << b1) + rest : rest;
  const uint32_t p1n = param_update(p1, val - k0);
  p0 = param_update(p0, val);
  p1 = stage1 ? p1n : p1;
  pos = end;
  v = unzigzag(val);
  return hi >= 0x10000u && end <= lim;
}

// One symbol at bit `pos`, exactly. Returns false for the reference's flag
// (sla_tpu/rice_device.py rice_decode_blocks): a unary run past 16, a gamma
// code of more than 32 digits, or an end past `lim`; the flagged symbol
// leaves the cursor and parameters as they were. Each run is counted in a
// 32-bit window, so 17 zeros and 32 gamma zeros decide the flag as the
// reference's 64-bit windows do.
SLA_HD bool decode_symbol(const uint32_t* ring, uint32_t& pos, uint32_t lim, uint32_t& p0,
                          uint32_t& p1, int32_t& v) {
  const uint32_t at = pos, s0 = p0, s1 = p1;
  if (common_symbol(ring, pos, lim, p0, p1, v)) return true;
  pos = at;
  p0 = s0;
  p1 = s1;
  const uint32_t hi = ring_window(ring, pos);
  if (hi >= 0x10000u || hi < 0x8000u) return false;  // past the limit, or a run past 16
  const int b0 = rice_bits(p0), b1 = rice_bits(p1);   // the escape: a run of 16
  const uint32_t g0 = pos + kQuotThreshold + 1;       // its gamma code
  const int gz = clz32(ring_window(ring, g0));
  if (gz > 31) return false;
  const uint32_t g_at = g0 + (uint32_t)gz + 1;
  const uint32_t qm1 = (kQuotThreshold - 2) + (1u << gz) + top_bits(ring_window(ring, g_at), gz);
  const uint32_t r_at = g_at + (uint32_t)gz;
  const uint32_t end = r_at + (uint32_t)b1;
  if (end > lim) return false;
  const uint32_t k0 = 1u << b0;
  const uint32_t val = k0 + (qm1 << b1) + top_bits(ring_window(ring, r_at), b1);
  p0 = param_update(p0, val);
  p1 = param_update(p1, val - k0);
  pos = end;
  v = unzigzag(val);
  return true;
}

// the next 32 words into the ring: each lane's word loaded at the previous
// staging, and the lane's word of the 32 after them loaded now
template <class Warp>
SLA_HD void stage_words(const Warp& warp, uint32_t* ring, uint32_t* pend, int& staged,
                        const uint8_t* stream, int64_t nwords, int64_t base) {
  for (int i = 0; i < Warp::kCount; ++i) {
    const int l = warp.thread(i), slot = (staged + l) & kRingMask;
    ring[slot] = pend[i];
    if (slot < kRingSlots - kRingWords) ring[kRingWords + slot] = pend[i];
    pend[i] = stream_word(stream, nwords, base + staged + 32 + l);
  }
  staged += 32;
  warp.sync();
}

// One block's payload from bit bp of the stream: C rows of n_max samples at
// out + c * n_max, row c's first `count` samples decoded, the rest 0.
// Returns `bad`; decoding stops at the flagged symbol, which and whose
// successors read 0 (the caller re-decodes a bad block on the host). W is
// the group's window width in words: the cursor limit is W * 32 bits from
// the block's first word. ring: kRingSlots, tile: kDecodeTile x C, shared.
// U samples at a time go through the common path as one block of code
// (U > 1 only where C is known at compile time, CT > 0, and C <= 2).
template <int CT, int U = kGroup, class Warp>
SLA_HD bool decode_block(const Warp& warp, const uint8_t* stream, int64_t nwords, int64_t bp,
                         int64_t W, int count, int n_max, int C, const int64_t* init, int32_t* out,
                         uint32_t* ring, int32_t* tile) {
  constexpr int kCap = CT > 0 ? CT : kMaxChannels;
  const int nc = CT > 0 ? CT : C;
  uint32_t p0[kCap], p1[kCap];
  for (int c = 0; c < nc; ++c) p0[c] = p1[c] = param_init(init[c]);
  const int64_t base = bp >> 5;
  uint32_t pos = (uint32_t)(bp & 31);
  const uint32_t lim = W * 32 < 0x7fffffff ? (uint32_t)(W * 32) : 0x7fffffffu;
  uint32_t pend[Warp::kCount];
  for (int i = 0; i < Warp::kCount; ++i) pend[i] = stream_word(stream, nwords, base + warp.thread(i));
  int staged = 0;  // the ring holds words [staged - kRingWords, staged)
  stage_words(warp, ring, pend, staged, stream, nwords, base);
  stage_words(warp, ring, pend, staged, stream, nwords, base);
  static_assert(U >= 1 && kDecodeTile % U == 0 && (U == 1 || (CT > 0 && CT <= 2)),
                "U samples a block of code");
  const int S = U * nc < 8 ? 8 / (U * nc) : 1;  // groups between tests of the ring's fill
  const int ahead = words_ahead(U * S, nc);
  bool bad = false;
  for (int s0 = 0; s0 < n_max; s0 += kDecodeTile) {
    const int n_tile = n_max - s0 < kDecodeTile ? n_max - s0 : kDecodeTile;
    int done = 0;  // symbols of the tile decoded, in stream order
    const int m = count - s0 < n_tile ? count - s0 : n_tile;
    for (int j = 0; j < m && !bad;) {
      while (staged - (int)(pos >> 5) < ahead) {
        stage_words(warp, ring, pend, staged, stream, nwords, base);
      }
      const int j_end = j + U * S < m ? j + U * S : m;
      while (j < j_end && !bad) {
        // U samples' symbols on the common path, one block of code the
        // compiler can interleave (the next symbol's cursor beside this one's
        // value); where one left it, or fewer than U samples remain before
        // the next test of the ring's fill, one sample exactly, symbol by
        // symbol
        const uint32_t at = pos;
        uint32_t q0[kCap], q1[kCap];
        for (int c = 0; c < nc; ++c) {
          q0[c] = p0[c];
          q1[c] = p1[c];
        }
        if (j + U <= j_end) {
          int32_t v[U][kCap];
          bool common = true;
          SLA_UNROLL
          for (int g = 0; g < U; ++g) {
            SLA_UNROLL
            for (int c = 0; c < kCap; ++c) {
              if (CT == 0 && c >= nc) break;
              common &= common_symbol(ring, pos, lim, p0[c], p1[c], v[g][c]);
            }
          }
          if (common) {
            SLA_UNROLL
            for (int g = 0; g < U; ++g) {
              SLA_UNROLL
              for (int c = 0; c < kCap; ++c) {
                if (CT == 0 && c >= nc) break;
                tile[c * kDecodeTile + j + g] = v[g][c];
              }
            }
            done += U * nc;
            j += U;
            continue;
          }
          pos = at;
          for (int c = 0; c < nc; ++c) {
            p0[c] = q0[c];
            p1[c] = q1[c];
          }
        }
        for (int c = 0; c < nc; ++c) {
          int32_t v;
          if (!decode_symbol(ring, pos, lim, p0[c], p1[c], v)) {
            bad = true;
            break;
          }
          tile[c * kDecodeTile + j] = v;
          ++done;
        }
        ++j;
      }
    }
    warp.sync();
    for (int c = 0; c < nc; ++c) {
      for (int i = 0; i < Warp::kCount; ++i) {
        const int l = warp.thread(i);
        if (l < n_tile) out[(int64_t)c * n_max + s0 + l] = l * nc + c < done ? tile[c * kDecodeTile + l] : 0;
      }
    }
    warp.sync();
  }
  return bad;
}

}  // namespace rice
}  // namespace sla
