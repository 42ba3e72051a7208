// Bodies of the two entropy kernels (entropy.cu), written once as
// __host__ __device__ code: nvcc builds them into K8 and K9, and a host build
// (entropy_host.cpp, g++ -fwrapv) runs the same code on the CPU, so the tests
// hold it against the plain PyTorch scans (sla_tpu_torch/rice_device.py)
// and the host coder without a card.
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

SLA_HD int clz32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __clz((int)x);  // __clz(0) == 32
#else
  return x ? __builtin_clz(x) : 32;  // __builtin_clz(0) is undefined
#endif
}

SLA_HD int clz64(uint64_t x) {
#if defined(__CUDA_ARCH__)
  return __clzll((long long)x);  // __clzll(0) == 64
#else
  return x ? __builtin_clzll(x) : 64;
#endif
}

SLA_HD uint32_t bswap32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(x, 0, 0x0123);
#else
  return __builtin_bswap32(x);
#endif
}

SLA_HD uint32_t zigzag(int32_t v) { return ((uint32_t)v << 1) ^ (uint32_t)(v >> 31); }

SLA_HD int32_t unzigzag(uint32_t u) { return (int32_t)((u >> 1) ^ (0u - (u & 1u))); }

// The fixed-point parameters fit 32 bits: PARAMETER_SET stores u32(init << 8),
// and an update of p < 2^32 gives less than 2^32 (its fixed point is under
// 2^29), so only 119 p needs 64 bits.
SLA_HD uint32_t param_init(int64_t init) { return (uint32_t)init << kFrac; }

// The exponential-smoothing update; the 9 * (code << 8) term wraps to 32
// bits (rice.py param_update), so only code's low 32 bits matter.
SLA_HD uint32_t param_update(uint32_t p, uint32_t code) {
  const uint32_t term = 9u * (code << kFrac);
  return (uint32_t)(((uint64_t)p * 119u + term + 64u) >> 7);
}

// log2 of the stage's Rice parameter k = roundup_pow2(max(round(p/2), 1)),
// the shift count masked to 5 bits as x86 executes `1U << 32`. With
// p < 2^32, h - 1 < 2^23, so k <= 2^23.
SLA_HD int rice_bits(uint32_t p) {
  uint32_t h = ((p >> 1) + (uint32_t)kHalf) >> kFrac;
  if (h < 1) h = 1;
  return (32 - clz32(h - 1)) & 31;
}

// -- K8: encode ---------------------------------------------------------------

// Big-endian 32-bit words out, MSB first; put() takes at most 32 bits.
struct WordWriter {
  uint32_t* out;
  uint64_t acc = 0;  // pending bits, right-aligned (fewer than 32 between puts)
  int n = 0;
  int64_t words = 0;

  SLA_HD explicit WordWriter(uint32_t* o) : out(o) {}
  SLA_HD void put(uint32_t v, int len) {  // v < 2^len, len <= 32
    acc = (acc << len) | v;
    n += len;
    if (n >= 32) {
      n -= 32;
      out[words++] = bswap32((uint32_t)(acc >> n));
    }
  }
  // the last bits, zero-padded to a whole word
  SLA_HD void flush() {
    if (n > 0) out[words++] = bswap32((uint32_t)(acc << (32 - n)));
    n = 0;
  }
};

// One symbol of the two-stage recursive Rice code (rice.py
// put_recursive_rice): stage 0 always adapts to u; stage 1 adapts to
// u - k0 where it is reached. Emits the unary run (quot zeros, a 1), for
// an escape the gamma code of tail_quot - 16 (ndigit - 1 zeros, then the
// ndigit bits of gv + 1; gv + 1 < 2^32, so ndigit <= 32), then the
// remainder's log2(k) bits. Returns the symbol's bit count. Every value
// fits 32 bits: q = tail_quot - 1 = (u - k0) >> b1.
template <bool EMIT>
SLA_HD int encode_symbol(uint32_t& pa, uint32_t& pb, uint32_t u, WordWriter& w) {
  const int b0 = rice_bits(pa);
  const uint32_t k0 = 1u << b0;
  pa = param_update(pa, u);
  if (u < k0) {
    if (EMIT) {
      w.put(1, 1);
      w.put(u & (k0 - 1), b0);
    }
    return 1 + b0;
  }
  const int b1 = rice_bits(pb);
  const uint32_t reduced = u - k0;
  pb = param_update(pb, reduced);
  const uint32_t q = reduced >> b1;  // k1 = 2^b1
  const uint32_t rest = reduced & ((1u << b1) - 1);
  if (q < kQuotThreshold - 1) {  // tail_quot = q + 1 < 16
    if (EMIT) {
      w.put(1, (int)q + 2);
      w.put(rest, b1);
    }
    return (int)q + 2 + b1;
  }
  const uint32_t gamma = q - (kQuotThreshold - 2);  // tail_quot - 16 + 1
  const int ndigit = 32 - clz32(gamma);
  if (EMIT) {
    w.put(1, kQuotThreshold + 1);
    w.put(0, ndigit - 1);
    w.put(gamma, ndigit);
    w.put(rest, b1);
  }
  return kQuotThreshold + 1 + 2 * ndigit - 1 + b1;
}

// One block's payload: C rows of n residuals at x + c * stride, coded
// sample-major and channel-minor from the initial parameters init[0..C).
// EMIT writes the payload's words at `out`, zero-padded to a whole word;
// both forms return the payload's bit count. CT > 0 fixes the channel
// count at compile time (the parameters stay in registers).
template <int CT, bool EMIT>
SLA_HD int64_t encode_block(const int32_t* x, int64_t stride, int C, int n, const int64_t* init,
                            uint32_t* out) {
  constexpr int kCap = CT > 0 ? CT : kMaxChannels;
  const int nc = CT > 0 ? CT : C;
  uint32_t pa[kCap], pb[kCap];
  for (int c = 0; c < nc; ++c) pa[c] = pb[c] = param_init(init[c]);
  WordWriter w(out);
  int64_t bits = 0;
  for (int s = 0; s < n; ++s) {
    SLA_UNROLL
    for (int c = 0; c < kCap; ++c) {
      if (CT == 0 && c >= nc) break;
      bits += encode_symbol<EMIT>(pa[c], pb[c], zigzag(x[c * stride + s]), w);
    }
  }
  if (EMIT) w.flush();
  return bits;
}

// -- K9: decode ---------------------------------------------------------------

// The stream's bytes as big-endian 32-bit words; word indexes clamp to the
// last word, which the upload keeps zero.
struct StreamWords {
  const uint8_t* bytes;
  int64_t nwords;

  SLA_HD uint32_t word(int64_t i) const {
    if (i > nwords - 1) i = nwords - 1;
    return bswap32(*reinterpret_cast<const uint32_t*>(bytes + 4 * i));
  }
};

// A payload read MSB first through a 64-bit reservoir: `buf` holds `n`
// valid bits, left-aligned, zeros below them. refill() adds a word whenever
// 32 bits or fewer remain, so at least 33 are valid after it; the word it
// adds was loaded one refill earlier (`ahead`), so the load's latency hides
// behind the symbols decoded in between instead of sitting on the cursor's
// chain.
struct BitReader {
  StreamWords sw;
  uint64_t buf;
  int n;
  int64_t next;  // the index of the word in `ahead`
  uint32_t ahead;

  SLA_HD BitReader(const StreamWords& s, int64_t bp) : sw(s) {
    const int64_t wi = bp >> 5;
    const int off = (int)(bp & 31);
    buf = (((uint64_t)sw.word(wi) << 32) | sw.word(wi + 1)) << off;
    n = 64 - off;
    next = wi + 2;
    ahead = sw.word(next);
  }
  SLA_HD void refill() {
    if (n <= 32) {
      buf |= (uint64_t)ahead << (32 - n);
      n += 32;
      ahead = sw.word(++next);
    }
  }
  SLA_HD uint32_t top(int k) const { return k ? (uint32_t)(buf >> (64 - k)) : 0u; }  // k <= 32
  SLA_HD void skip(int k) {  // k <= 32 <= n
    buf <<= k;
    n -= k;
  }
};

// One block's payload from bit bp of the stream: C rows of n_max samples at
// out + c * n_max, row c's first `count` samples decoded (rice.py
// get_recursive_rice, channel-interleaved), the rest 0. Returns `bad`: the
// reference's flag (sla_tpu/rice_device.py rice_decode_blocks), set by a
// unary run past 16, a gamma code of more than 32 digits, or a cursor past
// `limit` (the block's first word plus the group's window width, in bits).
// Valid streams never set it. Decoding stops at the first such symbol and
// the block's remaining samples read 0; the caller re-decodes a bad block
// on the host, so its rows are never used. On an unflagged block every
// value and parameter update equals the host coder's. Each read below has
// at least 33 valid bits after its refill, which decides every flag as the
// reference's 64-bit windows do: a run of 17 zeros or 32 gamma zeros shows
// within them.
template <int CT>
SLA_HD bool decode_block(const StreamWords& sw, int64_t bp, int64_t limit, int count, int n_max,
                         int C, const int64_t* init, int32_t* out) {
  constexpr int kCap = CT > 0 ? CT : kMaxChannels;
  const int nc = CT > 0 ? CT : C;
  uint32_t p0[kCap], p1[kCap];
  for (int c = 0; c < nc; ++c) p0[c] = p1[c] = param_init(init[c]);
  BitReader r(sw, bp);
  bool bad = false;
  for (int s = 0; s < n_max; ++s) {
    SLA_UNROLL
    for (int c = 0; c < kCap; ++c) {
      if (CT == 0 && c >= nc) break;
      int32_t v = 0;
      if (s < count && !bad) {
        const int b0 = rice_bits(p0[c]), b1 = rice_bits(p1[c]);
        r.refill();
        const int quot = clz64(r.buf);  // the zero run
        bool ok = quot <= kQuotThreshold;
        uint64_t quot_u = quot;
        if (ok) {
          r.skip(quot + 1);
          bp += quot + 1;
          if (quot == kQuotThreshold) {  // gamma escape: gz zeros, a one, gz bits
            r.refill();
            const int gz = clz64(r.buf);
            ok = gz <= 31;
            if (ok) {
              r.skip(gz + 1);
              r.refill();
              quot_u += (1ull << gz) + r.top(gz) - 1;
              r.skip(gz);
              bp += 2 * gz + 1;
            }
          }
        }
        if (ok) {
          const int kb = quot ? b1 : b0;
          r.refill();
          const uint32_t rest = r.top(kb);
          r.skip(kb);
          bp += kb;
          ok = bp <= limit;
          if (ok) {
            const uint32_t k0 = 1u << b0;
            // stage 1: the reference's uint64 value, wrapped to 32 bits
            const uint32_t val =
                quot ? (uint32_t)(k0 + ((uint64_t)1 << b1) * (quot_u - 1) + rest) : rest;
            p0[c] = param_update(p0[c], val);
            if (quot) p1[c] = param_update(p1[c], val - k0);
            v = unzigzag(val);
          }
        }
        bad = !ok;
      }
      out[(int64_t)c * n_max + s] = v;
    }
  }
  return bad;
}

}  // namespace rice
}  // namespace sla
