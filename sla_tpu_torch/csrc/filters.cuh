// Bodies and schedules of the seven filter kernels (filters.cu), written
// once as __host__ __device__ code: nvcc builds them into the CUDA kernels,
// and a host build (filters_host.cpp, g++ -fwrapv) runs the same code on the
// CPU, K1's, K5's and K7's lanes and K2-K4's and K6's tile pipelines included, so
// the tests can hold it against the plain PyTorch versions without a card.
//
// Semantics are the reference's (src/SLAPredictor.c), as sla_tpu's scan
// twins state them (sla_tpu/kernels/{emphasis,lattice,lms,longterm}.py):
// wrapping int32 arithmetic, Q15 stage products (c*v + 2^14) >> 15, the
// long-term sum in int64, and the LMS step sign(r) * (bit_length(|r|) >> 1).
//
// Signed overflow is undefined in C++, so every int32 add, subtract and
// multiply goes through uint32_t (wadd/wsub/wmul); converting back to
// int32_t wraps modulo 2^32 on gcc and nvcc. `>>` of a negative int32 or
// int64 is relied on to be an arithmetic shift, as it is on gcc and nvcc
// (and as the reference C code assumes).
//
// Orders: a template argument N > 0 fixes an order at compile time, so the
// loops over it unroll and the filter state stays in registers; N == 0
// takes the order at run time, up to the caps below (EncoderConfig's
// maxima, sla_tpu/encoder.py:65-69), with the state in local memory (K1's
// run-time coefficients and carries: a 384-byte stack frame). A run-time
// order of 0 is a passthrough, as in the reference.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define SLA_HD __host__ __device__ __forceinline__
#define SLA_UNROLL _Pragma("unroll")
#else
#define SLA_HD inline
#define SLA_UNROLL
#endif

namespace sla {

constexpr int kMaxParcor = 48;
constexpr int kMaxLms = 40;
constexpr int kMaxTaps = 5;
constexpr int kEmphasisShift = 5;  // PRE_EMPHASIS_SHIFT
constexpr int kEmphasisCoef = (1 << kEmphasisShift) - 1;  // 31

SLA_HD int32_t wadd(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
SLA_HD int32_t wsub(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }
SLA_HD int32_t wmul(int32_t a, int32_t b) { return (int32_t)((uint32_t)a * (uint32_t)b); }
SLA_HD int32_t wrap64(int64_t v) { return (int32_t)(uint32_t)(uint64_t)v; }

// (c*v + 2^14) >> 15 in wrapping int32, the lattice stage product
SLA_HD int32_t qmul(int32_t c, int32_t v) { return wadd(wmul(c, v), 1 << 14) >> 15; }

SLA_HD int32_t sgn(int32_t v) { return (v > 0) - (v < 0); }

// |v| as uint32: INT32_MIN gives 2^31, the reference's bit pattern
SLA_HD uint32_t magnitude(int32_t v) { return v < 0 ? 0u - (uint32_t)v : (uint32_t)v; }

SLA_HD int32_t bit_length(uint32_t m) {
#if defined(__CUDA_ARCH__)
  return 32 - __clz((int)m);  // __clz(0) == 32
#else
  return m ? 32 - __builtin_clz(m) : 0;  // __builtin_clz(0) is undefined
#endif
}

// y[n] = x[n] - ((x[n-1] * 31) >> 5); prev is x[n-1] (0 at the row start)
struct PreEmphasis {
  int32_t prev = 0;
  SLA_HD int32_t operator()(int32_t x) {
    const int32_t y = wsub(x, wmul(prev, kEmphasisCoef) >> kEmphasisShift);
    prev = x;
    return y;
  }
};

// y[n] = x[n] + ((y[n-1] * 31) >> 5), zero state
struct DeEmphasis {
  int32_t prev = 0;
  SLA_HD int32_t operator()(int32_t x) {
    prev = wadd(x, wmul(prev, kEmphasisCoef) >> kEmphasisShift);
    return prev;
  }
};

// PARCOR lattice synthesis from zero state. coef: c[1..p]. (The predict
// direction is K1's stencil below.)
template <int P>
struct Lattice {
  static constexpr int kCap = P > 0 ? P : kMaxParcor;
  int p;
  int32_t c[kCap];
  int32_t b[kCap + 1];

  SLA_HD Lattice(const int32_t* coef, int p_rt) : p(P > 0 ? P : p_rt) {
    const int n = P > 0 ? P : p;
    SLA_UNROLL
    for (int k = 0; k < n; ++k) {
      c[k] = coef[k];
      b[k] = 0;
    }
    b[n] = 0;
  }

  // stages p..1: f += q(c[k], b[k-1]); b[k] = b[k-1] - q(c[k], f)
  SLA_HD int32_t operator()(int32_t x) {
    const int n = P > 0 ? P : p;
    int32_t f = x;
    SLA_UNROLL
    for (int k = n - 1; k >= 0; --k) {
      f = wadd(f, qmul(c[k], b[k]));
      b[k + 1] = wsub(b[k], qmul(c[k], f));
    }
    b[0] = f;
    return f;
  }
};

// -- K1: the lattice predict as a stencil over samples -----------------------
//
// The predict lattice has no feedback: at sample n stage k reads b_k[n-1],
// which is a function of the input alone (b_k[n] reads e[n-k .. n], e the
// pre-emphasized input), so y[n] depends only on x[n-p-1 .. n] and the
// samples of a row can be computed in parallel. A warp walks a row in
// chunks of 32 lanes x V samples, lane l owning samples base + V*l ..
// base + V*l + V-1, and computes a chunk stage by stage: within a stage a
// lane's V samples are independent, and the one value that crosses lanes is
// b_k at the sample before a lane's first, its left neighbour's last (lane
// 0: the previous chunk's last, kept in carry[k]). Nothing is re-associated:
// every (stage, sample) value comes from the same operands by the same
// operations as the sequential lattice; only the order differs.

// The lanes of one warp as the code of one thread sees them. On the card
// (WarpLanes) a thread holds one lane and rotate() is a shuffle; the host
// build (HostLanes) holds all 32 lanes of a warp in arrays and moves the
// values between them, so the CPU tests run the kernels' lane schedule.
// rotate<W>(v): within each group of W lanes (lanes g W .. g W + W - 1),
// lane l receives the value of the lane before it, and the group's first
// lane that of its last; W = 32 rotates the whole warp (lane 0 gets lane
// 31's). rotate_back<W>(v): the other direction, lane l receives the value
// of the lane after it and the group's last lane that of its first.
// lane(i): the lane of the i-th value this thread holds. sync(): the warp's
// lanes meet, and their shared-memory writes become visible to each other
// (the host build runs its lanes one after another already).
struct HostLanes {
  static constexpr int kCount = 32;
  int lane(int i) const { return i; }
  template <int W = 32>
  void rotate(int32_t* v) const {
    for (int g = 0; g < 32; g += W) {
      const int32_t last = v[g + W - 1];
      for (int l = W - 1; l > 0; --l) v[g + l] = v[g + l - 1];
      v[g] = last;
    }
  }
  template <int W = 32>
  void rotate_back(int32_t* v) const {
    for (int g = 0; g < 32; g += W) {
      const int32_t first = v[g];
      for (int l = 0; l < W - 1; ++l) v[g + l] = v[g + l + 1];
      v[g + W - 1] = first;
    }
  }
  void sync() const {}
};

#if defined(__CUDACC__)
struct WarpLanes {
  static constexpr int kCount = 1;
  int self;
  SLA_HD int lane(int) const { return self; }
  template <int W = 32>
  SLA_HD void rotate(int32_t* v) const {
#if defined(__CUDA_ARCH__)
    v[0] = __shfl_sync(0xffffffffu, v[0], (self & ~(W - 1)) | ((self + W - 1) & (W - 1)));
#endif
  }
  template <int W = 32>
  SLA_HD void rotate_back(int32_t* v) const {
#if defined(__CUDA_ARCH__)
    v[0] = __shfl_sync(0xffffffffu, v[0], (self & ~(W - 1)) | ((self + 1) & (W - 1)));
#endif
  }
  SLA_HD void sync() const {
#if defined(__CUDA_ARCH__)
    __syncwarp();
#endif
  }
};
#endif

// One chunk of a row through pre-emphasis (when EMPH) and the predict
// lattice. f[i][j]: sample j of the i-th lane this thread holds, in place,
// input in, output out. c: the p coefficients; carry[k]: b_k at the sample
// before the chunk; emph: the input sample before the chunk. Both are
// updated to the chunk's last sample, and only the holder of lane 0 keeps
// them (the other lanes' copies are not read).
template <int P, bool EMPH, int V, class Lanes>
SLA_HD void lattice_chunk(const Lanes& lanes, int32_t (&f)[Lanes::kCount][V], const int32_t* c,
                          int32_t* carry, int32_t& emph, int p_rt) {
  constexpr int N = Lanes::kCount;
  const int p = P > 0 ? P : p_rt;
  int32_t t[N];
  if (EMPH) {
    for (int i = 0; i < N; ++i) t[i] = f[i][V - 1];
    lanes.rotate(t);
    for (int i = 0; i < N; ++i) {
      PreEmphasis pre{lanes.lane(i) == 0 ? emph : t[i]};
      SLA_UNROLL
      for (int j = 0; j < V; ++j) f[i][j] = pre(f[i][j]);
    }
    for (int i = 0; i < N; ++i)
      if (lanes.lane(i) == 0) emph = t[i];
  }
  int32_t b[N][V];  // b_k, from b_0 = e
  for (int i = 0; i < N; ++i) {
    SLA_UNROLL
    for (int j = 0; j < V; ++j) b[i][j] = f[i][j];
  }
  SLA_UNROLL
  for (int k = 0; k < p; ++k) {
    // f_{k+1}[n] = f_k[n] - q(c_k, b_k[n-1]); b_{k+1}[n] = b_k[n-1] - q(c_k, f_k[n])
    for (int i = 0; i < N; ++i) t[i] = b[i][V - 1];
    lanes.rotate(t);
    for (int i = 0; i < N; ++i) {
      const int32_t first = lanes.lane(i) == 0 ? carry[k] : t[i];
      SLA_UNROLL
      for (int j = V - 1; j >= 0; --j) {  // downwards: b[i][j - 1] is still b_k
        const int32_t bp = j > 0 ? b[i][j - 1] : first;
        const int32_t fo = f[i][j];
        f[i][j] = wsub(fo, qmul(c[k], bp));
        b[i][j] = wsub(bp, qmul(c[k], fo));
      }
    }
    for (int i = 0; i < N; ++i)
      if (lanes.lane(i) == 0) carry[k] = t[i];
  }
}

constexpr int kLaneSamples = 4;                    // K1: samples per lane and chunk
constexpr int kChunk = 32 * kLaneSamples;          // K1: samples per chunk
constexpr int kSegmentSpan = 8 * kChunk;           // K1: samples a warp walks, warm-up included

// K1's segment length at order p: the span less the warm-up, so that every
// segment but a row's last walks whole chunks.
SLA_HD int segment_length(int p) { return kSegmentSpan - p; }

// Lane samples n .. n + kLaneSamples - 1 of a row of L, 0 outside the row;
// one 16-byte load on the card where they are aligned and inside it.
SLA_HD void load_lane(const int32_t* row, int L, int n, int32_t* v) {
  static_assert(kLaneSamples == 4, "one int4 a lane");
#if defined(__CUDA_ARCH__)
  if (n >= 0 && n + 4 <= L && ((uintptr_t)(row + n) & 15) == 0) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(row + n));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    return;
  }
#endif
  SLA_UNROLL
  for (int j = 0; j < kLaneSamples; ++j) v[j] = n + j >= 0 && n + j < L ? row[n + j] : 0;
}

// Stores those of lane samples n .. n + kLaneSamples - 1 that lie in
// [lo, hi).
SLA_HD void store_lane(int32_t* row, int lo, int hi, int n, const int32_t* v) {
#if defined(__CUDA_ARCH__)
  if (n >= lo && n + 4 <= hi && ((uintptr_t)(row + n) & 15) == 0) {
    *reinterpret_cast<int4*>(row + n) = make_int4(v[0], v[1], v[2], v[3]);
    return;
  }
#endif
  SLA_UNROLL
  for (int j = 0; j < kLaneSamples; ++j)
    if (n + j >= lo && n + j < hi) row[n + j] = v[j];
}

// K1 on one segment of one row: outputs [start, start + seg) of the L
// samples x, into y. The warp starts from zero state exactly p samples
// before `start`, with the pre-emphasis seeded by the sample before those,
// and discards the p outputs of that warm-up: after p samples every b_k is
// exact. Before the row start the input reads as 0, which keeps the zero
// state (q(c, 0) = 0), so a segment at the row start needs no special case.
template <int P, bool EMPH, class Lanes>
SLA_HD void lattice_segment(const Lanes& lanes, const int32_t* x, int32_t* y, int L, int start,
                            int seg, const int32_t* coef, int p_rt) {
  constexpr int N = Lanes::kCount, V = kLaneSamples, kCap = P > 0 ? P : kMaxParcor;
  const int p = P > 0 ? P : p_rt;
  int32_t c[kCap], carry[kCap];
  SLA_UNROLL
  for (int k = 0; k < p; ++k) {
    c[k] = coef[k];
    carry[k] = 0;
  }
  const int n0 = start - p;
  const int end = L - start < seg ? L : start + seg;
  int32_t emph = n0 >= 1 ? x[n0 - 1] : 0;
  for (int base = n0; base < end; base += kChunk) {
    int32_t f[N][V];
    for (int i = 0; i < N; ++i) load_lane(x, L, base + V * lanes.lane(i), f[i]);
    lattice_chunk<P, EMPH, V>(lanes, f, c, carry, emph, p);
    for (int i = 0; i < N; ++i) store_lane(y, start, end, base + V * lanes.lane(i), f[i]);
  }
}

// Sum of t[0..count) as a balanced tree of wrapping adds, in place. N > 0
// fixes the count at compile time (the loops unroll, t stays in registers).
template <int N>
SLA_HD int32_t tree_sum(int32_t* t, int count) {
  const int c = N > 0 ? N : count;
  if (c <= 0) return 0;
  SLA_UNROLL
  for (int lvl = 0; lvl < 7; ++lvl) {  // 2^7 > 2 * kMaxLms terms
    const int w = 1 << lvl;
    if (w >= c) break;
    SLA_UNROLL
    for (int i = 0; i + w < (N > 0 ? N : 2 * kMaxLms); i += 2 * w) {
      if (i + w < c) t[i] = wadd(t[i], t[i + w]);
    }
  }
  return t[0];
}

// Sign-sign LMS, predict or synthesize, from zero state; the first M samples
// are warmup (no adaptation, the buffers fill newest-first). TREE = false
// keeps the serial dot product, for the tests only.
template <int M, bool SYNTH, bool TREE = true>
struct Lms {
  static constexpr int kCap = M > 0 ? M : kMaxLms;
  int m;
  int32_t t = 0;
  int32_t fc[kCap], ic[kCap], xb[kCap], pb[kCap];

  SLA_HD explicit Lms(int m_rt) : m(M > 0 ? M : m_rt) {
    const int n = M > 0 ? M : m;
    SLA_UNROLL
    for (int i = 0; i < n; ++i) fc[i] = ic[i] = xb[i] = pb[i] = 0;
  }

  SLA_HD int32_t operator()(int32_t x) {
    const int n = M > 0 ? M : m;
    if (n == 0) return x;
    int32_t acc;
    if (TREE) {
      // A balanced tree of wrapping adds: the same bits as the serial sum
      // (int32 addition wraps mod 2^32, so any order gives them), at depth
      // log2(2M) instead of 2M. The newest history terms (index 0, the
      // previous sample's output) join last, so the rest of the tree does
      // not wait for that sample.
      int32_t prod[2 * kCap];
      SLA_UNROLL
      for (int i = 1; i < n; ++i) {
        prod[2 * (i - 1)] = wmul(fc[i], xb[i]);
        prod[2 * (i - 1) + 1] = wmul(ic[i], pb[i]);
      }
      const int32_t rest = tree_sum<(M > 0 ? 2 * (M - 1) : 0)>(prod, 2 * (n - 1));
      acc = wadd(wadd(512, rest), wadd(wmul(fc[0], xb[0]), wmul(ic[0], pb[0])));
    } else {
      acc = 512;
      for (int i = 0; i < n; ++i) acc = wadd(acc, wmul(fc[i], xb[i]));
      for (int i = 0; i < n; ++i) acc = wadd(acc, wmul(ic[i], pb[i]));
    }
    const int32_t pred = acc >> 10;
    const bool warm = t < n;
    // the step reads the residual: the output when predicting, the input
    // when synthesizing; the buffers take the signal sample
    const int32_t out = SYNTH ? wadd(x, pred) : wsub(x, pred);
    const int32_t res = SYNTH ? x : out;
    const int32_t sample = SYNTH ? out : x;
    if (!warm) {
      const int32_t step = sgn(res) * (bit_length(magnitude(res)) >> 1);
      SLA_UNROLL
      for (int i = 0; i < n; ++i) {
        fc[i] = wadd(fc[i], step * sgn(xb[i]));
        ic[i] = wadd(ic[i], step * sgn(pb[i]));
      }
    }
    SLA_UNROLL
    for (int i = n - 1; i > 0; --i) {
      xb[i] = xb[i - 1];
      pb[i] = pb[i - 1];
    }
    xb[0] = sample;
    pb[0] = warm ? sample : pred;
    t = wadd(t, 1);
    return warm ? x : out;
  }
};

// lattice synthesize -> de-emphasis (when EMPH), one sample after another:
// K3's lattice role
template <int P, bool EMPH>
struct LatticeSynth {
  Lattice<P> lattice;
  DeEmphasis de;
  SLA_HD LatticeSynth(const int32_t* coef, int p) : lattice(coef, p) {}
  SLA_HD int32_t operator()(int32_t x, int) {
    const int32_t out = lattice(x);
    return EMPH ? de(out) : out;
  }
};

// LMS as a step: K3's first stage, K2's and K4's last
template <int M, bool SYNTH, bool TREE = true>
struct LmsStep {
  Lms<M, SYNTH, TREE> lms;
  SLA_HD explicit LmsStep(int m) : lms(m) {}
  SLA_HD int32_t operator()(int32_t x, int) { return lms(x); }
};
template <int M>
using LmsSynth = LmsStep<M, true>;

// -- K2, K3 and K4 as pipelines over tiles -----------------------------------
//
// A block holds kGroup rows and walks their samples in tiles of kTile; a
// sequential stage runs one row per lane, a sample-parallel one (the FIR,
// K4's stage 1) lanes over samples. Stages that do not feed an earlier
// stage run on different warps and hand tiles to each other through shared
// memory; the tile each role works on at iteration `it` is fixed by its lag
// below, and every role meets the others at one barrier per iteration. The
// structs here hold the shared-memory layout and the per-tile work; the
// same code runs in the CUDA kernels (filters.cu, one or more warps per
// role, concurrently) and in the host build (filters_host.cpp, role after
// role), so the CPU tests exercise tile edges, ring wrap-around and the
// slot arithmetic. Only the hand-off (cp.async, the barrier) is card-only.

constexpr int kGroup = 32;                        // rows per block
constexpr int kTile = 64;                         // samples per tile
constexpr int kTilePitch = kTile + 1;             // lane r, column j: bank (r + j) % 32
constexpr int kTileWords = kGroup * kTilePitch;
constexpr int kRing = 512;                        // history ring per row
constexpr int kRingMask = kRing - 1;
constexpr int kRingPitch = kRing + 1;             // lane r, slot n: bank (r + n) % 32
constexpr int kRingWords = kGroup * kRingPitch;
constexpr int kMaxDelay = 258;                    // LONGTERM_MAX_PERIOD + kMaxTaps / 2
constexpr int kBatch = 8;                         // long-term synth: loads before stores

// Samples in tile t of a row of L.
SLA_HD int tile_count(int t, int L) {
  const int left = L - t * kTile;
  return left < kTile ? left : kTile;
}

// Gives a per-sample step (x, n) -> y a whole-tile form.
template <class Step>
struct Tiled : Step {
  template <class... A>
  SLA_HD explicit Tiled(A... a) : Step(a...) {}
  SLA_HD void tile(const int32_t* in, int32_t* out, int n0, int count) {
    for (int j = 0; j < count; ++j) out[j] = (*this)(in[j], n0 + j);
  }
};

// K3's long-term synthesis over one row, its output history in a ring of
// kRing slots (sample n at n & kRingMask) in shared memory, not in device
// memory. md = max_delay (pitch + T/2), 0 for a row without the stage; q15
// = Q31 coefficient >> 16. Active from n >= md: pred from the stage's own
// OUTPUT at n - (md - j); a tap at or ahead of n contributes 0, as
// sla_tpu's scan twin drops it.
template <int T>
struct LongtermSynthRing {
  static constexpr int kCap = T > 0 ? T : kMaxTaps;
  int32_t* h;
  int md;
  int nt;
  int32_t q[kCap];

  SLA_HD LongtermSynthRing(int32_t* h_, int md_, const int32_t* q15, int nt_rt)
      : h(h_), md(md_), nt(T > 0 ? T : nt_rt) {
    const int n = T > 0 ? T : nt;
    SLA_UNROLL
    for (int j = 0; j < n; ++j) q[j] = q15[j];
  }

  SLA_HD int32_t pred(int n) const {
    const int taps = T > 0 ? T : nt;
    int64_t acc = 0;
    SLA_UNROLL
    for (int j = 0; j < taps; ++j) {
      const int back = md - j;
      if (back >= 1) acc += (int64_t)q[j] * h[(n - back) & kRingMask];
    }
    return wrap64((acc + (1 << 14)) >> 15);
  }

  SLA_HD void tile(const int32_t* in, int32_t* out, int n0, int count) {
    const int taps = T > 0 ? T : nt;
    if (md > 0 && md - taps + 1 >= kBatch) {
      // every tap reads at least kBatch samples back: a batch's history
      // loads go before its stores, off the store -> load chain
      for (int j0 = 0; j0 < count; j0 += kBatch) {
        int32_t v[kBatch];
        SLA_UNROLL
        for (int u = 0; u < kBatch; ++u) {
          const int n = n0 + j0 + u;
          v[u] = j0 + u < count ? in[j0 + u] : 0;
          if (j0 + u < count && n >= md) v[u] = wadd(v[u], pred(n));
        }
        SLA_UNROLL
        for (int u = 0; u < kBatch; ++u) {
          if (j0 + u < count) {
            h[(n0 + j0 + u) & kRingMask] = v[u];
            out[j0 + u] = v[u];
          }
        }
      }
    } else {
      for (int j = 0; j < count; ++j) {
        const int n = n0 + j;
        int32_t v = in[j];
        if (md > 0 && n >= md) v = wadd(v, pred(n));
        h[n & kRingMask] = v;
        out[j] = v;
      }
    }
  }
};

// -- K7: long-term synthesis in lag-sized steps, lanes over samples ---------
//
// Every live tap reads y[n - back] with back >= d = max(1, md - T + 1), so
// y[n .. n + d - 1] depend only on outputs before n: a warp walks its row
// in steps of c = min(d, kLtStep) samples and computes a step's samples in
// parallel, lane l owning samples n0 + l + 32 v (v < kLtLaneSamples; one
// sample a lane when c <= 32, two when c <= 64), then writes them to the row's ring and
// meets the other lanes (sync) before the next step reads them. Nothing is
// re-associated: every output is the same int64 sum of the same products as
// the sequential loop. Rows without the stage (md 0, or no taps) walk whole
// steps as a copy.
//
// The input reaches the ring in chunks of kLtStep samples, loaded into
// registers kLtAhead chunks ahead of the step that needs them (a ring slot
// holds x[n] until the step overwrites it with y[n]), so a step waits on
// shared memory and not on device memory, however short it is.
//
// A row with md <= kLtSerial (d at most 8, mostly 1) would take one short
// step per sample or few; one lane walks it instead (longterm_serial), its
// last kLtSerial outputs in registers and its delay a template argument, so
// a sample costs T multiply-adds, a shift and an add, and waits on no
// shared-memory round trip (the ring is read and written 8 samples at a
// time).

constexpr int kLtLaneSamples = 4;                  // K7: samples per lane and step
constexpr int kLtStep = 32 * kLtLaneSamples;       // K7: the largest step, and a chunk
constexpr int kLtRing = 1024;                      // K7: ring slots per row
constexpr int kLtRingMask = kLtRing - 1;
constexpr int kLtSerial = 8;                       // K7: the serial lane's register window
constexpr int kLtAhead = 2;                        // K7: chunks of input in flight
static_assert(kMaxDelay + 2 * kLtStep <= kLtRing,
              "a staged chunk would overwrite history a step reads");

// K7's step for a row: its smallest live lag, at most kLtStep.
SLA_HD int longterm_step(int md, int taps) {
  if (md <= 0 || taps <= 0) return kLtStep;
  const int d = md - taps + 1;
  return d < 1 ? 1 : d < kLtStep ? d : kLtStep;
}

// acc + a * b in int64 from two int32: one multiply-add on the card.
SLA_HD int64_t mad_wide(int32_t a, int32_t b, int64_t acc) {
#if defined(__CUDA_ARCH__)
  int64_t r;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(r) : "r"(a), "r"(b), "l"(acc));
  return r;
#else
  return acc + (int64_t)a * b;
#endif
}

// K7's taps of one row (md, q15 as in LongtermSynthRing).
template <int T>
struct LongtermTaps {
  static constexpr int kCap = T > 0 ? T : kMaxTaps;
  int md;
  int nt;
  int32_t q[kCap];

  SLA_HD LongtermTaps(int md_, const int32_t* q15, int nt_rt) : md(md_), nt(T > 0 ? T : nt_rt) {
    SLA_UNROLL
    for (int j = 0; j < kCap; ++j) q[j] = j < nt ? q15[j] : 0;
  }

  // the prediction at sample n >= md from the outputs in the ring
  SLA_HD int32_t pred(const int32_t* ring, int n) const {
    int64_t acc = 1 << 14;
    SLA_UNROLL
    for (int j = 0; j < kCap; ++j) {
      const int back = md - j;
      if (j < nt && back >= 1) acc = mad_wide(q[j], ring[(n - back) & kLtRingMask], acc);
    }
    return wrap64(acc >> 15);
  }
};

// Lane samples base + l + 32 u of a chunk, 0 past the row.
template <class Lanes>
SLA_HD void longterm_load(const Lanes& lanes, const int32_t* x, int L, int base,
                          int32_t (&v)[Lanes::kCount][kLtLaneSamples]) {
  for (int i = 0; i < Lanes::kCount; ++i) {
    SLA_UNROLL
    for (int u = 0; u < kLtLaneSamples; ++u) {
      const int n = base + lanes.lane(i) + 32 * u;
      v[i][u] = n < L ? x[n] : 0;
    }
  }
}

template <class Lanes>
SLA_HD void longterm_stage(const Lanes& lanes, int32_t* ring, int base,
                           const int32_t (&v)[Lanes::kCount][kLtLaneSamples]) {
  for (int i = 0; i < Lanes::kCount; ++i) {
    SLA_UNROLL
    for (int u = 0; u < kLtLaneSamples; ++u)
      ring[(base + lanes.lane(i) + 32 * u) & kLtRingMask] = v[i][u];
  }
}

// K7's parallel step: samples n0 .. n0 + count - 1, V a lane (count <=
// 32 V), in place in the ring (input in, output out) and to y.
template <int T, int V, class Lanes>
SLA_HD void longterm_lanes(const Lanes& lanes, const LongtermTaps<T>& lt, int32_t* ring, int32_t* y,
                           int n0, int count, bool reverse) {
  constexpr int N = Lanes::kCount;
  for (int k = 0; k < N; ++k) {
    const int i = reverse ? N - 1 - k : k;
    int32_t v[V];
    SLA_UNROLL
    for (int u = 0; u < V; ++u) {
      const int s = lanes.lane(i) + 32 * u, n = n0 + s;
      if (s < count) {
        v[u] = ring[n & kLtRingMask];
        if (lt.md > 0 && n >= lt.md) v[u] = wadd(v[u], lt.pred(ring, n));
      }
    }
    SLA_UNROLL
    for (int u = 0; u < V; ++u) {
      const int s = lanes.lane(i) + 32 * u, n = n0 + s;
      if (s < count) {
        ring[n & kLtRingMask] = v[u];
        y[n] = v[u];
      }
    }
  }
}

// K7's serial lane at delay MD <= kLtSerial: samples n0 .. n0 + kLtStep -
// 1, in place in the ring, the last kLtSerial outputs in w. Unrolled over
// blocks of kLtSerial samples: before sample k of a block, y[n - 1 - a]
// sits in w[(k - 1 - a) mod kLtSerial], and the sample writes its own over
// the oldest, w[k], so the window rotates by renaming and every tap's lag
// MD - j is a compile-time index. GATE: the step holds samples below MD,
// which pass through.
template <int MD, int T, bool GATE>
SLA_HD void longterm_serial(const LongtermTaps<T>& lt, int32_t* ring, int n0, int32_t* w) {
  constexpr int K = kLtSerial, kCap = LongtermTaps<T>::kCap;
  static_assert(MD >= 1 && MD <= K && K == 8 && kLtStep % K == 0,
                "lags within the window, whole blocks of two 16-byte ring accesses");
  for (int b0 = 0; b0 < kLtStep; b0 += K) {
    int32_t* blk = ring + ((n0 + b0) & kLtRingMask);  // n0 + b0 is a multiple of 8
    int32_t v[K];
#if defined(__CUDA_ARCH__)
    const int4 lo = reinterpret_cast<const int4*>(blk)[0], hi = reinterpret_cast<const int4*>(blk)[1];
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w, v[4] = hi.x, v[5] = hi.y, v[6] = hi.z,
    v[7] = hi.w;
#else
    for (int k = 0; k < K; ++k) v[k] = blk[k];
#endif
    SLA_UNROLL
    for (int k = 0; k < K; ++k) {
      int64_t acc = 1 << 14;
      SLA_UNROLL
      for (int j = kCap - 1; j >= 0; --j) {  // the newest output (lag MD - j) joins last
        if (j < lt.nt && MD - j >= 1) acc = mad_wide(lt.q[j], w[(k - (MD - j) + 2 * K) % K], acc);
      }
      if (!GATE || n0 + b0 + k >= MD) v[k] = wadd(v[k], wrap64(acc >> 15));
      w[k] = v[k];
    }
#if defined(__CUDA_ARCH__)
    reinterpret_cast<int4*>(blk)[0] = make_int4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<int4*>(blk)[1] = make_int4(v[4], v[5], v[6], v[7]);
#else
    for (int k = 0; k < K; ++k) blk[k] = v[k];
#endif
  }
}

// The serial lane at the row's delay md (MD .. kLtSerial).
template <int T, bool GATE, int MD = 1>
SLA_HD void longterm_serial_at(const LongtermTaps<T>& lt, int32_t* ring, int n0, int32_t* w) {
  if (lt.md == MD) return longterm_serial<MD, T, GATE>(lt, ring, n0, w);
  if constexpr (MD < kLtSerial) longterm_serial_at<T, GATE, MD + 1>(lt, ring, n0, w);
}

// K7 on one row of L samples, x -> y, with `ring` (kLtRing slots) for its
// staged input and output history. reverse runs the lanes of each step in
// reverse order (host build only; one lane a thread on the card): a lane
// that read a sample written in its own step would then read a stale slot.
template <int T, class Lanes>
SLA_HD void longterm_row(const Lanes& lanes, const int32_t* x, int32_t* y, int L, int32_t* ring,
                         int md, const int32_t* q15, int nt_rt, bool reverse) {
  constexpr int N = Lanes::kCount, V = kLtLaneSamples;
  const LongtermTaps<T> lt(md, q15, nt_rt);
  const bool serial = md > 0 && lt.nt > 0 && md <= kLtSerial;
  const int c = serial ? kLtStep : longterm_step(md, lt.nt);
  int32_t w[kLtSerial];
  SLA_UNROLL
  for (int k = 0; k < kLtSerial; ++k) w[k] = 0;
  int32_t ahead[kLtAhead][N][V];  // chunk k in ahead[k % kLtAhead] while in flight
  SLA_UNROLL
  for (int a = 0; a < kLtAhead; ++a) longterm_load(lanes, x, L, a * kLtStep, ahead[a]);
  int staged = 0;  // samples [0, staged) are in the ring
  for (int n0 = 0; n0 < L; n0 += c) {
    if (staged < n0 + c) {  // at most one chunk a step, since c <= kLtStep
      const int next = (staged / kLtStep) % kLtAhead;
      SLA_UNROLL
      for (int a = 0; a < kLtAhead; ++a) {  // a compile-time index: the chunks stay in registers
        if (a != next) continue;
        longterm_stage(lanes, ring, staged, ahead[a]);
        longterm_load(lanes, x, L, staged + kLtAhead * kLtStep, ahead[a]);
      }
      staged += kLtStep;
      lanes.sync();
    }
    const int count = L - n0 < c ? L - n0 : c;
    if (serial) {
      // one lane computes the step in the ring, then every lane stores it
      for (int i = 0; i < N; ++i) {
        if (lanes.lane(i) != 0) continue;
        if (n0 == 0) {
          longterm_serial_at<T, true>(lt, ring, n0, w);
        } else {
          longterm_serial_at<T, false>(lt, ring, n0, w);
        }
      }
      lanes.sync();
      for (int i = 0; i < N; ++i) {
        SLA_UNROLL
        for (int u = 0; u < V; ++u) {
          const int s = lanes.lane(i) + 32 * u;
          if (s < count) y[n0 + s] = ring[(n0 + s) & kLtRingMask];
        }
      }
    } else if (c <= 32) {
      longterm_lanes<T, 1>(lanes, lt, ring, y, n0, count, reverse);
    } else if (c <= 64) {
      longterm_lanes<T, 2>(lanes, lt, ring, y, n0, count, reverse);
    } else {
      longterm_lanes<T, V>(lanes, lt, ring, y, n0, count, reverse);
    }
    lanes.sync();
  }
}

// -- K5: the lattice synthesis as a systolic schedule, lanes over stages -----
//
// At sample n, stage k (from p - 1 down to 0) computes
//   f_k[n] = f_{k+1}[n] + q(c_k, b_k[n-1]),   b_{k+1}[n] = b_k[n-1] - q(c_k, f_k[n]),
// with f_p[n] = x[n] and b_0[n] = f_0[n], the output. The term q(c_k,
// b_k[n-1]) reads only the previous sample, so what one sample hands the
// next is a few instructions deep, not 8p: the stages can run side by side.
// A row takes G lanes of a warp, lane k holding the S stages kS .. kS + S - 1
// (G S >= p; a stage at or above p has c = 0, which is exactly the identity,
// q(0, v) = 0), and lane k works on sample n at step 2n + G - 1 - k. At step
// t lane k then needs f_{(k+1)S}[n] from lane k + 1 and b_{kS}[n-1] from lane
// k - 1, both made at step t - 1: every step each lane runs its stages once,
// then f moves down one lane (rotate_back) and b up one lane (rotate). The
// top lane takes x[n] in place of the f it receives, which is lane 0's f
// (rotate_back wraps within the group), and hands that f on in place of its
// own b, which no stage reads: it is b_0 of the sample lane 0 just made, and
// it reaches lane 0 again two steps later, just when lane 0 needs it. Lane
// 0's f is the output, and lane 0 runs the de-emphasis. A row gives a lane
// work every other step, so two rows share a group's lanes on opposite
// parities: row A (2g for group g) at steps 2n + G - 1 - k, row B (2g + 1)
// one step later. A warp holds 32 / G groups, 64 / G rows. Nothing is
// re-associated but wrapping int32 additions, which are exact in any order:
// every stage computes the values of the sequential Lattice from the same
// operands.
//
// The warp loads its rows' input kSysChunk samples a row at a time (32
// consecutive samples of one row per load) two chunks ahead of the steps and
// stages them into a two-chunk ring per row in shared memory, which the top
// lanes read one pair of steps ahead. Every lane de-emphasizes its f and
// writes it into two-chunk rings of its own, one per parity, at a slot that
// is the same for all lanes, so a step's store is one instruction and no
// branch; the warp stores the rings of each group's lane 0 to the rows a
// chunk at a time, once every row has passed it.

constexpr int kSysChunk = 32;                  // K5: samples a row per load and store
constexpr int kSysRing = 2 * kSysChunk;        // K5: slots of a ring, input or output
constexpr int kSysPitch = kSysRing + 1;        // input rings of different rows: other banks
constexpr int kSysLanePitch = 2 * kSysRing + 1;  // a lane's two output rings: other banks

// K5's rows per warp and shared-memory words per warp, at G lanes a row pair
template <int G>
struct SysShape {
  static_assert(G >= 2 && G <= 32 && (G & (G - 1)) == 0, "row pairs of 2, 4, .. 32 lanes");
  static constexpr int kRows = 64 / G;
  static constexpr int kWords = kRows * kSysPitch + 32 * kSysLanePitch;
};

// K5's configuration for the orders up to C: G lanes a row pair, S stages a
// lane; synth_config(p) is the C that takes order p, an order below C with
// its upper stages' coefficients 0. A step costs its shuffles and its chain
// whatever the order, so the fastest configuration of the whole kernel on
// the H100 (synth_probe.cu; PERF.md) takes every order up to 32, the
// presets' 8, 16 and 32 included.
template <int C>
struct SynthConfig;
template <>
struct SynthConfig<32> {
  static constexpr int G = 16, S = 2;
};
template <>
struct SynthConfig<48> {
  static constexpr int G = 16, S = 3;
};
SLA_HD int synth_config(int p) { return p <= 32 ? 32 : 48; }

// One row's stages kS .. kS + S - 1 in one lane.
template <int S>
struct SysStages {
  int32_t c[S];
  int32_t b[S];    // b[j] = b_{kS+j} of the row's previous sample, j >= 1 (b_{kS} comes in)
  int32_t de = 0;  // lane 0: the de-emphasis state

  // The stages on one sample: fin = f_{(k+1)S}[n], bin = b_{kS}[n-1].
  // Returns f_{kS}[n] and sets bout = b_{(k+1)S}[n].
  SLA_HD int32_t step(int32_t fin, int32_t bin, int32_t& bout) {
    int32_t m[S];
    SLA_UNROLL
    for (int j = 0; j < S; ++j) m[j] = qmul(c[j], j ? b[j] : bin);
    int32_t f = wadd(fin, m[S - 1]);
    bout = wsub(S > 1 ? b[S - 1] : bin, qmul(c[S - 1], f));
    int32_t upper = m[S - 1];  // m[S-1] + .. + m[1]: the output waits on bin's term alone
    SLA_UNROLL
    for (int j = S - 2; j >= 0; --j) {
      f = wadd(f, m[j]);
      b[j + 1] = wsub(j ? b[j] : bin, qmul(c[j], f));
      if (j) upper = wadd(upper, m[j]);
    }
    return S > 1 ? wadd(wadd(fin, upper), m[0]) : f;
  }
};

// K5 on the rows row0 .. row0 + 64/G - 1 (those below B) of the (B, L)
// rows x -> y, coefficients coef (B, p), with `smem` (SysShape<G>::kWords)
// for the warp's rings. reverse runs each step's lanes in reverse order
// (host build only; one lane a thread on the card): a lane that read a value
// written in its own step would then read another.
template <int G, int S, bool EMPH, class Lanes>
SLA_HD void lattice_synth_warp(const Lanes& lanes, const int32_t* x, int32_t* y, int B, int L,
                               int64_t row0, const int32_t* coef, int p, int32_t* smem,
                               bool reverse) {
  constexpr int N = Lanes::kCount, R = SysShape<G>::kRows, kMask = kSysRing - 1;
  int32_t* in = smem;  // row r, sample n at in[r * kSysPitch + (n & kMask)]
  // lane l's output at parity h for sample n at out[l * kSysLanePitch + h * kSysRing + (n & kMask)]
  int32_t* out = smem + R * kSysPitch;
  // per lane: the stages of the row it works on at even steps (h = 0) and at
  // odd steps (h = 1), those rows, and the values in flight
  SysStages<S> st[N][2];
  int row[N][2];
  int32_t fin[N], bin[N], xq[N][2];  // xq[i][h]: the top lane's x at parity h
  for (int i = 0; i < N; ++i) {
    const int l = lanes.lane(i), k = l % G, pair = 2 * (l / G);
    row[i][0] = pair + ((k & 1) ? 0 : 1);  // row A at even steps where k is odd
    row[i][1] = pair + ((k & 1) ? 1 : 0);
    SLA_UNROLL
    for (int h = 0; h < 2; ++h) {
      const int64_t r = row0 + row[i][h];
      SLA_UNROLL
      for (int j = 0; j < S; ++j) {
        const int s = k * S + j;
        st[i][h].c[j] = r < B && s < p ? coef[r * p + s] : 0;
        st[i][h].b[j] = 0;
      }
    }
    fin[i] = bin[i] = 0;
  }
  int32_t ahead[N][R];  // a chunk in flight: lane l holds sample l of each row
  const auto load = [&](int ch) {
    for (int i = 0; i < N; ++i) {
      const int n = ch * kSysChunk + lanes.lane(i);
      SLA_UNROLL
      for (int r = 0; r < R; ++r)
        ahead[i][r] = row0 + r < B && n < L ? x[(row0 + r) * L + n] : 0;
    }
  };
  const auto stage = [&](int ch) {
    for (int i = 0; i < N; ++i) {
      const int n = ch * kSysChunk + lanes.lane(i);
      SLA_UNROLL
      for (int r = 0; r < R; ++r) in[r * kSysPitch + (n & kMask)] = ahead[i][r];
    }
  };
  const auto store = [&](int ch) {  // row 2g + 1 (B) is lane gG's at even steps, 2g at odd
    for (int i = 0; i < N; ++i) {
      const int n = ch * kSysChunk + lanes.lane(i);
      SLA_UNROLL
      for (int r = 0; r < R; ++r) {
        const int at = (r / 2) * G * kSysLanePitch + ((r & 1) ? 0 : kSysRing) + (n & kMask);
        if (row0 + r < B && n < L) y[(row0 + r) * L + n] = out[at];
      }
    }
  };
  const int nchunks = (L + kSysChunk - 1) / kSysChunk;
  load(0);
  stage(0);
  load(1);
  lanes.sync();
  for (int i = 0; i < N; ++i) {
    SLA_UNROLL
    for (int h = 0; h < 2; ++h) xq[i][h] = in[row[i][h] * kSysPitch];
  }
  // chunk ch: steps 2u, 2u + 1 for u in [ch kSysChunk, (ch + 1) kSysChunk).
  // The top lanes take x[u] of both rows; lane 0 makes row B's sample u -
  // G/2 and row A's u + 1 - G/2, so chunk ch - 2 is complete, and one more
  // chunk than the rows hold completes the last.
  for (int ch = 0; ch <= nchunks; ++ch) {
    lanes.sync();  // the last chunk's steps are done with the slots below
    stage(ch + 1);
    if (ch >= 2) store(ch - 2);
    load(ch + 2);
    lanes.sync();
    for (int u = ch * kSysChunk; u < (ch + 1) * kSysChunk; ++u) {
      int32_t xn[N][2];  // the next pair's input, read a pair ahead
      for (int i = 0; i < N; ++i) {
        SLA_UNROLL
        for (int h = 0; h < 2; ++h) xn[i][h] = in[row[i][h] * kSysPitch + ((u + 1) & kMask)];
      }
      SLA_UNROLL
      for (int h = 0; h < 2; ++h) {
        int32_t fo[N], bo[N];
        for (int q = 0; q < N; ++q) {
          const int i = reverse ? N - 1 - q : q;
          const int k = lanes.lane(i) % G;
          int32_t bout;
          const int32_t f = st[i][h].step(k == G - 1 ? xq[i][h] : fin[i], bin[i], bout);
          fo[i] = f;
          bo[i] = k == G - 1 ? fin[i] : bout;
          // Lane 0's output, row B's sample u - G/2 at even steps, row A's
          // u + 1 - G/2 at odd ones. Every lane runs the de-emphasis and
          // the store: a branch here cost more than the step
          // (synth_probe.cu). A sample below 0 is 0, in the slot of sample
          // n + kSysRing, which the steps write before the warp stores it.
          int32_t v = f;
          if (EMPH) v = st[i][h].de = wadd(f, wmul(st[i][h].de, kEmphasisCoef) >> kEmphasisShift);
          out[lanes.lane(i) * kSysLanePitch + h * kSysRing + ((u + h - G / 2) & kMask)] = v;
        }
        lanes.template rotate_back<G>(fo);
        lanes.template rotate<G>(bo);
        for (int i = 0; i < N; ++i) {
          fin[i] = fo[i];
          bin[i] = bo[i];
        }
      }
      for (int i = 0; i < N; ++i) {
        xq[i][0] = xn[i][0];
        xq[i][1] = xn[i][1];
      }
    }
  }
  lanes.sync();
  if (nchunks >= 1) store(nchunks - 1);
}

// K2's and K4's long-term FIR residual at sample n of one row, from the
// row's INPUT ring: pred from x[n - (md - j)], active from n >= md; a tap at
// or ahead of n reads x[n], as sla_tpu's clamped slice does. It reads only
// the input, so every sample of a tile can be computed at once.
template <int T>
SLA_HD int32_t longterm_fir(const int32_t* h, int md, const int32_t* q, int nt, int n) {
  const int32_t x = h[n & kRingMask];
  if (md <= 0 || n < md) return x;
  const int taps = T > 0 ? T : nt;
  int64_t acc = 0;
  SLA_UNROLL
  for (int j = 0; j < (T > 0 ? T : kMaxTaps); ++j) {
    if (j < taps) {
      const int back = md - j;
      acc += (int64_t)q[j] * h[(n - (back > 0 ? back : 0)) & kRingMask];
    }
  }
  return wsub(x, wrap64((acc + (1 << 14)) >> 15));
}

// K3's pipeline. Iteration `it`:
//   the producer loads tile it of the residual into in[it % kInSlots]
//   LMS synth                     tile it - kLms:      in -> a
//   long-term synth               tile it - kLongterm: a  -> b (ring)
//   lattice synth + de-emphasis   tile it - kLattice:  b  -> o
//   the producer stores tile it - kStore from o.
// The producer's loads land one iteration after they are issued, so LMS
// reads a tile two iterations after its load; every other hand-off is one
// iteration, through two slots (one written, one read).
struct SynthPipe {
  static constexpr int kInSlots = 3, kLms = 2, kLongterm = 3, kLattice = 4, kStore = 5;
  static constexpr int kWords = kInSlots * kTileWords + 3 * 2 * kTileWords + kRingWords;
  int32_t* in;
  int32_t* a;
  int32_t* b;
  int32_t* o;
  int32_t* ring;
  int L, ntiles;

  SLA_HD SynthPipe(int32_t* smem, int L_)
      : in(smem), a(in + kInSlots * kTileWords), b(a + 2 * kTileWords),
        o(b + 2 * kTileWords), ring(o + 2 * kTileWords), L(L_),
        ntiles((L_ + kTile - 1) / kTile) {}

  SLA_HD int iterations() const { return ntiles + kStore; }
  SLA_HD int32_t* ring_row(int r) const { return ring + r * kRingPitch; }
  SLA_HD int32_t* load_dst(int t, int r, int j) const {
    return in + (t % kInSlots) * kTileWords + r * kTilePitch + j;
  }
  SLA_HD const int32_t* store_src(int t, int r, int j) const {
    return o + (t % 2) * kTileWords + r * kTilePitch + j;
  }

  // runs `step` on row r's part of the tile that lags `lag` behind `it`
  template <class Step>
  SLA_HD void stage(Step& step, int it, int lag, const int32_t* src, int src_slots,
                    int32_t* dst, int r) const {
    const int t = it - lag;
    if (t < 0 || t >= ntiles) return;
    step.tile(src + (t % src_slots) * kTileWords + r * kTilePitch,
              dst + (t % 2) * kTileWords + r * kTilePitch, t * kTile, tile_count(t, L));
  }
  template <class Step>
  SLA_HD void lms(Step& s, int it, int r) const { stage(s, it, kLms, in, kInSlots, a, r); }
  template <class Step>
  SLA_HD void longterm(Step& s, int it, int r) const { stage(s, it, kLongterm, a, 2, b, r); }
  template <class Step>
  SLA_HD void lattice(Step& s, int it, int r) const { stage(s, it, kLattice, b, 2, o, r); }
};

// The long-term FIR and LMS predict roles of K2 and K4, over a per-row ring
// of the stage-2 input (row r, sample n at ring[r][n & kRingMask]). Iteration
// `it`:
//   the FIR threads compute tile it - kFir:  ring -> res, sample-parallel
//   LMS predict                tile it - kLms:  res  -> o
//   the producer stores tile it - kStore from o.
// What fills the ring, kFirLag iterations ahead of the FIR, is the pipeline's
// own: K2's producer, K4's stage-1 role.
template <int kFirLag>
struct FirLms {
  static constexpr int kFir = kFirLag, kLms = kFirLag + 1, kStore = kFirLag + 2;
  static constexpr int kWords = kRingWords + 2 * 2 * kTileWords;
  int32_t* ring;
  int32_t* res;
  int32_t* o;
  int L, ntiles;

  SLA_HD FirLms(int32_t* smem, int L_)
      : ring(smem), res(ring + kRingWords), o(res + 2 * kTileWords), L(L_),
        ntiles((L_ + kTile - 1) / kTile) {}

  SLA_HD int iterations() const { return ntiles + kStore; }
  SLA_HD const int32_t* store_src(int t, int r, int j) const {
    return o + (t % 2) * kTileWords + r * kTilePitch + j;
  }

  // the FIR of row r, samples j0, j0 + step, ... of the tile lagging kFir
  template <int T>
  SLA_HD void fir(int it, int r, int j0, int step, int md, const int32_t* q, int nt) const {
    const int t = it - kFir;
    if (t < 0 || t >= ntiles) return;
    const int count = tile_count(t, L);
    int32_t* dst = res + (t % 2) * kTileWords + r * kTilePitch;
    for (int j = j0; j < count; j += step)
      dst[j] = longterm_fir<T>(ring + r * kRingPitch, md, q, nt, t * kTile + j);
  }
  template <class Step>
  SLA_HD void lms(Step& s, int it, int r) const {
    const int t = it - kLms;
    if (t < 0 || t >= ntiles) return;
    s.tile(res + (t % 2) * kTileWords + r * kTilePitch,
           o + (t % 2) * kTileWords + r * kTilePitch, t * kTile, tile_count(t, L));
  }
};

// K2's pipeline: the producer loads tile it straight into the ring. The
// ring holds the kMaxDelay samples before the FIR's tile, that tile, and
// the tiles the producer has loaded ahead of it.
struct Stage2Pipe : FirLms<2> {
  static_assert(kMaxDelay + (kFir + 1) * kTile <= kRing,
                "the producer would overwrite history the FIR still reads");
  SLA_HD Stage2Pipe(int32_t* smem, int L_) : FirLms<2>(smem, L_) {}
  SLA_HD int32_t* load_dst(int t, int r, int j) const {
    return ring + r * kRingPitch + ((t * kTile + j) & kRingMask);
  }
};

// K4's pipeline: K2's with stage 1 ahead of the FIR. Iteration `it`:
//   the producer loads tile it of x into xin[it % kInSlots]
//   stage 1 (pre-emphasis + lattice predict) tile it - kStage1: xin -> ring
//   the FIR, LMS predict and the producer's store as in FirLms<3>.
// The loads land one iteration after they are issued, so stage 1 reads a
// tile two iterations after its load (three slots: one loading, one landed,
// one read). The ring holds the kMaxDelay samples before the FIR's tile,
// that tile, and the tile stage 1 writes ahead of it. Stage 1 runs K1's
// lane schedule (lattice_chunk) on one row's tile at a time, 32 lanes x 2
// samples; each row's b_k carries and pre-emphasis seed stay in shared
// memory from one tile to the next, so no tile needs a warm-up.
struct EncodePipe : FirLms<3> {
  static constexpr int kInSlots = 3, kStage1 = 2;
  static constexpr int kLaneTile = kTile / 32;        // stage 1: samples per lane
  static constexpr int kCarryPitch = kMaxParcor + 1;  // b_0 .. b_{p-1} carries, the seed
  static constexpr int kWords = kInSlots * kTileWords + FirLms<3>::kWords + kGroup * kCarryPitch;
  static_assert(kMaxDelay + (kFir - kStage1 + 1) * kTile <= kRing,
                "stage 1 would overwrite history the FIR still reads");
  int32_t* xin;
  int32_t* carry;

  SLA_HD EncodePipe(int32_t* smem, int L_)
      : FirLms<3>(smem + kInSlots * kTileWords, L_), xin(smem),
        carry(smem + kInSlots * kTileWords + FirLms<3>::kWords) {}

  SLA_HD int32_t* load_dst(int t, int r, int j) const {
    return xin + (t % kInSlots) * kTileWords + r * kTilePitch + j;
  }
  // zero state for row r: words j0, j0 + step, ... of its carries
  SLA_HD void clear(int r, int j0, int step) const {
    for (int j = j0; j < kCarryPitch; j += step) carry[r * kCarryPitch + j] = 0;
  }

  // stage 1 of row r (coefficients coef) on the tile lagging kStage1
  template <int P, class Lanes>
  SLA_HD void stage1(const Lanes& lanes, int it, int r, const int32_t* coef, int p_rt) const {
    const int t = it - kStage1;
    if (t < 0 || t >= ntiles) return;
    constexpr int N = Lanes::kCount, V = kLaneTile, kCap = P > 0 ? P : kMaxParcor;
    const int p = P > 0 ? P : p_rt;
    const int count = tile_count(t, L);
    const int32_t* src = xin + (t % kInSlots) * kTileWords + r * kTilePitch;
    int32_t* keep = carry + r * kCarryPitch;
    int32_t f[N][V];
    for (int i = 0; i < N; ++i) {
      SLA_UNROLL
      for (int j = 0; j < V; ++j) {
        const int s = V * lanes.lane(i) + j;
        f[i][j] = s < count ? src[s] : 0;
      }
    }
    int32_t c[kCap], b[kCap];
    SLA_UNROLL
    for (int k = 0; k < p; ++k) {
      c[k] = coef[k];
      b[k] = keep[k];
    }
    int32_t emph = keep[kMaxParcor];
    lattice_chunk<P, true, V>(lanes, f, c, b, emph, p);
    if (lanes.lane(0) == 0) {
      SLA_UNROLL
      for (int k = 0; k < p; ++k) keep[k] = b[k];
      keep[kMaxParcor] = emph;
    }
    int32_t* dst = ring + r * kRingPitch;
    for (int i = 0; i < N; ++i) {
      SLA_UNROLL
      for (int j = 0; j < V; ++j) {
        const int s = V * lanes.lane(i) + j;
        if (s < count) dst[(t * kTile + s) & kRingMask] = f[i][j];
      }
    }
  }
};

// -- K6: LMS synthesis as a tile pipeline with a slim chain ------------------
//
// In synthesis the LMS step sign(x) * (bit_length(|x|) >> 1) reads only the
// input residual, so a prep role computes it for a whole tile, lanes over
// samples, before the chain needs it (0 for a row's first M samples, the
// warm-up). What is left on the chain per sample is the dot product, the
// output, the weight updates and the history.

// The chain at a compile-time order M (4 or 8). The sign of every history
// value is kept beside it, set once when the value enters, so each weight
// update is one multiply-add. The history is a ring of M slots walked in
// blocks of M samples, fully unrolled: before sample k of a block the value
// of age i (xb[i], pb[i] of Lms) sits in slot (k - 1 - i) mod M, and the
// sample writes its new values over the oldest, slot k. Every index is a
// compile-time constant, so the ring stays in registers and its rotation
// costs no moves. fc and ic are indexed by age, as in Lms. A tile holds
// kTile / M whole blocks, so every tile starts at slot 0.
template <int M>
struct LmsSynthChain {
  static_assert(M > 0 && kTile % M == 0 && M <= kTile, "a tile must hold whole blocks");
  int32_t fc[M], ic[M], xv[M], pv[M], xs[M], ps[M];

  SLA_HD explicit LmsSynthChain(int) {
    SLA_UNROLL
    for (int i = 0; i < M; ++i) fc[i] = ic[i] = xv[i] = pv[i] = xs[i] = ps[i] = 0;
  }

  SLA_HD static constexpr int slot(int k, int age) { return (k - 1 - age + 2 * M) % M; }

  // samples x[0 .. M) with their steps st[0 .. M) into out. WARM: the
  // row's first M samples, where the weights are still 0 (so pred is 0)
  // and the prediction history takes the sample.
  template <bool WARM>
  SLA_HD void block(const int32_t* x, const int32_t* st, int32_t* out) {
    SLA_UNROLL
    for (int k = 0; k < M; ++k) {
      // four accumulators over ages 1 .. M-1; age 0 (the previous sample's
      // output and prediction) joins last
      uint32_t acc[4] = {512u, 0u, 0u, 0u};
      SLA_UNROLL
      for (int i = 1; i < M; ++i) {
        const int s = slot(k, i);
        acc[(2 * i) & 3] += (uint32_t)fc[i] * (uint32_t)xv[s];
        acc[(2 * i + 1) & 3] += (uint32_t)ic[i] * (uint32_t)pv[s];
      }
      const int s0 = slot(k, 0);
      uint32_t sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      sum += (uint32_t)ic[0] * (uint32_t)pv[s0];
      sum += (uint32_t)fc[0] * (uint32_t)xv[s0];
      const int32_t pred = (int32_t)sum >> 10;
      const int32_t in = x[k];
      const int32_t o = wadd(in, pred);
      const int32_t step = st[k];
      SLA_UNROLL
      for (int i = 0; i < M; ++i) {
        const int s = slot(k, i);
        fc[i] = wadd(fc[i], step * xs[s]);
        ic[i] = wadd(ic[i], step * ps[s]);
      }
      xv[k] = o;
      xs[k] = sgn(o);
      pv[k] = WARM ? in : pred;
      ps[k] = sgn(pv[k]);
      out[k] = o;
    }
  }

  // tile t of a row: x, st and out are the row's part of their tiles
  SLA_HD void tile(const int32_t* x, const int32_t* st, int32_t* out, int t, int) {
    int b = 0;
    if (t == 0) {
      block<true>(x, st, out);
      b = M;
    }
    for (; b < kTile; b += M) block<false>(x + b, st + b, out + b);
  }
};

// The chain at a run-time order (M <= kMaxLms; 0 passes through): the Lms
// body K2-K4 share, which computes its own steps.
template <>
struct LmsSynthChain<0> {
  Lms<0, true> lms;
  SLA_HD explicit LmsSynthChain(int m) : lms(m) {}
  SLA_HD void tile(const int32_t* x, const int32_t*, int32_t* out, int, int count) {
    for (int j = 0; j < count; ++j) out[j] = lms(x[j]);
  }
};

// K6's pipeline. Iteration `it`:
//   the producer loads tile it of the residual into in[it % kInSlots]
//   the prep role   tile it - kPrep:   in -> step (sample-parallel)
//   the chain       tile it - kChain:  in, step -> o
//   the producer stores tile it - kStore from o.
// The loads land one iteration after they are issued, so the prep role
// reads a tile two iterations after its load, and the chain one more: four
// input slots (loading, landed, prep, chain); the steps and the outputs
// pass through two slots each.
struct LmsSynthPipe {
  static constexpr int kInSlots = 4, kPrep = 2, kChain = 3, kStore = 4;
  static constexpr int kWords = kInSlots * kTileWords + 2 * 2 * kTileWords;
  int32_t* in;
  int32_t* step;
  int32_t* o;
  int L, ntiles;

  SLA_HD LmsSynthPipe(int32_t* smem, int L_)
      : in(smem), step(in + kInSlots * kTileWords), o(step + 2 * kTileWords), L(L_),
        ntiles((L_ + kTile - 1) / kTile) {}

  SLA_HD int iterations() const { return ntiles + kStore; }
  SLA_HD int32_t* load_dst(int t, int r, int j) const {
    return in + (t % kInSlots) * kTileWords + r * kTilePitch + j;
  }
  SLA_HD const int32_t* store_src(int t, int r, int j) const {
    return o + (t % 2) * kTileWords + r * kTilePitch + j;
  }

  // the steps of row r (order m), samples j0, j0 + stride, ... of the tile
  // lagging kPrep
  SLA_HD void prep(int it, int r, int j0, int stride, int m) const {
    const int t = it - kPrep;
    if (t < 0 || t >= ntiles) return;
    const int count = tile_count(t, L);
    const int32_t* src = in + (t % kInSlots) * kTileWords + r * kTilePitch;
    int32_t* dst = step + (t % 2) * kTileWords + r * kTilePitch;
    for (int j = j0; j < count; j += stride) {
      const int32_t x = src[j];
      dst[j] = t * kTile + j < m ? 0 : sgn(x) * (bit_length(magnitude(x)) >> 1);
    }
  }

  // row r's chain on the tile lagging kChain
  template <class Chain>
  SLA_HD void chain(Chain& c, int it, int r) const {
    const int t = it - kChain;
    if (t < 0 || t >= ntiles) return;
    const int at = r * kTilePitch;
    c.tile(in + (t % kInSlots) * kTileWords + at, step + (t % 2) * kTileWords + at,
           o + (t % 2) * kTileWords + at, t, tile_count(t, L));
  }
};

}  // namespace sla
