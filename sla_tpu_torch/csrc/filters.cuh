// Per-row bodies of the seven filter kernels (filters.cu), written once as
// __host__ __device__ code: nvcc builds them into the CUDA kernels, and a
// host build (filters_host.cpp, g++ -fwrapv) runs the same bodies on the CPU
// so the tests can hold their arithmetic against the plain PyTorch versions
// without a card.
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
// maxima, sla_tpu/encoder.py:65-69), with the state in local memory. A
// run-time order of 0 is a passthrough, as in the reference.
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
constexpr int kLoadBatch = 8;  // samples loaded together per row (run_row)

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

// y[n] = x[n] - ((x[n-1] * 31) >> 5), zero state
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

// PARCOR lattice, predict or synthesize, from zero state. coef: c[1..p].
template <int P, bool SYNTH>
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

  SLA_HD int32_t operator()(int32_t x) {
    const int n = P > 0 ? P : p;
    int32_t f = x;
    if (!SYNTH) {
      // f[k] = f[k-1] - q(c[k], b[k-1]); b[k] = b[k-1] - q(c[k], f[k-1])
      int32_t carry = x;  // the new b[0]
      SLA_UNROLL
      for (int k = 0; k < n; ++k) {
        const int32_t bk = b[k];
        b[k] = carry;
        carry = wsub(bk, qmul(c[k], f));
        f = wsub(f, qmul(c[k], bk));
      }
      b[n] = carry;
    } else {
      // stages p..1: f += q(c[k], b[k-1]); b[k] = b[k-1] - q(c[k], f)
      SLA_UNROLL
      for (int k = n - 1; k >= 0; --k) {
        f = wadd(f, qmul(c[k], b[k]));
        b[k + 1] = wsub(b[k], qmul(c[k], f));
      }
      b[0] = f;
    }
    return f;
  }
};

// Sign-sign LMS, predict or synthesize, from zero state; the first M samples
// are warmup (no adaptation, the buffers fill newest-first).
template <int M, bool SYNTH>
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
    int32_t acc = 512;
    SLA_UNROLL
    for (int i = 0; i < n; ++i) acc = wadd(acc, wmul(fc[i], xb[i]));
    SLA_UNROLL
    for (int i = 0; i < n; ++i) acc = wadd(acc, wmul(ic[i], pb[i]));
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

// Long-term stage of one row. md = max_delay (pitch + T/2), 0 for a row
// without the stage; q15 = Q31 coefficient >> 16. Active from n >= md.
//   predict:    pred from the INPUT x[n - (md - j)]; a tap at or ahead of n
//               reads x[n], as sla_tpu's clamped slice does
//   synthesize: pred from the stage's own OUTPUT h[n - (md - j)], which the
//               row writes to h as it goes; a tap at or ahead of n
//               contributes 0, as sla_tpu's dropped scatter does
template <int T, bool SYNTH>
struct Longterm {
  static constexpr int kCap = T > 0 ? T : kMaxTaps;
  const int32_t* src;  // predict: the input; synthesize: h
  int32_t* h;          // synthesize only: the stage's output history
  int64_t stride;
  int md;
  int nt;
  int32_t q[kCap];

  SLA_HD Longterm(const int32_t* src_, int32_t* h_, int64_t stride_, int md_,
                  const int32_t* q15, int nt_rt)
      : src(src_), h(h_), stride(stride_), md(md_), nt(T > 0 ? T : nt_rt) {
    const int n = T > 0 ? T : nt;
    SLA_UNROLL
    for (int j = 0; j < n; ++j) q[j] = q15[j];
  }

  SLA_HD int32_t operator()(int32_t x, int n) {
    const int taps = T > 0 ? T : nt;
    int32_t out = x;
    if (md > 0 && n >= md) {
      int64_t acc = 0;
      SLA_UNROLL
      for (int j = 0; j < taps; ++j) {
        const int back = md - j;
        if (SYNTH) {
          if (back >= 1) acc += (int64_t)q[j] * src[(int64_t)(n - back) * stride];
        } else {
          const int lag = back > 0 ? back : 0;
          acc += (int64_t)q[j] * src[(int64_t)(n - lag) * stride];
        }
      }
      const int32_t pred = wrap64((acc + (1 << 14)) >> 15);
      out = SYNTH ? wadd(x, pred) : wsub(x, pred);
    }
    if (SYNTH) h[(int64_t)n * stride] = out;
    return out;
  }
};

// K1: pre-emphasis (when EMPH) -> lattice predict
template <int P, bool EMPH = true>
struct Stage1 {
  PreEmphasis pre;
  Lattice<P, false> lattice;
  SLA_HD Stage1(const int32_t* coef, int p) : lattice(coef, p) {}
  SLA_HD int32_t operator()(int32_t x, int) { return lattice(EMPH ? pre(x) : x); }
};

// K2: long-term FIR predict -> LMS predict
template <int T, int M>
struct Stage2 {
  Longterm<T, false> longterm;
  Lms<M, false> lms;
  SLA_HD Stage2(const int32_t* x, int64_t stride, int md, const int32_t* q15,
                int nt, int m)
      : longterm(x, nullptr, stride, md, q15, nt), lms(m) {}
  SLA_HD int32_t operator()(int32_t x, int n) { return lms(longterm(x, n)); }
};

// K3: LMS synth -> long-term synth -> lattice synth -> de-emphasis
template <int P, int T, int M>
struct Synth {
  Lms<M, true> lms;
  Longterm<T, true> longterm;
  Lattice<P, true> lattice;
  DeEmphasis de;
  SLA_HD Synth(int32_t* h, int64_t stride, int md, const int32_t* q15, int nt,
               const int32_t* coef, int p, int m)
      : lms(m), longterm(h, h, stride, md, q15, nt), lattice(coef, p) {}
  SLA_HD int32_t operator()(int32_t x, int n) {
    return de(lattice(longterm(lms(x), n)));
  }
};

// K4: K1's body then K2's in one sample loop. The long-term FIR reads the
// stage-1 residual, which the row writes to the (L, B) scratch h before the
// taps read it: a tap at or ahead of n reads h[n], this sample's residual.
template <int P, int T, int M>
struct FusedEncode {
  Stage1<P> stage1;
  int32_t* h;
  int64_t stride;
  Stage2<T, M> stage2;
  SLA_HD FusedEncode(int32_t* h_, int64_t stride_, const int32_t* coef, int p, int md,
                     const int32_t* q15, int nt, int m)
      : stage1(coef, p), h(h_), stride(stride_), stage2(h_, stride_, md, q15, nt, m) {}
  SLA_HD int32_t operator()(int32_t x, int n) {
    const int32_t r1 = stage1(x, n);
    h[(int64_t)n * stride] = r1;
    return stage2(r1, n);
  }
};

// K5: lattice synthesize -> de-emphasis (when EMPH)
template <int P, bool EMPH>
struct LatticeSynth {
  Lattice<P, true> lattice;
  DeEmphasis de;
  SLA_HD LatticeSynth(const int32_t* coef, int p) : lattice(coef, p) {}
  SLA_HD int32_t operator()(int32_t x, int) {
    const int32_t out = lattice(x);
    return EMPH ? de(out) : out;
  }
};

// K6: LMS synthesize alone
template <int M>
struct LmsSynth {
  Lms<M, true> lms;
  SLA_HD explicit LmsSynth(int m) : lms(m) {}
  SLA_HD int32_t operator()(int32_t x, int) { return lms(x); }
};

// K7: long-term synthesize alone, over its own output history h
template <int T>
struct LongtermSynth {
  Longterm<T, true> longterm;
  SLA_HD LongtermSynth(int32_t* h, int64_t stride, int md, const int32_t* q15, int nt)
      : longterm(h, h, stride, md, q15, nt) {}
  SLA_HD int32_t operator()(int32_t x, int n) { return longterm(x, n); }
};

// Runs one row through `step` in sample order. x and y are the row's first
// samples in the sample-major (L, B) layout, so consecutive samples are
// `stride` (= B) apart. Samples are loaded kLoadBatch at a time so their
// memory latencies overlap instead of stalling every sample.
template <class Step>
SLA_HD void run_row(Step& step, const int32_t* x, int32_t* y, int64_t stride, int L) {
  for (int n0 = 0; n0 < L; n0 += kLoadBatch) {
    int32_t xs[kLoadBatch];
    SLA_UNROLL
    for (int u = 0; u < kLoadBatch; ++u)
      xs[u] = n0 + u < L ? x[(int64_t)(n0 + u) * stride] : 0;
    SLA_UNROLL
    for (int u = 0; u < kLoadBatch; ++u) {
      if (n0 + u < L) y[(int64_t)(n0 + u) * stride] = step(xs[u], n0 + u);
    }
  }
}

}  // namespace sla
