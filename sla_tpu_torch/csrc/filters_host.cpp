// Host build of the kernels' per-row bodies (filters.cuh), for the tests
// only: g++ -fwrapv compiles it on a machine without a card, and the tests
// hold each row body against the plain PyTorch version. Same (L, B) layout
// and parameters as the C entries of filters.cu; `fixed` selects the
// compile-time-order instantiation the kernel would take for these orders
// (when one exists) instead of the run-time one.
#include <stdint.h>

#include "filters.cuh"

namespace {

template <class Step>
void run_rows(int B, int L, const int32_t* x, int32_t* y, Step (*make)(int, void*), void* ctx) {
  for (int row = 0; row < B; ++row) {
    Step step = make(row, ctx);
    sla::run_row(step, x + row, y + row, B, L);
  }
}

struct Args {
  const int32_t* x;
  int32_t* h;
  const int32_t* coef;
  const int32_t* md;
  const int32_t* q15;
  int B, p, nt, m;
};

template <int P, bool EMPH>
sla::Stage1<P, EMPH> make_stage1(int row, void* ctx) {
  const Args& a = *(const Args*)ctx;
  return sla::Stage1<P, EMPH>(a.coef + (int64_t)row * a.p, a.p);
}

template <int T, int M>
sla::Stage2<T, M> make_stage2(int row, void* ctx) {
  const Args& a = *(const Args*)ctx;
  return sla::Stage2<T, M>(a.x + row, a.B, a.md[row], a.q15 + (int64_t)row * a.nt, a.nt, a.m);
}

template <int P, int T, int M>
sla::Synth<P, T, M> make_synth(int row, void* ctx) {
  const Args& a = *(const Args*)ctx;
  return sla::Synth<P, T, M>(a.h + row, a.B, a.md[row], a.q15 + (int64_t)row * a.nt, a.nt,
                             a.coef + (int64_t)row * a.p, a.p, a.m);
}

template <int P, int T, int M>
sla::FusedEncode<P, T, M> make_fused_encode(int row, void* ctx) {
  const Args& a = *(const Args*)ctx;
  return sla::FusedEncode<P, T, M>(a.h + row, a.B, a.coef + (int64_t)row * a.p, a.p, a.md[row],
                                   a.q15 + (int64_t)row * a.nt, a.nt, a.m);
}

template <int P, bool EMPH>
sla::LatticeSynth<P, EMPH> make_lattice_synth(int row, void* ctx) {
  const Args& a = *(const Args*)ctx;
  return sla::LatticeSynth<P, EMPH>(a.coef + (int64_t)row * a.p, a.p);
}

template <int M>
sla::LmsSynth<M> make_lms_synth(int, void* ctx) {
  return sla::LmsSynth<M>(((const Args*)ctx)->m);
}

template <int T>
sla::LongtermSynth<T> make_longterm_synth(int row, void* ctx) {
  const Args& a = *(const Args*)ctx;
  return sla::LongtermSynth<T>(a.h + row, a.B, a.md[row], a.q15 + (int64_t)row * a.nt, a.nt);
}

}  // namespace

extern "C" {

void sla_host_lattice_predict(const int32_t* x, int32_t* y, const int32_t* coef, int B, int L,
                              int p, int emphasis, int fixed) {
  Args a{x, nullptr, coef, nullptr, nullptr, B, p, 0, 0};
  if (!emphasis) return run_rows(B, L, x, y, make_stage1<0, false>, &a);
  if (fixed && p == 8) return run_rows(B, L, x, y, make_stage1<8, true>, &a);
  if (fixed && p == 16) return run_rows(B, L, x, y, make_stage1<16, true>, &a);
  if (fixed && p == 32) return run_rows(B, L, x, y, make_stage1<32, true>, &a);
  run_rows(B, L, x, y, make_stage1<0, true>, &a);
}

void sla_host_lattice_synth(const int32_t* x, int32_t* y, const int32_t* coef, int B, int L,
                            int p, int emphasis, int fixed) {
  Args a{x, nullptr, coef, nullptr, nullptr, B, p, 0, 0};
  if (!emphasis) return run_rows(B, L, x, y, make_lattice_synth<0, false>, &a);
  if (fixed && p == 8) return run_rows(B, L, x, y, make_lattice_synth<8, true>, &a);
  if (fixed && p == 16) return run_rows(B, L, x, y, make_lattice_synth<16, true>, &a);
  if (fixed && p == 32) return run_rows(B, L, x, y, make_lattice_synth<32, true>, &a);
  run_rows(B, L, x, y, make_lattice_synth<0, true>, &a);
}

void sla_host_stage2_predict(const int32_t* x, int32_t* y, const int32_t* md, const int32_t* q15,
                             int B, int L, int nt, int m, int fixed) {
  Args a{x, nullptr, nullptr, md, q15, B, 0, nt, m};
  if (fixed && nt == 1 && m == 4) return run_rows(B, L, x, y, make_stage2<1, 4>, &a);
  if (fixed && nt == 1 && m == 8) return run_rows(B, L, x, y, make_stage2<1, 8>, &a);
  if (fixed && nt == 3 && m == 8) return run_rows(B, L, x, y, make_stage2<3, 8>, &a);
  run_rows(B, L, x, y, make_stage2<0, 0>, &a);
}

void sla_host_synth_cascade(const int32_t* x, int32_t* y, int32_t* h, const int32_t* coef,
                            const int32_t* md, const int32_t* q15, int B, int L, int p, int nt,
                            int m, int fixed) {
  Args a{x, h, coef, md, q15, B, p, nt, m};
  if (fixed && p == 8 && nt == 1 && m == 4) return run_rows(B, L, x, y, make_synth<8, 1, 4>, &a);
  if (fixed && p == 8 && nt == 1 && m == 8) return run_rows(B, L, x, y, make_synth<8, 1, 8>, &a);
  if (fixed && p == 16 && nt == 1 && m == 8) return run_rows(B, L, x, y, make_synth<16, 1, 8>, &a);
  if (fixed && p == 32 && nt == 3 && m == 8) return run_rows(B, L, x, y, make_synth<32, 3, 8>, &a);
  run_rows(B, L, x, y, make_synth<0, 0, 0>, &a);
}


void sla_host_fused_encode(const int32_t* x, int32_t* y, int32_t* h, const int32_t* coef,
                           const int32_t* md, const int32_t* q15, int B, int L, int p, int nt,
                           int m, int fixed) {
  Args a{x, h, coef, md, q15, B, p, nt, m};
  if (fixed && p == 8 && nt == 1 && m == 4) return run_rows(B, L, x, y, make_fused_encode<8, 1, 4>, &a);
  if (fixed && p == 8 && nt == 1 && m == 8) return run_rows(B, L, x, y, make_fused_encode<8, 1, 8>, &a);
  if (fixed && p == 16 && nt == 1 && m == 8) return run_rows(B, L, x, y, make_fused_encode<16, 1, 8>, &a);
  if (fixed && p == 32 && nt == 3 && m == 8) return run_rows(B, L, x, y, make_fused_encode<32, 3, 8>, &a);
  run_rows(B, L, x, y, make_fused_encode<0, 0, 0>, &a);
}

void sla_host_lms_synth(const int32_t* x, int32_t* y, int B, int L, int m, int fixed) {
  Args a{x, nullptr, nullptr, nullptr, nullptr, B, 0, 0, m};
  if (fixed && m == 4) return run_rows(B, L, x, y, make_lms_synth<4>, &a);
  if (fixed && m == 8) return run_rows(B, L, x, y, make_lms_synth<8>, &a);
  run_rows(B, L, x, y, make_lms_synth<0>, &a);
}

void sla_host_longterm_synth(const int32_t* x, int32_t* y, int32_t* h, const int32_t* md,
                             const int32_t* q15, int B, int L, int nt, int fixed) {
  Args a{x, h, nullptr, md, q15, B, 0, nt, 0};
  if (fixed && nt == 1) return run_rows(B, L, x, y, make_longterm_synth<1>, &a);
  if (fixed && nt == 3) return run_rows(B, L, x, y, make_longterm_synth<3>, &a);
  run_rows(B, L, x, y, make_longterm_synth<0>, &a);
}

}  // extern "C"
