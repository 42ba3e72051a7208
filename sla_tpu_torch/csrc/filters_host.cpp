// Host build of the kernels' bodies (filters.cuh), for the tests only:
// g++ -fwrapv compiles it on a machine without a card, and the tests hold
// each body against the plain PyTorch version. Same parameters as the C
// entries of filters.cu, in the same layouts ((B, L) rows for K1-K7, the
// sample-major (L, B) for the LMS alone); `fixed` selects the
// compile-time-order instantiation the kernel would take for these orders
// (when one exists) instead of the run-time one (K5: the widest
// configuration). K1, K5 and K7 run their kernels' lane schedules through
// sla::HostLanes, which holds a warp's 32 lanes (K1: each segment's chunks
// and shuffles; K5 and K7: each step's lanes one after another, forward or
// in reverse, so a lane that reads a value written in its own step gives a
// wrong sample in one of the two orders).
// K2-K4 and K6 run their kernels' tile schedule (Stage2Pipe, SynthPipe,
// EncodePipe, LmsSynthPipe) one row group at a time, each iteration's roles
// one after another in pipeline order, so a slot that two roles share in
// one iteration gives a wrong tile here; K4 and K6 can also run them in
// reverse order, so a tile read in the iteration that writes it gives a
// wrong tile too.
#include <stdint.h>

#include <algorithm>
#include <vector>

#include "filters.cuh"

namespace {

// The LMS alone on the sample-major (L, B) layout, one row after another in
// sample order: row r's sample n at x[n * B + r].
template <int M, bool SYNTH, bool TREE>
void lms_rows(const int32_t* x, int32_t* y, int B, int L, int m) {
  for (int64_t row = 0; row < B; ++row) {
    sla::Lms<M, SYNTH, TREE> lms(m);
    for (int64_t n = 0; n < L; ++n) y[n * B + row] = lms(x[n * B + row]);
  }
}

// The producer's part of iteration `it`, done at once: copy tile it in
// (store() copies tile it - kStore out, after the stages).
template <class Pipe>
void produce(const Pipe& pipe, int it, const int32_t* x, int row0, int rows) {
  const int64_t L = pipe.L;
  if (it < pipe.ntiles) {
    for (int r = 0; r < rows; ++r)
      for (int j = 0; j < sla::tile_count(it, pipe.L); ++j)
        *pipe.load_dst(it, r, j) = x[(row0 + r) * L + (int64_t)it * sla::kTile + j];
  }
}

template <class Pipe>
void store(const Pipe& pipe, int it, int32_t* y, int row0, int rows) {
  const int64_t L = pipe.L;
  const int t = it - Pipe::kStore;
  if (t < 0 || t >= pipe.ntiles) return;
  for (int r = 0; r < rows; ++r)
    for (int j = 0; j < sla::tile_count(t, pipe.L); ++j)
      y[(row0 + r) * L + (int64_t)t * sla::kTile + j] = *pipe.store_src(t, r, j);
}

// K2's kernel, one row group after another; (B, L) rows
template <int T, int M>
void stage2_pipe(const int32_t* x, int32_t* y, const int32_t* md, const int32_t* q15, int B,
                 int L, int nt, int m) {
  std::vector<int32_t> smem(sla::Stage2Pipe::kWords);
  for (int row0 = 0; row0 < B; row0 += sla::kGroup) {
    const int rows = std::min(sla::kGroup, B - row0);
    const sla::Stage2Pipe pipe(smem.data(), L);
    std::vector<sla::Tiled<sla::LmsStep<M, false>>> lms(rows, sla::Tiled<sla::LmsStep<M, false>>(m));
    for (int it = 0; it < pipe.iterations(); ++it) {
      produce(pipe, it, x, row0, rows);
      for (int r = 0; r < rows; ++r)
        pipe.fir<T>(it, r, 0, 1, md[row0 + r], q15 + (int64_t)(row0 + r) * nt, nt);
      for (int r = 0; r < rows; ++r) pipe.lms(lms[r], it, r);
      store(pipe, it, y, row0, rows);
    }
  }
}

// K3's kernel, one row group after another; (B, L) rows
template <int P, int T, int M>
void synth_pipe(const int32_t* x, int32_t* y, const int32_t* coef, const int32_t* md,
                const int32_t* q15, int B, int L, int p, int nt, int m) {
  std::vector<int32_t> smem(sla::SynthPipe::kWords);
  for (int row0 = 0; row0 < B; row0 += sla::kGroup) {
    const int rows = std::min(sla::kGroup, B - row0);
    const sla::SynthPipe pipe(smem.data(), L);
    std::vector<sla::Tiled<sla::LmsSynth<M>>> lms;
    std::vector<sla::LongtermSynthRing<T>> lt;
    std::vector<sla::Tiled<sla::LatticeSynth<P, true>>> lattice;
    for (int r = 0; r < rows; ++r) {
      const int64_t row = row0 + r;
      lms.emplace_back(m);
      lt.emplace_back(pipe.ring_row(r), md[row], q15 + row * nt, nt);
      lattice.emplace_back(coef + row * p, p);
    }
    for (int it = 0; it < pipe.iterations(); ++it) {
      produce(pipe, it, x, row0, rows);
      for (int r = 0; r < rows; ++r) pipe.lms(lms[r], it, r);
      for (int r = 0; r < rows; ++r) pipe.longterm(lt[r], it, r);
      for (int r = 0; r < rows; ++r) pipe.lattice(lattice[r], it, r);
      store(pipe, it, y, row0, rows);
    }
  }
}

// K1's kernel, one warp (row, segment of seg outputs) after another; (B, L)
// rows
template <int P, bool EMPH>
void lattice_segments(const int32_t* x, int32_t* y, const int32_t* coef, int B, int L, int p,
                      int seg) {
  for (int64_t row = 0; row < B; ++row)
    for (int start = 0; start < L; start += seg)
      sla::lattice_segment<P, EMPH>(sla::HostLanes(), x + row * L, y + row * L, L, start, seg,
                                    coef + row * p, p);
}

// K4's kernel, one row group after another; (B, L) rows
template <int P, int T, int M>
void encode_pipe(const int32_t* x, int32_t* y, const int32_t* coef, const int32_t* md,
                 const int32_t* q15, int B, int L, int p, int nt, int m, bool reverse) {
  std::vector<int32_t> smem(sla::EncodePipe::kWords);
  const sla::HostLanes lanes;
  for (int row0 = 0; row0 < B; row0 += sla::kGroup) {
    const int rows = std::min(sla::kGroup, B - row0);
    const sla::EncodePipe pipe(smem.data(), L);
    std::vector<sla::Tiled<sla::LmsStep<M, false>>> lms(rows, sla::Tiled<sla::LmsStep<M, false>>(m));
    for (int r = 0; r < rows; ++r) pipe.clear(r, 0, 1);
    for (int it = 0; it < pipe.iterations(); ++it) {
      const auto stage1 = [&] {
        for (int r = 0; r < rows; ++r)
          pipe.stage1<P>(lanes, it, r, coef + (int64_t)(row0 + r) * p, p);
      };
      const auto fir = [&] {
        for (int r = 0; r < rows; ++r)
          pipe.fir<T>(it, r, 0, 1, md[row0 + r], q15 + (int64_t)(row0 + r) * nt, nt);
      };
      const auto lms_role = [&] {
        for (int r = 0; r < rows; ++r) pipe.lms(lms[r], it, r);
      };
      if (!reverse) {
        produce(pipe, it, x, row0, rows);
        stage1();
        fir();
        lms_role();
        store(pipe, it, y, row0, rows);
      } else {
        store(pipe, it, y, row0, rows);
        lms_role();
        fir();
        stage1();
        produce(pipe, it, x, row0, rows);
      }
    }
  }
}

// K5's kernel, one warp (64 / G rows) after another; (B, L) rows. The warps
// share one pair of rings, so a slot read before the warp wrote it holds
// another warp's sample.
template <class Config>
void lattice_synth_warps(const int32_t* x, int32_t* y, const int32_t* coef, int B, int L, int p,
                         bool emphasis, bool reverse) {
  constexpr int G = Config::G, S = Config::S;
  std::vector<int32_t> rings(sla::SysShape<G>::kWords);
  for (int64_t row0 = 0; row0 < B; row0 += sla::SysShape<G>::kRows) {
    if (emphasis) {
      sla::lattice_synth_warp<G, S, true>(sla::HostLanes(), x, y, B, L, row0, coef, p, rings.data(),
                                          reverse);
    } else {
      sla::lattice_synth_warp<G, S, false>(sla::HostLanes(), x, y, B, L, row0, coef, p,
                                           rings.data(), reverse);
    }
  }
}

// K6's kernel, one row group after another; (B, L) rows
template <int M>
void lms_synth_pipe(const int32_t* x, int32_t* y, int B, int L, int m, bool reverse) {
  std::vector<int32_t> smem(sla::LmsSynthPipe::kWords);
  for (int row0 = 0; row0 < B; row0 += sla::kGroup) {
    const int rows = std::min(sla::kGroup, B - row0);
    const sla::LmsSynthPipe pipe(smem.data(), L);
    std::vector<sla::LmsSynthChain<M>> chain(rows, sla::LmsSynthChain<M>(m));
    for (int it = 0; it < pipe.iterations(); ++it) {
      const auto prep = [&] {
        for (int r = 0; r < rows; ++r) pipe.prep(it, r, 0, 1, m);
      };
      const auto chain_role = [&] {
        for (int r = 0; r < rows; ++r) pipe.chain(chain[r], it, r);
      };
      if (!reverse) {
        produce(pipe, it, x, row0, rows);
        prep();
        chain_role();
        store(pipe, it, y, row0, rows);
      } else {
        store(pipe, it, y, row0, rows);
        chain_role();
        prep();
        produce(pipe, it, x, row0, rows);
      }
    }
  }
}

// K7's kernel, one warp (row) after another; (B, L) rows. The rows share
// one ring, so a slot read before the row wrote it holds another row's
// sample.
template <int T>
void longterm_rows(const int32_t* x, int32_t* y, const int32_t* md, const int32_t* q15, int B,
                   int L, int nt, bool reverse) {
  std::vector<int32_t> ring(sla::kLtRing);
  for (int64_t row = 0; row < B; ++row)
    sla::longterm_row<T>(sla::HostLanes(), x + row * L, y + row * L, L, ring.data(), md[row],
                         q15 + row * nt, nt, reverse);
}

}  // namespace

extern "C" {

// K1 in segments of `seg` outputs; seg 0 takes the kernel's own length
void sla_host_lattice_predict(const int32_t* x, int32_t* y, const int32_t* coef, int B, int L,
                              int p, int emphasis, int fixed, int seg) {
  if (seg <= 0) seg = sla::segment_length(p);
  if (!emphasis) return lattice_segments<0, false>(x, y, coef, B, L, p, seg);
  if (fixed && p == 8) return lattice_segments<8, true>(x, y, coef, B, L, p, seg);
  if (fixed && p == 16) return lattice_segments<16, true>(x, y, coef, B, L, p, seg);
  if (fixed && p == 32) return lattice_segments<32, true>(x, y, coef, B, L, p, seg);
  lattice_segments<0, true>(x, y, coef, B, L, p, seg);
}

// K5; fixed 0 takes the widest configuration (48 stages) for every order;
// reverse: run each step's lanes in reverse order
void sla_host_lattice_synth(const int32_t* x, int32_t* y, const int32_t* coef, int B, int L,
                            int p, int emphasis, int fixed, int reverse) {
  if (fixed && sla::synth_config(p) == 32)
    return lattice_synth_warps<sla::SynthConfig<32>>(x, y, coef, B, L, p, emphasis, reverse);
  lattice_synth_warps<sla::SynthConfig<48>>(x, y, coef, B, L, p, emphasis, reverse);
}

void sla_host_stage2_predict(const int32_t* x, int32_t* y, const int32_t* md, const int32_t* q15,
                             int B, int L, int nt, int m, int fixed) {
  if (fixed && nt == 1 && m == 4) return stage2_pipe<1, 4>(x, y, md, q15, B, L, nt, m);
  if (fixed && nt == 1 && m == 8) return stage2_pipe<1, 8>(x, y, md, q15, B, L, nt, m);
  if (fixed && nt == 3 && m == 8) return stage2_pipe<3, 8>(x, y, md, q15, B, L, nt, m);
  stage2_pipe<0, 0>(x, y, md, q15, B, L, nt, m);
}

void sla_host_synth_cascade(const int32_t* x, int32_t* y, const int32_t* coef, const int32_t* md,
                            const int32_t* q15, int B, int L, int p, int nt, int m, int fixed) {
  if (fixed && p == 8 && nt == 1 && m == 4)
    return synth_pipe<8, 1, 4>(x, y, coef, md, q15, B, L, p, nt, m);
  if (fixed && p == 8 && nt == 1 && m == 8)
    return synth_pipe<8, 1, 8>(x, y, coef, md, q15, B, L, p, nt, m);
  if (fixed && p == 16 && nt == 1 && m == 8)
    return synth_pipe<16, 1, 8>(x, y, coef, md, q15, B, L, p, nt, m);
  if (fixed && p == 32 && nt == 3 && m == 8)
    return synth_pipe<32, 3, 8>(x, y, coef, md, q15, B, L, p, nt, m);
  synth_pipe<0, 0, 0>(x, y, coef, md, q15, B, L, p, nt, m);
}

// The LMS alone, predict or synthesize, with the tree-summed dot product
// the kernels use (tree = 1) or the serial one (tree = 0); (L, B) rows.
void sla_host_lms(const int32_t* x, int32_t* y, int B, int L, int m, int synth, int tree,
                  int fixed) {
  if (fixed && m == 8) {
    if (synth) return tree ? lms_rows<8, true, true>(x, y, B, L, m) : lms_rows<8, true, false>(x, y, B, L, m);
    return tree ? lms_rows<8, false, true>(x, y, B, L, m) : lms_rows<8, false, false>(x, y, B, L, m);
  }
  if (synth) return tree ? lms_rows<0, true, true>(x, y, B, L, m) : lms_rows<0, true, false>(x, y, B, L, m);
  tree ? lms_rows<0, false, true>(x, y, B, L, m) : lms_rows<0, false, false>(x, y, B, L, m);
}

// K4; reverse: run each iteration's roles in reverse pipeline order
void sla_host_fused_encode(const int32_t* x, int32_t* y, const int32_t* coef, const int32_t* md,
                           const int32_t* q15, int B, int L, int p, int nt, int m, int fixed,
                           int reverse) {
  if (fixed && p == 8 && nt == 1 && m == 4)
    return encode_pipe<8, 1, 4>(x, y, coef, md, q15, B, L, p, nt, m, reverse);
  if (fixed && p == 8 && nt == 1 && m == 8)
    return encode_pipe<8, 1, 8>(x, y, coef, md, q15, B, L, p, nt, m, reverse);
  if (fixed && p == 16 && nt == 1 && m == 8)
    return encode_pipe<16, 1, 8>(x, y, coef, md, q15, B, L, p, nt, m, reverse);
  if (fixed && p == 32 && nt == 3 && m == 8)
    return encode_pipe<32, 3, 8>(x, y, coef, md, q15, B, L, p, nt, m, reverse);
  encode_pipe<0, 0, 0>(x, y, coef, md, q15, B, L, p, nt, m, reverse);
}

// K6; reverse: run each iteration's roles in reverse pipeline order
void sla_host_lms_synth(const int32_t* x, int32_t* y, int B, int L, int m, int fixed,
                        int reverse) {
  if (fixed && m == 4) return lms_synth_pipe<4>(x, y, B, L, m, reverse);
  if (fixed && m == 8) return lms_synth_pipe<8>(x, y, B, L, m, reverse);
  lms_synth_pipe<0>(x, y, B, L, m, reverse);
}

// K7; reverse: run each step's lanes in reverse order
void sla_host_longterm_synth(const int32_t* x, int32_t* y, const int32_t* md, const int32_t* q15,
                             int B, int L, int nt, int fixed, int reverse) {
  if (fixed && nt == 1) return longterm_rows<1>(x, y, md, q15, B, L, nt, reverse);
  if (fixed && nt == 3) return longterm_rows<3>(x, y, md, q15, B, L, nt, reverse);
  longterm_rows<0>(x, y, md, q15, B, L, nt, reverse);
}

}  // extern "C"
