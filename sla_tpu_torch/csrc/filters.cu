// The SLA filter cascade's seven CUDA kernels for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (sla_tpu_torch/kernels/build.py,
// sla_tpu_torch/kernels/cuda_filters.py). The per-row arithmetic lives in
// filters.cuh.
//
// Design, common to the seven kernels. Every block x channel row is
// independent — the format resets every filter at block start — and the
// samples of a row are strictly sequential, so each kernel runs ONE THREAD
// PER ROW with the sample loop inside the thread. Data is int32 in the
// sample-major (L, B) layout: at each sample a warp's 32 rows read and write
// 128 contiguous bytes. Filter orders that the presets use are template
// arguments, so the lattice and LMS state stays in registers; any other
// order EncoderConfig admits takes the run-time instantiation.
//
// What bounds them on this card: latency. Each sample is a dependent chain
// of about 2p + 2M multiply-adds (lattice stages, LMS taps) per row, and
// one thread per row gives about 2,154 threads for five minutes of CD
// stereo at 12,288-sample blocks — 17 blocks of 128 threads, which occupy
// only 17 of the 132 SMs, one warp per scheduler. Memory traffic is a few
// bytes per sample and per row, far below what the card moves; the sample
// loads are batched (kLoadBatch) so their latency overlaps. Making these
// kernels fast (more rows in flight, splitting the stage chain across
// threads) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "filters.cuh"

namespace {

constexpr int kThreads = 128;

inline dim3 grid_for(int B) { return dim3((unsigned)((B + kThreads - 1) / kThreads)); }

// K1. Replaces sla_tpu/kernels/pallas_filters.py lattice_filter_tl
// (synthesize=False; Pallas body _lattice_kernel) and lattice_filter_wide_tl
// (_lattice_kernel_wide): pre-emphasis (when EMPH, the Pallas
// pre_emphasis flag), then PARCOR lattice predict.
template <int P, bool EMPH>
__global__ void __launch_bounds__(kThreads)
lattice_predict_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                       const int32_t* __restrict__ coef, int B, int L, int p) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  sla::Stage1<P, EMPH> step(coef + (int64_t)row * p, p);
  sla::run_row(step, x + row, y + row, B, L);
}

// K2. Replaces pallas_filters.py fused_stage2_tl (_fused_stage2_kernel_win)
// and fused_stage2_wide_tl (_fused_stage2_kernel_wide), and the predict
// direction of lms_filter_tl (_lms_kernel): the long-term FIR predict,
// reading its own input at n - (md - j) straight from global memory (no
// ring, no window plan, any lag, T = 0 included), then the LMS predict.
template <int T, int M>
__global__ void __launch_bounds__(kThreads)
stage2_predict_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                      const int32_t* __restrict__ md,
                      const int32_t* __restrict__ q15, int B, int L, int nt,
                      int m) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  sla::Stage2<T, M> step(x + row, B, md[row], q15 + (int64_t)row * nt, nt, m);
  sla::run_row(step, x + row, y + row, B, L);
}

// K3. Replaces pallas_filters.py fused_synth_tl (_fused_synth_kernel,
// _fused_synth_kernel_win) and fused_synth_wide_tl
// (_fused_synth_kernel_wide): LMS synth, long-term synth, lattice synth and
// de-emphasis in one sample loop. The long-term history is the stage's own
// output, which each row writes to the (L, B) scratch h and reads back at
// n - lag (lag <= 258): no lag sort, no ring-size dispatch.
template <int P, int T, int M>
__global__ void __launch_bounds__(kThreads)
synth_cascade_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                     int32_t* h, const int32_t* __restrict__ coef,
                     const int32_t* __restrict__ md,
                     const int32_t* __restrict__ q15, int B, int L, int p,
                     int nt, int m) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  sla::Synth<P, T, M> step(h + row, B, md[row], q15 + (int64_t)row * nt, nt,
                           coef + (int64_t)row * p, p, m);
  sla::run_row(step, x + row, y + row, B, L);
}

// K4. Replaces pallas_filters.py fused_encode_tl (_fused_encode_kernel_win)
// and fused_encode_wide_tl (_fused_encode_kernel_wide): pre-emphasis,
// lattice predict, long-term FIR predict and LMS predict in one sample loop,
// one read of x and one write of y per sample instead of K1's and K2's two
// each. The FIR's history is the stage-1 residual, which each row writes to
// the (L, B) scratch h just before its taps read it (a tap at or ahead of n
// reads this sample's residual, as K2 reads its input): every lag and T = 0
// take the same kernel, with no window plan or lag sort.
template <int P, int T, int M>
__global__ void __launch_bounds__(kThreads)
fused_encode_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                    int32_t* h, const int32_t* __restrict__ coef,
                    const int32_t* __restrict__ md,
                    const int32_t* __restrict__ q15, int B, int L, int p,
                    int nt, int m) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  sla::FusedEncode<P, T, M> step(h + row, B, coef + (int64_t)row * p, p, md[row],
                                 q15 + (int64_t)row * nt, nt, m);
  sla::run_row(step, x + row, y + row, B, L);
}

// K5. Replaces pallas_filters.py lattice_filter_tl(synthesize=True)
// (_lattice_synth_body) and lattice_filter_wide_tl(synthesize=True): PARCOR
// lattice synthesis, then de-emphasis when EMPH (the Pallas pre_emphasis
// flag).
template <int P, bool EMPH>
__global__ void __launch_bounds__(kThreads)
lattice_synth_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                     const int32_t* __restrict__ coef, int B, int L, int p) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  sla::LatticeSynth<P, EMPH> step(coef + (int64_t)row * p, p);
  sla::run_row(step, x + row, y + row, B, L);
}

// K6. Replaces pallas_filters.py lms_filter_tl(synthesize=True)
// (_lms_kernel_body): sign-sign LMS synthesis; order 0 passes through.
template <int M>
__global__ void __launch_bounds__(kThreads)
lms_synth_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y, int B,
                 int L, int m) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  sla::LmsSynth<M> step(m);
  sla::run_row(step, x + row, y + row, B, L);
}

// K7. Replaces pallas_filters.py longterm_synth_tl (_longterm_synth_kernel,
// _longterm_synth_kernel_win): long-term synthesis over the stage's own
// output, which each row writes to the (L, B) scratch h and reads back at
// n - lag, as in K3: no ring, no one-hot select, no 12-bit limbs.
template <int T>
__global__ void __launch_bounds__(kThreads)
longterm_synth_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                      int32_t* h, const int32_t* __restrict__ md,
                      const int32_t* __restrict__ q15, int B, int L, int nt) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  sla::LongtermSynth<T> step(h + row, B, md[row], q15 + (int64_t)row * nt, nt);
  sla::run_row(step, x + row, y + row, B, L);
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() as an int
// (0 = cudaSuccess); it neither allocates nor synchronizes.
extern "C" {

// K1 and K5: the preset orders with emphasis are templated; emphasis off
// (no caller on the codec's path) takes the run-time order.
int sla_lattice_predict(const int32_t* x, int32_t* y, const int32_t* coef,
                        int B, int L, int p, int emphasis, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 g = grid_for(B);
  if (!emphasis) {
    lattice_predict_kernel<0, false><<<g, kThreads, 0, s>>>(x, y, coef, B, L, p);
  } else if (p == 8) {
    lattice_predict_kernel<8, true><<<g, kThreads, 0, s>>>(x, y, coef, B, L, p);
  } else if (p == 16) {
    lattice_predict_kernel<16, true><<<g, kThreads, 0, s>>>(x, y, coef, B, L, p);
  } else if (p == 32) {
    lattice_predict_kernel<32, true><<<g, kThreads, 0, s>>>(x, y, coef, B, L, p);
  } else {
    lattice_predict_kernel<0, true><<<g, kThreads, 0, s>>>(x, y, coef, B, L, p);
  }
  return (int)cudaGetLastError();
}

int sla_lattice_synth(const int32_t* x, int32_t* y, const int32_t* coef,
                      int B, int L, int p, int emphasis, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 g = grid_for(B);
  if (!emphasis) {
    lattice_synth_kernel<0, false><<<g, kThreads, 0, s>>>(x, y, coef, B, L, p);
  } else if (p == 8) {
    lattice_synth_kernel<8, true><<<g, kThreads, 0, s>>>(x, y, coef, B, L, p);
  } else if (p == 16) {
    lattice_synth_kernel<16, true><<<g, kThreads, 0, s>>>(x, y, coef, B, L, p);
  } else if (p == 32) {
    lattice_synth_kernel<32, true><<<g, kThreads, 0, s>>>(x, y, coef, B, L, p);
  } else {
    lattice_synth_kernel<0, true><<<g, kThreads, 0, s>>>(x, y, coef, B, L, p);
  }
  return (int)cudaGetLastError();
}

int sla_stage2_predict(const int32_t* x, int32_t* y, const int32_t* md,
                       const int32_t* q15, int B, int L, int nt, int m,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 g = grid_for(B);
  if (nt == 1 && m == 4) {
    stage2_predict_kernel<1, 4><<<g, kThreads, 0, s>>>(x, y, md, q15, B, L, nt, m);
  } else if (nt == 1 && m == 8) {
    stage2_predict_kernel<1, 8><<<g, kThreads, 0, s>>>(x, y, md, q15, B, L, nt, m);
  } else if (nt == 3 && m == 8) {
    stage2_predict_kernel<3, 8><<<g, kThreads, 0, s>>>(x, y, md, q15, B, L, nt, m);
  } else {
    stage2_predict_kernel<0, 0><<<g, kThreads, 0, s>>>(x, y, md, q15, B, L, nt, m);
  }
  return (int)cudaGetLastError();
}

int sla_synth_cascade(const int32_t* x, int32_t* y, int32_t* h,
                      const int32_t* coef, const int32_t* md,
                      const int32_t* q15, int B, int L, int p, int nt, int m,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 g = grid_for(B);
  if (p == 8 && nt == 1 && m == 4) {  // preset 0
    synth_cascade_kernel<8, 1, 4><<<g, kThreads, 0, s>>>(x, y, h, coef, md, q15, B, L, p, nt, m);
  } else if (p == 8 && nt == 1 && m == 8) {  // preset 1
    synth_cascade_kernel<8, 1, 8><<<g, kThreads, 0, s>>>(x, y, h, coef, md, q15, B, L, p, nt, m);
  } else if (p == 16 && nt == 1 && m == 8) {  // preset 2
    synth_cascade_kernel<16, 1, 8><<<g, kThreads, 0, s>>>(x, y, h, coef, md, q15, B, L, p, nt, m);
  } else if (p == 32 && nt == 3 && m == 8) {  // presets 3 and 4
    synth_cascade_kernel<32, 3, 8><<<g, kThreads, 0, s>>>(x, y, h, coef, md, q15, B, L, p, nt, m);
  } else {
    synth_cascade_kernel<0, 0, 0><<<g, kThreads, 0, s>>>(x, y, h, coef, md, q15, B, L, p, nt, m);
  }
  return (int)cudaGetLastError();
}


int sla_fused_encode(const int32_t* x, int32_t* y, int32_t* h,
                     const int32_t* coef, const int32_t* md,
                     const int32_t* q15, int B, int L, int p, int nt, int m,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 g = grid_for(B);
  if (p == 8 && nt == 1 && m == 4) {  // preset 0
    fused_encode_kernel<8, 1, 4><<<g, kThreads, 0, s>>>(x, y, h, coef, md, q15, B, L, p, nt, m);
  } else if (p == 8 && nt == 1 && m == 8) {  // preset 1
    fused_encode_kernel<8, 1, 8><<<g, kThreads, 0, s>>>(x, y, h, coef, md, q15, B, L, p, nt, m);
  } else if (p == 16 && nt == 1 && m == 8) {  // preset 2
    fused_encode_kernel<16, 1, 8><<<g, kThreads, 0, s>>>(x, y, h, coef, md, q15, B, L, p, nt, m);
  } else if (p == 32 && nt == 3 && m == 8) {  // presets 3 and 4
    fused_encode_kernel<32, 3, 8><<<g, kThreads, 0, s>>>(x, y, h, coef, md, q15, B, L, p, nt, m);
  } else {
    fused_encode_kernel<0, 0, 0><<<g, kThreads, 0, s>>>(x, y, h, coef, md, q15, B, L, p, nt, m);
  }
  return (int)cudaGetLastError();
}

int sla_lms_synth(const int32_t* x, int32_t* y, int B, int L, int m, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 g = grid_for(B);
  switch (m) {
    case 4: lms_synth_kernel<4><<<g, kThreads, 0, s>>>(x, y, B, L, m); break;
    case 8: lms_synth_kernel<8><<<g, kThreads, 0, s>>>(x, y, B, L, m); break;
    default: lms_synth_kernel<0><<<g, kThreads, 0, s>>>(x, y, B, L, m); break;
  }
  return (int)cudaGetLastError();
}

int sla_longterm_synth(const int32_t* x, int32_t* y, int32_t* h,
                       const int32_t* md, const int32_t* q15, int B, int L,
                       int nt, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 g = grid_for(B);
  switch (nt) {
    case 1: longterm_synth_kernel<1><<<g, kThreads, 0, s>>>(x, y, h, md, q15, B, L, nt); break;
    case 3: longterm_synth_kernel<3><<<g, kThreads, 0, s>>>(x, y, h, md, q15, B, L, nt); break;
    default: longterm_synth_kernel<0><<<g, kThreads, 0, s>>>(x, y, h, md, q15, B, L, nt); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
