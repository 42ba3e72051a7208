// The SLA filter cascade's three CUDA kernels for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (sla_tpu_torch/kernels/build.py,
// sla_tpu_torch/kernels/cuda_filters.py). The per-row arithmetic lives in
// filters.cuh.
//
// Design, common to the three kernels. Every block x channel row is
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
// (_lattice_kernel_wide): pre-emphasis, then PARCOR lattice predict.
template <int P>
__global__ void __launch_bounds__(kThreads)
lattice_predict_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                       const int32_t* __restrict__ coef, int B, int L, int p) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  sla::Stage1<P> step(coef + (int64_t)row * p, p);
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

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() as an int
// (0 = cudaSuccess); it neither allocates nor synchronizes.
extern "C" {

int sla_lattice_predict(const int32_t* x, int32_t* y, const int32_t* coef,
                        int B, int L, int p, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 g = grid_for(B);
  switch (p) {
    case 8: lattice_predict_kernel<8><<<g, kThreads, 0, s>>>(x, y, coef, B, L, p); break;
    case 16: lattice_predict_kernel<16><<<g, kThreads, 0, s>>>(x, y, coef, B, L, p); break;
    case 32: lattice_predict_kernel<32><<<g, kThreads, 0, s>>>(x, y, coef, B, L, p); break;
    default: lattice_predict_kernel<0><<<g, kThreads, 0, s>>>(x, y, coef, B, L, p); break;
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

}  // extern "C"
