// The SLA filter cascade's seven CUDA kernels for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (sla_tpu_torch/kernels/build.py,
// sla_tpu_torch/kernels/cuda_filters.py). The per-row arithmetic lives in
// filters.cuh.
//
// Design. Every block x channel row is independent — the format resets
// every filter at block start. Filter orders that the presets use are
// template arguments, so the filter state stays in registers; any other
// order EncoderConfig admits takes the run-time instantiation.
//
// K1, the encode's stage 1, has no feedback (filters.cuh, "K1"), so it is a
// stencil: a warp per segment of a row, lanes over samples, read and written
// in the (B, L) rows as they are. K7's long-term synthesis feeds back only
// across at least its smallest lag, so it is a warp per row in lag-sized
// steps of parallel samples (filters.cuh, "K7"). The lattice synthesis
// feeds back every sample, but a stage reads only the previous sample's
// state of the stage below, so K5 runs its stages side by side, lanes over
// stages, in a systolic schedule (filters.cuh, "K5"). The LMS feeds back
// every sample through all its taps, so a row's chain runs in one thread:
// K2, K3, K4 and K6 are pipelines over tiles (see below), a warp per stage,
// the input prefetched into shared memory, the long-term history in shared
// memory. Every kernel reads and writes the (B, L) rows directly.
//
// What bounds the sequential kernels on this card: latency. Each sample is
// a dependent chain of about 2p + 2M multiply-adds (lattice stages, LMS
// taps) per row, and the rows are the only parallel axis: 2,048 rows at
// 12,288-sample blocks give 64 row groups of 32. Memory traffic is a few
// bytes per sample and per row, far below what the card moves.
#include <cuda_runtime.h>
#include <stdint.h>

#include "filters.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// K1. Replaces sla_tpu/kernels/pallas_filters.py lattice_filter_tl
// (synthesize=False; Pallas body _lattice_kernel) and lattice_filter_wide_tl
// (_lattice_kernel_wide): pre-emphasis (when EMPH, the Pallas
// pre_emphasis flag), then PARCOR lattice predict. Bound on this card: the
// int32 operations (8 a stage and sample), once the samples of a row run in
// parallel, which the stencil allows. Warp w takes segment w % nseg of row
// w / nseg (sla::lattice_segment): 2,048 rows x 12,288 samples at p 16 give
// 26,624 warps, each lane 4 independent samples per stage and one shuffle,
// with 16-byte loads and stores where a row is aligned. The warm-up costs
// p of every segment's kSegmentSpan samples.
template <int P, bool EMPH>
__global__ void __launch_bounds__(kThreads)
lattice_predict_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                       const int32_t* __restrict__ coef, int B, int L, int p, int seg,
                       int nseg) {
  const int64_t w = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (int64_t)B * nseg) return;  // whole warps: the shuffles need all 32 lanes
  const int64_t row = w / nseg;
  const int s = (int)(w - row * nseg);
  const sla::WarpLanes lanes{(int)(threadIdx.x & 31)};
  sla::lattice_segment<P, EMPH>(lanes, x + row * L, y + row * L, L, s * seg, seg,
                                coef + row * p, p);
}

// -- K2, K3 and K4: pipelines of warps over tiles (filters.cuh, Stage2Pipe,
// SynthPipe and EncodePipe). A block owns kGroup = 32 rows, one per lane,
// so the grid is one row group per block and 2,048 rows land on 64 SMs.
// Warp 0 is the producer: it keeps the next input tile in flight with
// cp.async and stores finished tiles, so no stage waits on device memory,
// and the kernels read and write the (B, L) rows directly (no transposes
// around them). The other warps run the stages; all meet at one named
// barrier per tile.

constexpr int kPipeThreads = 128;    // K2, K3: four warps
constexpr int kEncodeThreads = 256;  // K4: eight warps
constexpr int kStage1Warps = 5;      // K4: warps 2-4 and 6-7

template <int kCount = kPipeThreads>
__device__ __forceinline__ void pipe_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kCount) : "memory");
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

// The producer's part of iteration `it`: issue the loads of tile it, store
// tile it - kStore, then wait until tile it - 1 has landed (the newest
// group may stay in flight). Rows are contiguous in (B, L), so each warp
// access covers 32 consecutive samples of one row.
template <class Pipe>
__device__ __forceinline__ void produce(const Pipe& pipe, int it, const int32_t* __restrict__ x,
                                        int32_t* __restrict__ y, int row0, int rows, int lane) {
  const int64_t L = pipe.L;
  if (it < pipe.ntiles) {
    const int count = sla::tile_count(it, pipe.L);
    for (int r = 0; r < rows; ++r) {
      const int32_t* src = x + (row0 + r) * L + (int64_t)it * sla::kTile;
      for (int j = lane; j < count; j += 32) cp_async4(pipe.load_dst(it, r, j), src + j);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  const int t = it - Pipe::kStore;
  if (t >= 0 && t < pipe.ntiles) {
    const int count = sla::tile_count(t, pipe.L);
    for (int r = 0; r < rows; ++r) {
      int32_t* dst = y + (row0 + r) * L + (int64_t)t * sla::kTile;
      for (int j = lane; j < count; j += 32) dst[j] = *pipe.store_src(t, r, j);
    }
  }
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// produce() with a full row group's whole tiles (every tile but a row's
// last) copied by loops of compile-time trip counts, so the stores' shared
// memory reads are issued together. K6's producer: with produce()'s
// run-time bounds the copy loops took 6.1 µs a tile of 32 rows on the H100,
// a producer warp alone, and set K6's pace (PERF.md; tools/synth_probe.cu).
template <class Pipe>
__device__ __forceinline__ void produce_whole(const Pipe& pipe, int it,
                                              const int32_t* __restrict__ x,
                                              int32_t* __restrict__ y, int row0, int rows,
                                              int lane) {
  constexpr int kLane = sla::kTile / 32;
  const int64_t L = pipe.L;
  const auto load = [&](int r, int j) {
    cp_async4(pipe.load_dst(it, r, j), x + (row0 + r) * L + (int64_t)it * sla::kTile + j);
  };
  if (it < pipe.ntiles) {
    const int count = sla::tile_count(it, pipe.L);
    if (count == sla::kTile && rows == sla::kGroup) {
#pragma unroll
      for (int r = 0; r < sla::kGroup; ++r) {
#pragma unroll
        for (int h = 0; h < kLane; ++h) load(r, lane + 32 * h);
      }
    } else {
      for (int r = 0; r < rows; ++r)
        for (int j = lane; j < count; j += 32) load(r, j);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  const int t = it - Pipe::kStore;
  const auto store = [&](int r, int j) {
    y[(row0 + r) * L + (int64_t)t * sla::kTile + j] = *pipe.store_src(t, r, j);
  };
  if (t >= 0 && t < pipe.ntiles) {
    const int count = sla::tile_count(t, pipe.L);
    if (count == sla::kTile && rows == sla::kGroup) {
#pragma unroll
      for (int r = 0; r < sla::kGroup; ++r) {
#pragma unroll
        for (int h = 0; h < kLane; ++h) store(r, lane + 32 * h);
      }
    } else {
      for (int r = 0; r < rows; ++r)
        for (int j = lane; j < count; j += 32) store(r, j);
    }
  }
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// K2. Replaces pallas_filters.py fused_stage2_tl (_fused_stage2_kernel_win)
// and fused_stage2_wide_tl (_fused_stage2_kernel_wide), and the predict
// direction of lms_filter_tl (_lms_kernel): the long-term FIR predict, then
// the LMS predict, any lag up to 258 and T = 0 included. Bound on this card:
// the LMS chain (about 125 integer operations a sample, one sample after
// another). The FIR reads only its input, so it leaves that chain: warps 2
// and 3 compute it for a whole tile, lanes over samples, from a per-row
// input ring in shared memory that keeps the 258 samples before the tile;
// warp 1 then runs only the LMS chain over the FIR's tile.
template <int T, int M>
__global__ void __launch_bounds__(kPipeThreads)
stage2_predict_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                      const int32_t* __restrict__ md,
                      const int32_t* __restrict__ q15, int B, int L, int nt,
                      int m) {
  extern __shared__ int32_t smem[];
  const sla::Stage2Pipe pipe(smem, L);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * sla::kGroup;
  const int rows = min(sla::kGroup, B - row0);
  const int iters = pipe.iterations();
  if (warp == 0) {
    for (int it = 0; it < iters; ++it) {
      produce(pipe, it, x, y, row0, rows, lane);
      pipe_barrier();
    }
  } else if (warp == 1) {
    sla::Tiled<sla::LmsStep<M, false>> lms(m);
    for (int it = 0; it < iters; ++it) {
      if (lane < rows) pipe.lms(lms, it, lane);
      pipe_barrier();
    }
  } else {
    for (int it = 0; it < iters; ++it) {
      for (int r = warp - 2; r < rows; r += 2) {
        const int32_t* q = q15 + (int64_t)(row0 + r) * nt;
        pipe.fir<T>(it, r, lane, 32, md[row0 + r], q, nt);
      }
      pipe_barrier();
    }
  }
}

// K3. Replaces pallas_filters.py fused_synth_tl (_fused_synth_kernel,
// _fused_synth_kernel_win) and fused_synth_wide_tl
// (_fused_synth_kernel_wide): LMS synth, long-term synth, lattice synth and
// de-emphasis. Bound on this card: the longest stage's per-sample chain
// (about 125 integer operations for LMS, 128 for the lattice at p 16). No
// stage reads a later stage's output, so each runs on its own warp for the
// same 32 rows (warp 1 LMS, warp 2 long-term, warp 3 lattice + de-emphasis)
// and a tile's time is the slowest stage's, not the sum of the three. The
// long-term history is a 512-slot ring per row in shared memory (lags are
// at most 258), so its read costs a shared-memory load instead of a device
// memory store -> load round trip a sample.
template <int P, int T, int M>
__global__ void __launch_bounds__(kPipeThreads)
synth_cascade_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                     const int32_t* __restrict__ coef,
                     const int32_t* __restrict__ md,
                     const int32_t* __restrict__ q15, int B, int L, int p,
                     int nt, int m) {
  extern __shared__ int32_t smem[];
  const sla::SynthPipe pipe(smem, L);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * sla::kGroup;
  const int rows = min(sla::kGroup, B - row0);
  const bool live = lane < rows;
  const int64_t row = row0 + (live ? lane : 0);  // idle lanes hold row0's parameters
  const int iters = pipe.iterations();
  if (warp == 0) {
    for (int it = 0; it < iters; ++it) {
      produce(pipe, it, x, y, row0, rows, lane);
      pipe_barrier();
    }
  } else if (warp == 1) {
    sla::Tiled<sla::LmsSynth<M>> lms(m);
    for (int it = 0; it < iters; ++it) {
      if (live) pipe.lms(lms, it, lane);
      pipe_barrier();
    }
  } else if (warp == 2) {
    sla::LongtermSynthRing<T> lt(pipe.ring_row(lane), md[row], q15 + row * nt, nt);
    for (int it = 0; it < iters; ++it) {
      if (live) pipe.longterm(lt, it, lane);
      pipe_barrier();
    }
  } else {
    sla::Tiled<sla::LatticeSynth<P, true>> lattice(coef + row * p, p);
    for (int it = 0; it < iters; ++it) {
      if (live) pipe.lattice(lattice, it, lane);
      pipe_barrier();
    }
  }
}

// K4. Replaces pallas_filters.py fused_encode_tl (_fused_encode_kernel_win)
// and fused_encode_wide_tl (_fused_encode_kernel_wide): pre-emphasis,
// lattice predict, long-term FIR predict and LMS predict in one pass, one
// read of x and one write of y per sample instead of K1's and K2's two
// each. Bound on this card: the LMS predict chain, as in K2. K2's pipeline
// (sla::EncodePipe) with stage 1 as a role ahead of the FIR: warp 0 loads x
// tiles and stores y tiles, warp 1 runs only the LMS chain, and five warps
// run stage 1 on K1's lane schedule (one row's tile at a time, lanes over
// samples) into the per-row ring, then the FIR from it. Five, so that stage
// 1 at p 32 (twice p 16's stages) still hides under the LMS chain; warp 5
// only meets the barrier, because it would share the LMS warp's scheduler
// (warp % 4). The FIR's history is the stage-1 residual in the ring, so a
// tap at or ahead of n reads this sample's residual: every lag and T = 0
// take the same kernel, with no window plan or lag sort.
template <int P, int T, int M>
__global__ void __launch_bounds__(kEncodeThreads)
fused_encode_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                    const int32_t* __restrict__ coef,
                    const int32_t* __restrict__ md,
                    const int32_t* __restrict__ q15, int B, int L, int p,
                    int nt, int m) {
  extern __shared__ int32_t smem[];
  const sla::EncodePipe pipe(smem, L);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * sla::kGroup;
  const int rows = min(sla::kGroup, B - row0);
  const int iters = pipe.iterations();
  if (warp == 0) {
    for (int it = 0; it < iters; ++it) {
      produce(pipe, it, x, y, row0, rows, lane);
      pipe_barrier<kEncodeThreads>();
    }
  } else if (warp == 1) {
    sla::Tiled<sla::LmsStep<M, false>> lms(m);
    for (int it = 0; it < iters; ++it) {
      if (lane < rows) pipe.lms(lms, it, lane);
      pipe_barrier<kEncodeThreads>();
    }
  } else if (warp == 5) {
    for (int it = 0; it < iters; ++it) pipe_barrier<kEncodeThreads>();
  } else {
    const int first = warp < 5 ? warp - 2 : warp - 3;  // 0 .. kStage1Warps - 1
    const sla::WarpLanes lanes{lane};
    // the first barrier orders these before stage 1's first tile (it = kStage1)
    for (int r = first; r < rows; r += kStage1Warps) pipe.clear(r, lane, 32);
    for (int it = 0; it < iters; ++it) {
      for (int r = first; r < rows; r += kStage1Warps)
        pipe.stage1<P>(lanes, it, r, coef + (int64_t)(row0 + r) * p, p);
      for (int r = first; r < rows; r += kStage1Warps) {
        const int32_t* q = q15 + (int64_t)(row0 + r) * nt;
        pipe.fir<T>(it, r, lane, 32, md[row0 + r], q, nt);
      }
      pipe_barrier<kEncodeThreads>();
    }
  }
}

// K5. Replaces pallas_filters.py lattice_filter_tl(synthesize=True)
// (_lattice_synth_body) and lattice_filter_wide_tl(synthesize=True): PARCOR
// lattice synthesis, then de-emphasis when EMPH (the Pallas pre_emphasis
// flag). Bound on this card: latency. A thread per row walks the lattice's
// feedback at 8p + 3 instructions a sample (202 cycles a sample at p 16 on
// the H100); this kernel walks it in steps of a shuffle round trip and a
// chain four to six instructions deep, two steps a sample (about 120
// cycles; tools/synth_probe.cu). A block is one warp and runs the systolic
// schedule of filters.cuh ("K5") on 64 / G rows: lanes over stages, G lanes
// and S stages a lane for two rows, one step of two shuffles and about
// 6 S + 10 instructions. Every
// order up to 32 runs at G 16, S 2 (up to 48 at S 3): 2,048 rows make 512
// warps, about one for each of the 528 schedulers. The rows are read and
// written in the (B, L) layout, a chunk of 32 samples a row at a time.
template <int G, int S, bool EMPH>
__global__ void __launch_bounds__(32)
lattice_synth_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                     const int32_t* __restrict__ coef, int B, int L, int p) {
  __shared__ int32_t rings[sla::SysShape<G>::kWords];
  const int64_t row0 = (int64_t)blockIdx.x * sla::SysShape<G>::kRows;
  const sla::WarpLanes lanes{(int)threadIdx.x};
  sla::lattice_synth_warp<G, S, EMPH>(lanes, x, y, B, L, row0, coef, p, rings, false);
}

template <class Config>
int launch_lattice_synth(const int32_t* x, int32_t* y, const int32_t* coef, int B, int L, int p,
                         bool emphasis, cudaStream_t s) {
  constexpr int G = Config::G, S = Config::S;
  const dim3 g((unsigned)(((int64_t)B + sla::SysShape<G>::kRows - 1) / sla::SysShape<G>::kRows));
  if (emphasis) {
    lattice_synth_kernel<G, S, true><<<g, 32, 0, s>>>(x, y, coef, B, L, p);
  } else {
    lattice_synth_kernel<G, S, false><<<g, 32, 0, s>>>(x, y, coef, B, L, p);
  }
  return (int)cudaGetLastError();
}

// K6. Replaces pallas_filters.py lms_filter_tl(synthesize=True)
// (_lms_kernel_body): sign-sign LMS synthesis; order 0 passes through.
// Bound on this card: the chain, one lane per row, so L samples times the
// chain's issue cycles a sample. K3's pipeline scheme (sla::LmsSynthPipe):
// warp 0 prefetches the (B, L) rows with cp.async and stores finished
// tiles (produce_whole); warps 2 and 3 compute each sample's step for a
// whole tile, lanes over samples, one iteration ahead of the chain (the
// step reads only the input); warp 1 runs only the chain, alone on its
// scheduler (warp % 4). At the preset orders (4, 8) the chain is
// sla::LmsSynthChain<M>: about 4M + 12 instructions a sample (the 2M dot
// products, 2M one-multiply-add weight updates against signs kept beside
// the history, two signs, the shared-memory accesses), against about 130
// in the Lms body; it runs at about two cycles an instruction, 84 cycles
// a sample at M 8 on the H100 (tools/synth_probe.cu). A run-time order
// keeps the Lms body.
template <int M>
__global__ void __launch_bounds__(kPipeThreads)
lms_synth_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y, int B, int L, int m) {
  extern __shared__ int32_t smem[];
  const sla::LmsSynthPipe pipe(smem, L);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * sla::kGroup;
  const int rows = min(sla::kGroup, B - row0);
  const int iters = pipe.iterations();
  if (warp == 0) {
    for (int it = 0; it < iters; ++it) {
      produce_whole(pipe, it, x, y, row0, rows, lane);
      pipe_barrier();
    }
  } else if (warp == 1) {
    sla::LmsSynthChain<M> chain(m);
    for (int it = 0; it < iters; ++it) {
      if (lane < rows) pipe.chain(chain, it, lane);
      pipe_barrier();
    }
  } else {
    for (int it = 0; it < iters; ++it) {
      for (int r = warp - 2; r < rows; r += 2) pipe.prep(it, r, lane, 32, m);
      pipe_barrier();
    }
  }
}

// K7. Replaces pallas_filters.py longterm_synth_tl (_longterm_synth_kernel,
// _longterm_synth_kernel_win): long-term synthesis over the stage's own
// output. Bound on this card: the bytes, one read and one write of each
// sample, once the samples of a step run in parallel; for rows whose
// smallest lag d is short, the L / d dependent steps. A warp per row
// (sla::longterm_row): 2,048 rows give 2,048 warps on every SM instead of
// 16 blocks of one thread per row. The row's input is staged and its
// output history kept in a kLtRing-slot ring in shared memory per warp,
// read and written conflict-free (lane l, slot n0 + l + 32 v); the input
// arrives in chunks loaded two ahead; rows with md <= 8 run one serial
// lane with the history in registers. The (B, L) rows are read and written
// directly, coalesced: no transposes, no one-hot select, no 12-bit limbs,
// no device scratch.
template <int T>
__global__ void __launch_bounds__(kThreads)
longterm_synth_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                      const int32_t* __restrict__ md, const int32_t* __restrict__ q15, int B,
                      int L, int nt) {
  __shared__ __align__(16) int32_t ring[kWarps][sla::kLtRing];  // 16-byte serial accesses
  const int warp = threadIdx.x >> 5;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= B) return;  // whole warps: the steps meet at __syncwarp
  const sla::WarpLanes lanes{(int)(threadIdx.x & 31)};
  sla::longterm_row<T>(lanes, x + row * L, y + row * L, L, ring[warp], md[row],
                       q15 + row * nt, nt, false);
}

// Launches a pipeline kernel of `threads` threads a block with `words`
// int32 of dynamic shared memory (above the 48 KB default, so the kernel is
// allowed it first), one block per row group.
template <class... KArgs, class... Args>
int launch_pipe(void (*kernel)(KArgs...), int threads, int words, int B, cudaStream_t s,
                Args... args) {
  const size_t bytes = (size_t)words * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((B + sla::kGroup - 1) / sla::kGroup));
  kernel<<<grid, threads, bytes, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() as an int
// (0 = cudaSuccess); it neither allocates nor synchronizes.
extern "C" {

// K1: the preset orders with emphasis are templated; emphasis off (no
// caller on the codec's path) takes the run-time order.
int sla_lattice_predict(const int32_t* x, int32_t* y, const int32_t* coef,
                        int B, int L, int p, int emphasis, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int seg = sla::segment_length(p);
  const int nseg = (L + seg - 1) / seg;
  const dim3 g((unsigned)(((int64_t)B * nseg + kWarps - 1) / kWarps));
  if (!emphasis) {
    lattice_predict_kernel<0, false><<<g, kThreads, 0, s>>>(x, y, coef, B, L, p, seg, nseg);
  } else if (p == 8) {
    lattice_predict_kernel<8, true><<<g, kThreads, 0, s>>>(x, y, coef, B, L, p, seg, nseg);
  } else if (p == 16) {
    lattice_predict_kernel<16, true><<<g, kThreads, 0, s>>>(x, y, coef, B, L, p, seg, nseg);
  } else if (p == 32) {
    lattice_predict_kernel<32, true><<<g, kThreads, 0, s>>>(x, y, coef, B, L, p, seg, nseg);
  } else {
    lattice_predict_kernel<0, true><<<g, kThreads, 0, s>>>(x, y, coef, B, L, p, seg, nseg);
  }
  return (int)cudaGetLastError();
}

// K5: the configuration that covers order p (sla::synth_config), with or
// without de-emphasis
int sla_lattice_synth(const int32_t* x, int32_t* y, const int32_t* coef,
                      int B, int L, int p, int emphasis, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (sla::synth_config(p) == 32)
    return launch_lattice_synth<sla::SynthConfig<32>>(x, y, coef, B, L, p, emphasis, s);
  return launch_lattice_synth<sla::SynthConfig<48>>(x, y, coef, B, L, p, emphasis, s);
}

// Shared memory of a kernel's block, in bytes: 2, 3, 4 and 6 for the
// pipelines K2, K3, K4 and K6 (dynamic), 5 for K5's rings up to p 32 and 7 for
// K7's (static), 0 otherwise.
int sla_pipe_shared_bytes(int kernel) {
  const int words = kernel == 2 ? sla::Stage2Pipe::kWords
                  : kernel == 3 ? sla::SynthPipe::kWords
                  : kernel == 4 ? sla::EncodePipe::kWords
                  : kernel == 5 ? sla::SysShape<sla::SynthConfig<32>::G>::kWords
                  : kernel == 6 ? sla::LmsSynthPipe::kWords
                  : kernel == 7 ? kWarps * sla::kLtRing : 0;
  return words * (int)sizeof(int32_t);
}

int sla_stage2_predict(const int32_t* x, int32_t* y, const int32_t* md,
                       const int32_t* q15, int B, int L, int nt, int m,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int words = sla::Stage2Pipe::kWords;
  if (nt == 1 && m == 4) {
    return launch_pipe(stage2_predict_kernel<1, 4>, kPipeThreads, words, B, s, x, y, md, q15, B, L, nt, m);
  } else if (nt == 1 && m == 8) {
    return launch_pipe(stage2_predict_kernel<1, 8>, kPipeThreads, words, B, s, x, y, md, q15, B, L, nt, m);
  } else if (nt == 3 && m == 8) {
    return launch_pipe(stage2_predict_kernel<3, 8>, kPipeThreads, words, B, s, x, y, md, q15, B, L, nt, m);
  }
  return launch_pipe(stage2_predict_kernel<0, 0>, kPipeThreads, words, B, s, x, y, md, q15, B, L, nt, m);
}

int sla_synth_cascade(const int32_t* x, int32_t* y, const int32_t* coef,
                      const int32_t* md, const int32_t* q15, int B, int L,
                      int p, int nt, int m, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int words = sla::SynthPipe::kWords;
  if (p == 8 && nt == 1 && m == 4) {  // preset 0
    return launch_pipe(synth_cascade_kernel<8, 1, 4>, kPipeThreads, words, B, s, x, y, coef, md, q15, B, L, p, nt, m);
  } else if (p == 8 && nt == 1 && m == 8) {  // preset 1
    return launch_pipe(synth_cascade_kernel<8, 1, 8>, kPipeThreads, words, B, s, x, y, coef, md, q15, B, L, p, nt, m);
  } else if (p == 16 && nt == 1 && m == 8) {  // preset 2
    return launch_pipe(synth_cascade_kernel<16, 1, 8>, kPipeThreads, words, B, s, x, y, coef, md, q15, B, L, p, nt, m);
  } else if (p == 32 && nt == 3 && m == 8) {  // presets 3 and 4
    return launch_pipe(synth_cascade_kernel<32, 3, 8>, kPipeThreads, words, B, s, x, y, coef, md, q15, B, L, p, nt, m);
  }
  return launch_pipe(synth_cascade_kernel<0, 0, 0>, kPipeThreads, words, B, s, x, y, coef, md, q15, B, L, p, nt, m);
}

int sla_fused_encode(const int32_t* x, int32_t* y, const int32_t* coef, const int32_t* md,
                     const int32_t* q15, int B, int L, int p, int nt, int m,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int words = sla::EncodePipe::kWords;
  if (p == 8 && nt == 1 && m == 4) {  // preset 0
    return launch_pipe(fused_encode_kernel<8, 1, 4>, kEncodeThreads, words, B, s, x, y, coef, md, q15, B, L, p, nt, m);
  } else if (p == 8 && nt == 1 && m == 8) {  // preset 1
    return launch_pipe(fused_encode_kernel<8, 1, 8>, kEncodeThreads, words, B, s, x, y, coef, md, q15, B, L, p, nt, m);
  } else if (p == 16 && nt == 1 && m == 8) {  // preset 2
    return launch_pipe(fused_encode_kernel<16, 1, 8>, kEncodeThreads, words, B, s, x, y, coef, md, q15, B, L, p, nt, m);
  } else if (p == 32 && nt == 3 && m == 8) {  // presets 3 and 4
    return launch_pipe(fused_encode_kernel<32, 3, 8>, kEncodeThreads, words, B, s, x, y, coef, md, q15, B, L, p, nt, m);
  }
  return launch_pipe(fused_encode_kernel<0, 0, 0>, kEncodeThreads, words, B, s, x, y, coef, md, q15, B, L, p, nt, m);
}

int sla_lms_synth(const int32_t* x, int32_t* y, int B, int L, int m, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int words = sla::LmsSynthPipe::kWords;
  if (m == 4) return launch_pipe(lms_synth_kernel<4>, kPipeThreads, words, B, s, x, y, B, L, m);
  if (m == 8) return launch_pipe(lms_synth_kernel<8>, kPipeThreads, words, B, s, x, y, B, L, m);
  return launch_pipe(lms_synth_kernel<0>, kPipeThreads, words, B, s, x, y, B, L, m);
}

int sla_longterm_synth(const int32_t* x, int32_t* y, const int32_t* md, const int32_t* q15,
                       int B, int L, int nt, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 g((unsigned)(((int64_t)B + kWarps - 1) / kWarps));
  switch (nt) {
    case 1: longterm_synth_kernel<1><<<g, kThreads, 0, s>>>(x, y, md, q15, B, L, nt); break;
    case 3: longterm_synth_kernel<3><<<g, kThreads, 0, s>>>(x, y, md, q15, B, L, nt); break;
    default: longterm_synth_kernel<0><<<g, kThreads, 0, s>>>(x, y, md, q15, B, L, nt); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
