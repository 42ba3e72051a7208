// Where K5 (lattice_synth), K6 (lms_synth) and K7 (longterm_synth) spend
// their time on the card: the numbers behind their designs in PERF.md.
// Build and run it from the repository root on a machine with the GPU:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -I sla_tpu_torch/csrc \
//        -o build/synth_probe sla_tpu_torch/tools/synth_probe.cu && build/synth_probe [k5-cycles]
//
// With the argument k5-cycles it runs part 4 alone; without, parts 1-5:
//
// 1. K6's chain alone: cycles a sample of one warp running
//    sla::LmsSynthChain<M>::tile over tiles in shared memory (clock64), 64
//    blocks of one warp, M 8 and 4.
// 2. K6's pipeline at 2,048 x 12,288 with roles switched off, its producer
//    as produce() (the loops K2-K4 use) or produce_whole() (K6's).
// 3. K7 at 2,048 x 12,288 where every row has the same delay md, T 1 and 3:
//    which delays set the kernel's time.
// 4. K5's step: a shuffle round trip, one stage between two shuffles, and
//    K5's steps without loads or stores, in cycles (clock64); then cycles a
//    sample of one warp running the whole schedule
//    (sla::lattice_synth_warp) on its 64 / G rows of 4,096 samples, 64
//    blocks of one warp, for p 8, 16, 32 and 48 at several (G lanes a row
//    pair, S stages a lane); and the one-thread chain it replaces
//    (sla::LatticeSynth<P, true>, as K3's lattice role runs it) alone over
//    tiles in shared memory.
// 5. K5 at 2,048 x 12,288 with emphasis in each of those configurations.
// Times are CUDA events over 10 launches after one.
#include <cstdio>
#include <string>
#include <vector>

#include "filters.cu"

namespace {

constexpr int kRows = 2048, kSamples = 12288;

template <int M>
__global__ void chain_cycles(const int32_t* x, int32_t* y, long long* cycles, int tiles) {
  __shared__ int32_t in[sla::kTileWords], st[sla::kTileWords], out[sla::kTileWords];
  const int lane = threadIdx.x, at = lane * sla::kTilePitch;
  for (int j = 0; j < sla::kTile; ++j) {
    const int32_t v = x[(blockIdx.x * 32 + lane) * sla::kTile + j];
    in[at + j] = v;
    st[at + j] = sla::sgn(v) * (sla::bit_length(sla::magnitude(v)) >> 1);
  }
  __syncwarp();
  sla::LmsSynthChain<M> chain(M);
  const long long t0 = clock64();
  for (int t = 0; t < tiles; ++t) chain.tile(in + at, st + at, out + at, t, sla::kTile);
  const long long t1 = clock64();
  y[blockIdx.x * 32 + lane] = out[at + lane];
  if (lane == 0) cycles[blockIdx.x] = t1 - t0;
}

// lms_synth_kernel<8> with its roles switched on or off and either producer
template <bool WHOLE, bool CHAIN, bool PREP>
__global__ void __launch_bounds__(kPipeThreads)
k6_roles(const int32_t* __restrict__ x, int32_t* __restrict__ y, int B, int L) {
  extern __shared__ int32_t smem[];
  const sla::LmsSynthPipe pipe(smem, L);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * sla::kGroup;
  const int rows = min(sla::kGroup, B - row0);
  const int iters = pipe.iterations();
  sla::LmsSynthChain<8> chain(8);
  for (int it = 0; it < iters; ++it) {
    if (warp == 0) {
      if (WHOLE) {
        produce_whole(pipe, it, x, y, row0, rows, lane);
      } else {
        produce(pipe, it, x, y, row0, rows, lane);
      }
    } else if (warp == 1) {
      if (CHAIN && lane < rows) pipe.chain(chain, it, lane);
    } else if (PREP) {
      for (int r = warp - 2; r < rows; r += 2) pipe.prep(it, r, lane, 32, 8);
    }
    pipe_barrier();
  }
}

template <class F>
float time_ms(F launch) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  launch();
  cudaEventRecord(a);
  for (int i = 0; i < 10; ++i) launch();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0;
  cudaEventElapsedTime(&ms, a, b);
  return ms / 10;
}

template <int M>
void chain_alone(const int32_t* x, int32_t* y, long long* cycles) {
  const int blocks = 64, tiles = 64;
  chain_cycles<M><<<blocks, 32>>>(x, y, cycles, tiles);
  std::vector<long long> c(blocks);
  cudaMemcpy(c.data(), cycles, blocks * sizeof(long long), cudaMemcpyDeviceToHost);
  double sum = 0;
  for (long long v : c) sum += (double)v;
  printf("K6 chain alone, M %d: %.1f cycles a sample\n", M, sum / blocks / (tiles * sla::kTile));
}

template <bool WHOLE, bool CHAIN, bool PREP>
void k6(const char* what, const int32_t* x, int32_t* y) {
  const int bytes = sla::LmsSynthPipe::kWords * (int)sizeof(int32_t);
  auto kernel = k6_roles<WHOLE, CHAIN, PREP>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const float ms = time_ms([&] {
    kernel<<<(kRows + sla::kGroup - 1) / sla::kGroup, kPipeThreads, bytes>>>(x, y, kRows, kSamples);
  });
  printf("K6 M 8, producer %s, %s: %.3f ms\n", WHOLE ? "produce_whole" : "produce", what, ms);
}

// K5's schedule alone: one warp on its 64 / G rows of L samples
template <int G, int S>
__global__ void synth_cycles(const int32_t* x, int32_t* y, const int32_t* coef, long long* cycles,
                             int L, int p) {
  __shared__ int32_t rings[sla::SysShape<G>::kWords];
  constexpr int R = sla::SysShape<G>::kRows;
  const sla::WarpLanes lanes{(int)threadIdx.x};
  const int64_t row0 = (int64_t)blockIdx.x * R;
  const long long t0 = clock64();
  sla::lattice_synth_warp<G, S, true>(lanes, x, y, (int)gridDim.x * R, L, row0, coef, p, rings,
                                      false);
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

// What a K5 step costs without its loads and stores: a shuffle round trip
// (a value around the warp, one add a hop), one lattice stage between two
// shuffles (f down, b up), and K5's steps alone (SysStages, the rotations,
// the top lane's selects; no shared memory, no device memory)
__global__ void shuffle_ring(int32_t* y, long long* cycles, int iters) {
  const int lane = threadIdx.x;
  int32_t v = lane;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) v = __shfl_sync(0xffffffffu, v, (lane + 1) & 31) + 1;
  const long long t1 = clock64();
  y[lane] = v;
  if (lane == 0) cycles[blockIdx.x] = t1 - t0;
}

__global__ void shuffle_stage(int32_t* y, long long* cycles, int iters, int32_t c) {
  const int lane = threadIdx.x;
  int32_t f = lane, b = 3 * lane;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    const int32_t fo = sla::wadd(f, sla::qmul(c, b));
    const int32_t bo = sla::wsub(b, sla::qmul(c, fo));
    f = __shfl_sync(0xffffffffu, fo, (lane + 1) & 31);
    b = __shfl_sync(0xffffffffu, bo, (lane + 31) & 31);
  }
  const long long t1 = clock64();
  y[lane] = f + b;
  if (lane == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int G, int S>
__global__ void steps_only(int32_t* y, const int32_t* coef, long long* cycles, int pairs) {
  const int lane = threadIdx.x, k = lane % G;
  const sla::WarpLanes lanes{lane};
  sla::SysStages<S> st[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      st[h].c[j] = coef[lane * S + j + h];
      st[h].b[j] = 0;
    }
  }
  int32_t fin = 0, bin = 0, acc = 0;
  const long long t0 = clock64();
  for (int u = 0; u < pairs; ++u) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int32_t bout;
      const int32_t f = st[h].step(k == G - 1 ? u : fin, bin, bout);
      int32_t fo = f, bo = k == G - 1 ? fin : bout;
      acc += f;
      lanes.rotate_back<G>(&fo);
      lanes.rotate<G>(&bo);
      fin = fo;
      bin = bo;
    }
  }
  const long long t1 = clock64();
  y[blockIdx.x * 32 + lane] = acc;
  if (lane == 0) cycles[blockIdx.x] = t1 - t0;
}

// the one-thread chain: 32 rows a warp, K3's lattice role over tiles
template <int P>
__global__ void chain_lattice_cycles(const int32_t* x, int32_t* y, const int32_t* coef,
                                     long long* cycles, int tiles) {
  __shared__ int32_t in[sla::kTileWords], out[sla::kTileWords];
  const int lane = threadIdx.x, at = lane * sla::kTilePitch;
  for (int j = 0; j < sla::kTile; ++j) in[at + j] = x[(blockIdx.x * 32 + lane) * sla::kTile + j];
  __syncwarp();
  sla::Tiled<sla::LatticeSynth<P, true>> chain(coef + (blockIdx.x * 32 + lane) * P, P);
  const long long t0 = clock64();
  for (int t = 0; t < tiles; ++t) chain.tile(in + at, out + at, t * sla::kTile, sla::kTile);
  const long long t1 = clock64();
  y[blockIdx.x * 32 + lane] = out[at + lane];
  if (lane == 0) cycles[blockIdx.x] = t1 - t0;
}

double mean_cycles(const long long* dev, int blocks) {
  std::vector<long long> c(blocks);
  cudaMemcpy(c.data(), dev, blocks * sizeof(long long), cudaMemcpyDeviceToHost);
  double sum = 0;
  for (long long v : c) sum += (double)v;
  return sum / blocks;
}

template <int G, int S>
void k5_alone(int p, const int32_t* x, int32_t* y, const int32_t* coef, long long* cycles) {
  const int blocks = 64, L = 4096;
  synth_cycles<G, S><<<blocks, 32>>>(x, y, coef, cycles, L, p);
  printf("K5 step alone, p %d, G %d, S %d, %d rows a warp: %.1f cycles a sample\n", p, G, S,
         sla::SysShape<G>::kRows, mean_cycles(cycles, blocks) / L);
}

template <int P>
void chain_lattice_alone(const int32_t* x, int32_t* y, const int32_t* coef, long long* cycles) {
  const int blocks = 64, tiles = 64;
  chain_lattice_cycles<P><<<blocks, 32>>>(x, y, coef, cycles, tiles);
  printf("K5 one-thread chain alone (LatticeSynth), p %d: %.1f cycles a sample\n", P,
         mean_cycles(cycles, blocks) / (tiles * sla::kTile));
}

template <int G, int S>
void k5_kernel(int p, const int32_t* x, int32_t* y, const int32_t* coef) {
  const dim3 g((kRows + sla::SysShape<G>::kRows - 1) / sla::SysShape<G>::kRows);
  const float ms = time_ms([&] { lattice_synth_kernel<G, S, true><<<g, 32>>>(x, y, coef, kRows, kSamples, p); });
  printf("K5 2,048 x 12,288, p %d, G %d, S %d: %.3f ms\n", p, G, S, ms);
}

void k5_cycles(const int32_t* x, int32_t* y, const int32_t* coef, long long* cycles) {
  const int blocks = 64, iters = 8192;
  shuffle_ring<<<blocks, 32>>>(y, cycles, iters);
  printf("shuffle round trip (SHFL + IADD): %.1f cycles\n", mean_cycles(cycles, blocks) / iters);
  shuffle_stage<<<blocks, 32>>>(y, cycles, iters, 12345);
  printf("one stage between two shuffles: %.1f cycles a step\n", mean_cycles(cycles, blocks) / iters);
  steps_only<16, 1><<<blocks, 32>>>(y, coef, cycles, iters);
  printf("K5 steps alone, G 16, S 1: %.1f cycles a sample\n", mean_cycles(cycles, blocks) / iters);
  steps_only<8, 2><<<blocks, 32>>>(y, coef, cycles, iters);
  printf("K5 steps alone, G 8, S 2: %.1f cycles a sample\n", mean_cycles(cycles, blocks) / iters);
  steps_only<16, 2><<<blocks, 32>>>(y, coef, cycles, iters);
  printf("K5 steps alone, G 16, S 2: %.1f cycles a sample\n", mean_cycles(cycles, blocks) / iters);
  k5_alone<8, 1>(8, x, y, coef, cycles);
  k5_alone<4, 2>(8, x, y, coef, cycles);
  k5_alone<2, 4>(8, x, y, coef, cycles);
  k5_alone<16, 1>(16, x, y, coef, cycles);
  k5_alone<8, 2>(16, x, y, coef, cycles);
  k5_alone<4, 4>(16, x, y, coef, cycles);
  k5_alone<32, 1>(32, x, y, coef, cycles);
  k5_alone<16, 2>(32, x, y, coef, cycles);
  k5_alone<8, 4>(32, x, y, coef, cycles);
  k5_alone<32, 2>(48, x, y, coef, cycles);
  k5_alone<16, 3>(48, x, y, coef, cycles);
  k5_alone<8, 6>(48, x, y, coef, cycles);
  chain_lattice_alone<8>(x, y, coef, cycles);
  chain_lattice_alone<16>(x, y, coef, cycles);
  chain_lattice_alone<32>(x, y, coef, cycles);
}

void k5_kernels(const int32_t* x, int32_t* y, const int32_t* coef) {
  k5_kernel<8, 1>(8, x, y, coef);
  k5_kernel<4, 2>(8, x, y, coef);
  k5_kernel<2, 4>(8, x, y, coef);
  k5_kernel<16, 1>(16, x, y, coef);
  k5_kernel<8, 2>(16, x, y, coef);
  k5_kernel<4, 4>(16, x, y, coef);
  k5_kernel<32, 1>(32, x, y, coef);
  k5_kernel<16, 2>(32, x, y, coef);
  k5_kernel<8, 4>(32, x, y, coef);
  k5_kernel<32, 2>(48, x, y, coef);
  k5_kernel<16, 3>(48, x, y, coef);
  k5_kernel<8, 6>(48, x, y, coef);
}

}  // namespace

int main(int argc, char** argv) {
  const bool only_k5_cycles = argc > 1 && std::string(argv[1]) == "k5-cycles";
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("device: %s\n", prop.name);
  const size_t n = (size_t)kRows * kSamples;
  int32_t *x, *y, *md, *q15, *coef;
  long long* cycles;
  cudaMalloc(&x, n * 4);
  cudaMalloc(&y, n * 4);
  cudaMalloc(&md, kRows * 4);
  cudaMalloc(&q15, kRows * 3 * 4);
  cudaMalloc(&cycles, 64 * sizeof(long long));
  cudaMalloc(&coef, kRows * sla::kMaxParcor * 4);
  std::vector<int32_t> h(n);
  for (size_t i = 0; i < n; ++i) h[i] = (int32_t)((i * 2654435761u) >> 11) - (1 << 20);
  cudaMemcpy(x, h.data(), n * 4, cudaMemcpyHostToDevice);
  std::vector<int32_t> q(kRows * 3, 12345);
  cudaMemcpy(q15, q.data(), q.size() * 4, cudaMemcpyHostToDevice);
  std::vector<int32_t> c(kRows * sla::kMaxParcor);
  for (size_t i = 0; i < c.size(); ++i) c[i] = (int32_t)((i * 40503u) % 50001u) - 25000;
  cudaMemcpy(coef, c.data(), c.size() * 4, cudaMemcpyHostToDevice);

  k5_cycles(x, y, coef, cycles);
  if (only_k5_cycles) {
    const cudaError_t err = cudaDeviceSynchronize();
    printf("%s\n", cudaGetErrorString(err));
    return err == cudaSuccess ? 0 : 1;
  }
  k5_kernels(x, y, coef);

  chain_alone<8>(x, y, cycles);
  chain_alone<4>(x, y, cycles);
  k6<false, false, false>("producer alone", x, y);
  k6<true, false, false>("producer alone", x, y);
  k6<true, false, true>("producer and prep", x, y);
  k6<true, true, true>("all roles", x, y);
  for (int T : {1, 3}) {
    for (int d : {0, 1, 2, 4, 8, 9, 16, 32, 33, 64, 128, 258}) {
      std::vector<int32_t> m(kRows, d);
      cudaMemcpy(md, m.data(), kRows * 4, cudaMemcpyHostToDevice);
      const float ms = time_ms([&] { sla_longterm_synth(x, y, md, q15, kRows, kSamples, T, 0); });
      printf("K7 T %d, every row md %3d: %.3f ms\n", T, d, ms);
    }
  }
  const cudaError_t err = cudaDeviceSynchronize();
  printf("%s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
