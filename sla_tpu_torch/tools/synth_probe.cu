// Where K6 (lms_synth) and K7 (longterm_synth) spend their time on the card:
// the numbers behind their designs in PERF.md. Build and run it from the
// repository root on a machine with the GPU:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -I sla_tpu_torch/csrc \
//        -o build/synth_probe sla_tpu_torch/tools/synth_probe.cu && build/synth_probe
//
// 1. K6's chain alone: cycles a sample of one warp running
//    sla::LmsSynthChain<M>::tile over tiles in shared memory (clock64), 64
//    blocks of one warp, M 8 and 4.
// 2. K6's pipeline at 2,048 x 12,288 with roles switched off, its producer
//    as produce() (the loops K2-K4 use) or produce_whole() (K6's).
// 3. K7 at 2,048 x 12,288 where every row has the same delay md, T 1 and 3:
//    which delays set the kernel's time.
// Times are CUDA events over 10 launches after one.
#include <cstdio>
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

}  // namespace

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("device: %s\n", prop.name);
  const size_t n = (size_t)kRows * kSamples;
  int32_t *x, *y, *md, *q15;
  long long* cycles;
  cudaMalloc(&x, n * 4);
  cudaMalloc(&y, n * 4);
  cudaMalloc(&md, kRows * 4);
  cudaMalloc(&q15, kRows * 3 * 4);
  cudaMalloc(&cycles, 64 * sizeof(long long));
  std::vector<int32_t> h(n);
  for (size_t i = 0; i < n; ++i) h[i] = (int32_t)((i * 2654435761u) >> 11) - (1 << 20);
  cudaMemcpy(x, h.data(), n * 4, cudaMemcpyHostToDevice);
  std::vector<int32_t> q(kRows * 3, 12345);
  cudaMemcpy(q15, q.data(), q.size() * 4, cudaMemcpyHostToDevice);

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
