// Where K8 (rice_encode_blocks) and K9 (rice_decode_blocks) spend their time
// on the card: the chains behind their designs in PERF.md. Build and run it
// from the repository root on a machine with the GPU:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -I sla_tpu_torch/csrc \
//        -o build/entropy_probe sla_tpu_torch/tools/entropy_probe.cu && build/entropy_probe
//
// Cycles (clock64) of one thread or one warp alone on the card, on three
// seeded streams of stereo symbols: every symbol on stage 0 (residual 0),
// every symbol on stage 1 without an escape (a constant residual of 1,500),
// and normal residuals of scale 3,000 (both stages, as the codec's blocks).
//
// 1. K9, cycles a symbol: the previous design's 64-bit cursor (a 64-bit
//    reservoir over the stream in global memory, one thread a block, kept
//    below as previous::decode_block); the new 32-bit cursor alone
//    (sla::rice::common_symbol over groups of kGroup stereo samples, as the
//    kernel runs them, on a ring that holds the payload's first 125 words:
//    no staging, no stores, no fallback); and the new warp schedule whole
//    (sla::rice::decode_block: staging ring, tile, coalesced stores).
// 2. K8, cycles a step of one lane's channel (32 lanes on 32 rows of 128
//    samples staged in shared memory, walked 32 times): the previous
//    design's count step and emit step (previous::encode_symbol with and
//    without its 64-bit word writer); the new parameter chain alone
//    (sla::rice::chain_step and the record's store); the chain with the
//    code length summed, as the chain pass runs it.
// 3. K9 whole at the main path's shape: 1,024 stereo blocks x 12,288 of
//    chip_smoke.py's kind (normal residuals, block scales 3,000 x 2^[-6, 6],
//    each sample times 1, 2, 4, 8 or 16), decoded with U = 1, 2 and 4
//    samples a block of code on the common path (CUDA events, 5 launches
//    after one), the rows checked against the residuals.
//
// `cuobjdump -sass build/entropy_probe` shows each loop's instructions.
#include <algorithm>
#include <cmath>
#include <cstdio>
#include <random>
#include <vector>

#include "entropy.cuh"

namespace previous {  // the previous design's 64-bit forms, for the comparison

using namespace sla::rice;

__device__ __forceinline__ int clz64(uint64_t x) { return __clzll((long long)x); }

struct WordWriter {
  uint32_t* out;
  uint64_t acc = 0;
  int n = 0;
  int64_t words = 0;
  __device__ explicit WordWriter(uint32_t* o) : out(o) {}
  __device__ void put(uint32_t v, int len) {
    acc = (acc << len) | v;
    n += len;
    if (n >= 32) {
      n -= 32;
      out[words++] = bswap32((uint32_t)(acc >> n));
    }
  }
};

template <bool EMIT>
__device__ __forceinline__ int encode_symbol(uint32_t& pa, uint32_t& pb, uint32_t u, WordWriter& w) {
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
  const uint32_t q = reduced >> b1;
  const uint32_t rest = reduced & ((1u << b1) - 1);
  if (q < kQuotThreshold - 1) {
    if (EMIT) {
      w.put(1, (int)q + 2);
      w.put(rest, b1);
    }
    return (int)q + 2 + b1;
  }
  const uint32_t gamma = q - (kQuotThreshold - 2);
  const int ndigit = 32 - clz32(gamma);
  if (EMIT) {
    w.put(1, kQuotThreshold + 1);
    w.put(0, ndigit - 1);
    w.put(gamma, ndigit);
    w.put(rest, b1);
  }
  return kQuotThreshold + 1 + 2 * ndigit - 1 + b1;
}

struct BitReader {
  const uint8_t* bytes;
  int64_t nwords;
  uint64_t buf;
  int n;
  int64_t next;
  uint32_t ahead;
  __device__ uint32_t word(int64_t i) const { return stream_word(bytes, nwords, i); }
  __device__ BitReader(const uint8_t* b, int64_t nw, int64_t bp) : bytes(b), nwords(nw) {
    const int64_t wi = bp >> 5;
    const int off = (int)(bp & 31);
    buf = (((uint64_t)word(wi) << 32) | word(wi + 1)) << off;
    n = 64 - off;
    next = wi + 2;
    ahead = word(next);
  }
  __device__ void refill() {
    if (n <= 32) {
      buf |= (uint64_t)ahead << (32 - n);
      n += 32;
      ahead = word(++next);
    }
  }
  __device__ uint32_t top(int k) const { return k ? (uint32_t)(buf >> (64 - k)) : 0u; }
  __device__ void skip(int k) {
    buf <<= k;
    n -= k;
  }
};

// stereo, every sample decoded (no count, no limit)
__device__ void decode_block(const uint8_t* bytes, int64_t nwords, int n, const int64_t* init,
                             int32_t* out) {
  uint32_t p0[2], p1[2];
  for (int c = 0; c < 2; ++c) p0[c] = p1[c] = param_init(init[c]);
  BitReader r(bytes, nwords, 0);
  int64_t bp = 0;
  for (int s = 0; s < n; ++s) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int b0 = rice_bits(p0[c]), b1 = rice_bits(p1[c]);
      r.refill();
      const int quot = clz64(r.buf);
      uint64_t quot_u = quot;
      r.skip(quot + 1);
      bp += quot + 1;
      if (quot == kQuotThreshold) {
        r.refill();
        const int gz = clz64(r.buf);
        r.skip(gz + 1);
        r.refill();
        quot_u += (1ull << gz) + r.top(gz) - 1;
        r.skip(gz);
        bp += 2 * gz + 1;
      }
      const int kb = quot ? b1 : b0;
      r.refill();
      const uint32_t rest = r.top(kb);
      r.skip(kb);
      bp += kb;
      const uint32_t k0 = 1u << b0;
      const uint32_t val = quot ? (uint32_t)(k0 + ((uint64_t)1 << b1) * (quot_u - 1) + rest) : rest;
      p0[c] = param_update(p0[c], val);
      if (quot) p1[c] = param_update(p1[c], val - k0);
      out[(int64_t)c * n + s] = unzigzag(val);
    }
  }
}

}  // namespace previous

namespace {

using namespace sla::rice;

constexpr int kSamples = 4096;  // a stream's samples a channel
constexpr int kRowTile = 128;   // K8's rows: 32 x 128 samples in shared memory, walked 32 times

// -- K9 -------------------------------------------------------------------------

__global__ void k9_previous(const uint8_t* bytes, int64_t nwords, const int64_t* init, int32_t* out,
                       long long* cycles) {
  const long long t0 = clock64();
  previous::decode_block(bytes, nwords, kSamples, init, out);
  cycles[0] = clock64() - t0;
}

// the cursor alone over the payload's first 125 words, `n` symbols
__global__ void k9_cursor(const uint8_t* bytes, int64_t nwords, const int64_t* init, int n,
                          int32_t* out, long long* cycles) {
  __shared__ uint32_t ring[kRingSlots];
  for (int i = threadIdx.x; i < kRingWords; i += 32) ring[i] = stream_word(bytes, nwords, i);
  __syncwarp();
  uint32_t p0[2], p1[2];
  for (int c = 0; c < 2; ++c) p0[c] = p1[c] = param_init(init[c]);
  uint32_t pos = 0;
  int32_t acc = 0;
  bool common = true;
  const long long t0 = clock64();
  for (int k = 0; k < n; k += 2 * kGroup) {  // a group of samples on the common path
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        int32_t v;
        common &= common_symbol(ring, pos, 0x7fffffffu, p0[c], p1[c], v);
        acc += v;
      }
    }
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = acc + common;
    cycles[0] = t1 - t0;
  }
}

template <int U>
__global__ void k9_blocks(const uint8_t* bytes, int64_t nwords, const int64_t* offsets, int W,
                          const int64_t* init, int n, int32_t* out, uint8_t* bad) {
  __shared__ uint32_t ring[kRingSlots];
  __shared__ int32_t tile[2 * kDecodeTile];
  const int b = blockIdx.x;
  const bool flagged =
      decode_block<2, U>(CudaWarp{(int)threadIdx.x}, bytes, nwords, offsets[b], W, n, n, 2,
                         init + 2 * b, out + (int64_t)b * 2 * n, ring, tile);
  if (threadIdx.x == 0) bad[b] = flagged;
}

__global__ void k9_warp(const uint8_t* bytes, int64_t nwords, const int64_t* init, int32_t* out,
                        uint8_t* bad, long long* cycles) {
  __shared__ uint32_t ring[kRingSlots];
  __shared__ int32_t tile[2 * kDecodeTile];
  const long long t0 = clock64();
  const bool flagged = decode_block<2>(CudaWarp{(int)threadIdx.x}, bytes, nwords, 0, 1 << 20,
                                       kSamples, kSamples, 2, init, out, ring, tile);
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    bad[0] = flagged;
    cycles[0] = t1 - t0;
  }
}

// -- K8 -------------------------------------------------------------------------

// MODE 0: the previous count step; 1: its emit step (64-bit writer); 2: the new
// chain alone with its record; 3: the new chain with the code length
template <int MODE>
__global__ void k8_steps(const int32_t* rows, const int64_t* init, uint32_t* words,
                         uint16_t* recs, long long* cycles) {
  __shared__ int32_t tile[32 * (kRowTile + 1)];
  __shared__ uint16_t rtile[32 * (kRowTile + 2)];
  const int lane = threadIdx.x;
  for (int r = 0; r < 32; ++r) {
    for (int j = lane; j < kRowTile; j += 32) tile[r * (kRowTile + 1) + j] = rows[r * kRowTile + j];
  }
  __syncwarp();
  uint32_t pa = param_init(init[lane]), pb = pa;
  previous::WordWriter w(words + (int64_t)lane * kSamples * 4);
  int64_t bits = 0;
  const int32_t* st = tile + lane * (kRowTile + 1);
  uint16_t* rt = rtile + lane * (kRowTile + 2);
  const long long t0 = clock64();
  for (int rep = 0; rep < kSamples / kRowTile; ++rep) {
#pragma unroll 8
    for (int j = 0; j < kRowTile; ++j) {
      const uint32_t u = zigzag(st[j]);
      if (MODE == 0) bits += previous::encode_symbol<false>(pa, pb, u, w);
      if (MODE == 1) bits += previous::encode_symbol<true>(pa, pb, u, w);
      if (MODE >= 2) {
        const uint32_t rec = chain_step(pa, pb, u);
        if (MODE == 3) bits += symbol_code(u, rec).len;
        rt[j] = (uint16_t)rec;
      }
    }
  }
  const long long t1 = clock64();
  __syncwarp();
  recs[lane] = rtile[lane * (kRowTile + 2) + lane] + (uint16_t)(bits + pa + pb);
  if (lane == 0) cycles[0] = t1 - t0;
}

// -- streams --------------------------------------------------------------------

// kind 0: residual 0; 1: residual 1,500; 2: normal, scale 3,000
std::vector<int32_t> residuals(int kind, int n, unsigned seed) {
  std::vector<int32_t> r(n, kind == 1 ? 1500 : 0);
  if (kind == 2) {
    std::mt19937 gen(seed);
    std::normal_distribution<double> d(0.0, 3000.0);
    for (auto& v : r) v = (int32_t)std::lround(d(gen));
  }
  return r;
}

// the stereo payload of residuals x[c][s] (channel-interleaved) as the host
// coder writes it, MSB-first words; end[k]: symbol k's last bit + 1
std::vector<uint32_t> encode_stereo(const std::vector<int32_t>* x, int n, const int64_t* init,
                                    std::vector<uint32_t>& end) {
  std::vector<uint32_t> words((size_t)n * 2 * kMaxSymbolBits / 32 + 4, 0u);
  uint32_t pa[2], pb[2];
  for (int c = 0; c < 2; ++c) pa[c] = pb[c] = param_init(init[c]);
  uint32_t pos = 0;
  for (int s = 0; s < n; ++s) {
    for (int c = 0; c < 2; ++c) {
      const uint32_t u = zigzag(x[c][s]);
      const Code code = symbol_code(u, chain_step(pa[c], pb[c], u));
      pos += code.len;
      or_code(words.data(), pos - code.n, code.tail, code.n);
      end.push_back(pos);
    }
  }
  words.resize((pos + 31) / 32 + 1);  // and a zero word
  return words;
}

const char* kKinds[] = {"stage 0 (residual 0)", "stage 1 (residual 1,500)",
                        "both stages (normal, scale 3,000)"};

// part 3: K9 at 1,024 stereo blocks x 12,288, U = 1, 2, 4
void k9_group_sizes() {
  constexpr int B = 1024, n = 12288;
  std::mt19937 gen(2026);
  std::normal_distribution<double> normal(0.0, 1.0);
  std::uniform_real_distribution<double> spread(-6.0, 6.0);
  std::uniform_int_distribution<int> burst(0, 4);
  std::vector<int32_t> rows((size_t)B * 2 * n);
  std::vector<int64_t> init(2 * B), offsets(B);
  std::vector<uint32_t> words;
  uint64_t bits = 0, escapes = 0;
  int W = 0;
  for (int b = 0; b < B; ++b) {
    const double scale = 3000.0 * std::exp2(spread(gen));
    std::vector<int32_t> x[2];
    for (int c = 0; c < 2; ++c) {
      x[c].resize(n);
      double mag = 0;
      for (int s = 0; s < n; ++s) {
        const double v = normal(gen) * scale * (1 << burst(gen));
        x[c][s] = (int32_t)std::fmax(-2147483648.0, std::fmin(2147483647.0, std::round(v)));
        rows[((size_t)b * 2 + c) * n + s] = x[c][s];
        mag += zigzag(x[c][s]);
      }
      init[2 * b + c] = std::max<int64_t>(1, (int64_t)(mag / n));
    }
    std::vector<uint32_t> end;
    std::vector<uint32_t> w = encode_stereo(x, n, &init[2 * b], end);
    w.pop_back();  // the zero word; payloads follow one another from word starts
    offsets[b] = (int64_t)words.size() * 32;
    W = std::max<int>(W, (int)w.size() + 2);
    words.insert(words.end(), w.begin(), w.end());
    bits += end.back();
  }
  // the escapes: symbols whose code opens with a run of 16 zeros
  for (int b = 0; b < B; ++b) {
    uint32_t pa[2], pb[2];
    for (int c = 0; c < 2; ++c) pa[c] = pb[c] = param_init(init[2 * b + c]);
    for (int s = 0; s < n; ++s) {
      for (int c = 0; c < 2; ++c) {
        const uint32_t u = zigzag(rows[((size_t)b * 2 + c) * n + s]);
        const Code code = symbol_code(u, chain_step(pa[c], pb[c], u));
        escapes += code.len - code.n >= kQuotThreshold;
      }
    }
  }
  W = (W + 511) / 512 * 512;
  words.push_back(0u);
  std::vector<uint32_t> be(words.size());
  for (size_t i = 0; i < words.size(); ++i) be[i] = bswap32(words[i]);
  uint8_t *d_bytes, *d_bad;
  int64_t *d_off, *d_init;
  int32_t* d_out;
  cudaMalloc(&d_bytes, be.size() * 4);
  cudaMalloc(&d_off, B * 8);
  cudaMalloc(&d_init, 2 * B * 8);
  cudaMalloc(&d_out, rows.size() * 4);
  cudaMalloc(&d_bad, B);
  cudaMemcpy(d_bytes, be.data(), be.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(d_off, offsets.data(), B * 8, cudaMemcpyHostToDevice);
  cudaMemcpy(d_init, init.data(), 2 * B * 8, cudaMemcpyHostToDevice);
  printf("K9 part 3: %d stereo blocks x %d, %.2f bits a symbol, %.3f %% escapes\n", B, n,
         (double)bits / ((double)B * 2 * n), 100.0 * escapes / ((double)B * 2 * n));
  auto run = [&](int U) {
    if (U == 1) k9_blocks<1><<<B, 32>>>(d_bytes, (int64_t)be.size(), d_off, W, d_init, n, d_out, d_bad);
    if (U == 2) k9_blocks<2><<<B, 32>>>(d_bytes, (int64_t)be.size(), d_off, W, d_init, n, d_out, d_bad);
    if (U == 4) k9_blocks<4><<<B, 32>>>(d_bytes, (int64_t)be.size(), d_off, W, d_init, n, d_out, d_bad);
  };
  std::vector<int32_t> got(rows.size());
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int U : {1, 2, 4, 1}) {
    run(U);
    cudaEventRecord(e0);
    for (int r = 0; r < 5; ++r) run(U);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0;
    cudaEventElapsedTime(&ms, e0, e1);
    cudaMemcpy(got.data(), d_out, got.size() * 4, cudaMemcpyDeviceToHost);
    printf("K9 part 3: U %d: %.3f ms, rows %s\n", U, ms / 5, got == rows ? "equal" : "DIFFER");
  }
  cudaFree(d_bytes);
  cudaFree(d_off);
  cudaFree(d_init);
  cudaFree(d_out);
  cudaFree(d_bad);
}

long long read_cycles(long long* d) {
  long long h = 0;
  cudaDeviceSynchronize();
  cudaMemcpy(&h, d, sizeof(h), cudaMemcpyDeviceToHost);
  return h;
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("device: %s\n", prop.name);
  long long* cycles;
  int32_t* out;
  uint8_t* bad;
  int64_t* init;
  cudaMalloc(&cycles, sizeof(long long));
  cudaMalloc(&out, (size_t)2 * kSamples * 4);
  cudaMalloc(&bad, 1);
  cudaMalloc(&init, 32 * sizeof(int64_t));
  bool exact = true;
  for (int kind = 0; kind < 3; ++kind) {
    std::vector<int32_t> x[2] = {residuals(kind, kSamples, 11), residuals(kind, kSamples, 12)};
    const int64_t h_init[32] = {kind == 0 ? 1 : 3000, kind == 0 ? 1 : 3000};
    cudaMemcpy(init, h_init, sizeof(h_init), cudaMemcpyHostToDevice);
    std::vector<uint32_t> end;
    const std::vector<uint32_t> words = encode_stereo(x, kSamples, h_init, end);
    std::vector<uint32_t> be(words.size());
    for (size_t i = 0; i < words.size(); ++i) be[i] = bswap32(words[i]);
    uint8_t* bytes;
    cudaMalloc(&bytes, be.size() * 4);
    cudaMemcpy(bytes, be.data(), be.size() * 4, cudaMemcpyHostToDevice);
    const int64_t nwords = (int64_t)be.size();
    const int nsym = 2 * kSamples;
    std::vector<int32_t> got((size_t)2 * kSamples);

    k9_previous<<<1, 1>>>(bytes, nwords, init, out, cycles);
    const long long c_prev = read_cycles(cycles);
    cudaMemcpy(got.data(), out, got.size() * 4, cudaMemcpyDeviceToHost);
    for (int c = 0; c < 2; ++c)
      for (int s = 0; s < kSamples; ++s) exact &= got[(size_t)c * kSamples + s] == x[c][s];

    int ncur = 0;  // whole groups of samples inside the first 125 words
    while (ncur + 2 * kGroup <= nsym && end[ncur + 2 * kGroup - 1] <= 125 * 32) ncur += 2 * kGroup;
    k9_cursor<<<1, 32>>>(bytes, nwords, init, ncur, out, cycles);
    const long long c_cur = read_cycles(cycles);

    cudaMemset(out, 0, got.size() * 4);
    k9_warp<<<1, 32>>>(bytes, nwords, init, out, bad, cycles);
    const long long c_warp = read_cycles(cycles);
    cudaMemcpy(got.data(), out, got.size() * 4, cudaMemcpyDeviceToHost);
    for (int c = 0; c < 2; ++c)
      for (int s = 0; s < kSamples; ++s) exact &= got[(size_t)c * kSamples + s] == x[c][s];
    printf("K9 %s, %.1f bits a symbol: cycles a symbol: the previous 64-bit cursor, one thread %.1f; "
           "the 32-bit cursor alone (%d symbols) %.1f; the warp schedule %.1f\n",
           kKinds[kind], (double)end.back() / nsym, (double)c_prev / nsym, ncur,
           ncur ? (double)c_cur / ncur : 0.0, (double)c_warp / nsym);
    cudaFree(bytes);

    // K8: 32 rows of kRowTile residuals of this kind, walked until kSamples steps
    std::vector<int32_t> rows;
    for (int r = 0; r < 32; ++r) {
      const std::vector<int32_t> v = residuals(kind, kRowTile, 100 + r);
      rows.insert(rows.end(), v.begin(), v.end());
    }
    int32_t* d_rows;
    uint32_t* d_words;
    uint16_t* d_recs;
    cudaMalloc(&d_rows, rows.size() * 4);
    cudaMalloc(&d_words, (size_t)32 * kSamples * 16);
    cudaMalloc(&d_recs, 64);
    cudaMemcpy(d_rows, rows.data(), rows.size() * 4, cudaMemcpyHostToDevice);
    std::vector<int64_t> ini(32, kind == 0 ? 1 : 3000);
    cudaMemcpy(init, ini.data(), 32 * sizeof(int64_t), cudaMemcpyHostToDevice);
    double c8[4];
    k8_steps<0><<<1, 32>>>(d_rows, init, d_words, d_recs, cycles);
    c8[0] = (double)read_cycles(cycles) / kSamples;
    k8_steps<1><<<1, 32>>>(d_rows, init, d_words, d_recs, cycles);
    c8[1] = (double)read_cycles(cycles) / kSamples;
    k8_steps<2><<<1, 32>>>(d_rows, init, d_words, d_recs, cycles);
    c8[2] = (double)read_cycles(cycles) / kSamples;
    k8_steps<3><<<1, 32>>>(d_rows, init, d_words, d_recs, cycles);
    c8[3] = (double)read_cycles(cycles) / kSamples;
    printf("K8 %s: cycles a step, one warp on 32 rows: the previous count step %.1f, its emit step "
           "(64-bit writer) %.1f; the new chain with its record %.1f; with the code length "
           "%.1f\n",
           kKinds[kind], c8[0], c8[1], c8[2], c8[3]);
    cudaFree(d_rows);
    cudaFree(d_words);
    cudaFree(d_recs);
  }
  k9_group_sizes();
  const cudaError_t err = cudaDeviceSynchronize();
  printf("K9 rows equal the residuals (the previous form and the warp schedule): %s\n",
         exact ? "yes" : "NO");
  printf("%s\n", cudaGetErrorString(err));
  return err == cudaSuccess && exact ? 0 : 1;
}
