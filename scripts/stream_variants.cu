// Grid variants of the streaming pass o = x + 1 over 72 x 2^20 float32
// (TPU kernel #11's shape, csrc/stream.cu), timed with CUDA events: the
// best of 3 runs of 50 chained passes each, after 5 warm passes.
//
// Build and run, from the repository's root (the first two lines are one
// command):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//     --extended-lambda scripts/stream_variants.cu -o build/stream_variants
//   ./build/stream_variants
//
// "persist": a grid of BPS blocks an SM walking warp units (32 x VEC
// 16-byte columns) by a grid stride; "grid": one unit a warp; "block": a
// block's 16-byte columns strided by the block size, as PyTorch's
// elementwise kernels lay them out.  cs: __ldcs/__stcs.  "tma ring": the
// Hopper form of the TPU's HBM -> VMEM -> HBM DMA pipeline, persistent
// blocks of which one thread keeps STAGES - 1 bulk copies (cp.async.bulk)
// of 8 KB in flight into a ring of shared-memory stages, each completing
// on its mbarrier; the block adds 1 in shared memory and the thread
// stores the stage back with a bulk copy, refilling a stage once its
// store has read it; its first pass from zeros is checked to give 1
// everywhere.  Every variant runs twice, so the spread shows.
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float4 add1(float4 v) {
  v.x += 1.f; v.y += 1.f; v.z += 1.f; v.w += 1.f;
  return v;
}

// HINT bit 1: __ldcs loads; bit 2: __stcs stores
template <int VEC, int HINT, int THREADS>
__global__ void __launch_bounds__(THREADS)
k(const float4* __restrict__ x, float4* __restrict__ o, int units, int n4) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (THREADS / 32);
  for (int u = blockIdx.x * (THREADS / 32) + threadIdx.x / 32; u < units;
       u += warps) {
    const int c0 = u * 32 * VEC + lane;
    float4 v[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (c0 + 32 * i < n4)
        v[i] = (HINT & 1) ? __ldcs(x + c0 + 32 * i) : x[c0 + 32 * i];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (c0 + 32 * i >= n4) continue;
      if (HINT & 2) __stcs(o + c0 + 32 * i, add1(v[i]));
      else o[c0 + 32 * i] = add1(v[i]);
    }
  }
}

template <int VEC, int THREADS>
__global__ void __launch_bounds__(THREADS)
kb(const float4* __restrict__ x, float4* __restrict__ o, int n4) {
  const int base = blockIdx.x * THREADS * VEC + threadIdx.x;
  float4 v[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    if (base + THREADS * i < n4) v[i] = x[base + THREADS * i];
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    if (base + THREADS * i < n4) o[base + THREADS * i] = add1(v[i]);
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(smem(bar)), "r"(parity) : "memory");
  }
}

constexpr int kChunk = 2048;       // tma ring: floats a stage (8 KB)

// (thread 0) unit u of CHUNK floats into `stage`, completing on `bar`
__device__ __forceinline__ void tma_issue(const float* x, float* stage,
                                          uint64_t* bar, int u, int64_t n) {
  const int64_t b = (int64_t)u * kChunk;
  const uint32_t bytes = 4u * (uint32_t)(n - b < kChunk ? n - b : kChunk);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];"
               :: "r"(smem(stage)), "l"(x + b), "r"(bytes), "r"(smem(bar))
               : "memory");
}

template <int STAGES, int THREADS>
__global__ void __launch_bounds__(THREADS)
tma(const float* __restrict__ x, float* __restrict__ o, int64_t n,
    int units) {
  extern __shared__ __align__(128) float ring[];   // STAGES x kChunk
  __shared__ __align__(8) uint64_t full[STAGES];
  const int first = blockIdx.x, step = gridDim.x;
  const int mine = units > first ? (units - 1 - first) / step + 1 : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < STAGES && i < mine; ++i)
      tma_issue(x, ring + i * kChunk, &full[i], first + i * step, n);
  }
  __syncthreads();
  for (int i = 0; i < mine; ++i) {
    const int u = first + i * step, s = i % STAGES;
    const int64_t b = (int64_t)u * kChunk;
    const int w = (int)(n - b < kChunk ? n - b : kChunk);
    float4* buf = reinterpret_cast<float4*>(ring + s * kChunk);
    mbar_wait(&full[s], (i / STAGES) & 1);
    for (int j = threadIdx.x; j < w / 4; j += THREADS) buf[j] = add1(buf[j]);
    // the writes above, visible to the bulk copy's proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1],"
                   " %2;" :: "l"(o + b), "r"(smem(buf)), "r"(4u * w)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // unit i - 1's stage is free once its store has read it
      if (i >= 1 && i - 1 + STAGES < mine) {
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        const int r = i - 1 + STAGES;
        tma_issue(x, ring + (r % STAGES) * kChunk, &full[r % STAGES],
                  first + r * step, n);
      }
    }
  }
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// microseconds a pass: the best of 3 runs of 50 chained passes
template <class F>
float timeit(F f, float4* a, float4* b) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int i = 0; i < 5; ++i) f(a, b);
  float best = 1e9f;
  for (int rep = 0; rep < 3; ++rep) {
    cudaEventRecord(e0);
    for (int i = 0; i < 50; ++i) {
      f(a, b);
      float4* t = a; a = b; b = t;
    }
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    if (ms / 50 * 1e3f < best) best = ms / 50 * 1e3f;
  }
  return best;
}

int main() {
  const int n4 = 72 * 1048576 / 4;
  float4 *a, *b;
  cudaMalloc(&a, n4 * 16);
  cudaMalloc(&b, n4 * 16);
  cudaMemset(a, 0, n4 * 16);
  float* host = new float[4 * (int64_t)n4];   // the tma ring's check
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
#define P(name, VEC, HINT, T, BPS) {                                      \
    const int units = (n4 + 32 * VEC - 1) / (32 * VEC);                   \
    const int nb = (units + T / 32 - 1) / (T / 32);                       \
    const int g = BPS > 0 && BPS * sms < nb ? BPS * sms : nb;             \
    printf("%-40s %8.3f us/pass\n", name, timeit([&](float4* x, float4* y) { \
      k<VEC, HINT, T><<<g, T>>>(x, y, units, n4); }, a, b)); }
#define B(name, VEC, T) {                                                 \
    const int g = (n4 + T * VEC - 1) / (T * VEC);                         \
    printf("%-40s %8.3f us/pass\n", name, timeit([&](float4* x, float4* y) { \
      kb<VEC, T><<<g, T>>>(x, y, n4); }, a, b)); }
#define R(name, STAGES, T, BPS) {                                         \
    const int64_t n = 4 * (int64_t)n4;                                    \
    const int units = (int)((n + kChunk - 1) / kChunk);                   \
    const int ring = STAGES * kChunk * 4;                                 \
    cudaFuncSetAttribute(tma<STAGES, T>,                                  \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, ring); \
    const int g = BPS * sms < units ? BPS * sms : units;                  \
    cudaMemset(a, 0, n4 * 16);                                            \
    tma<STAGES, T><<<g, T, ring>>>(reinterpret_cast<const float*>(a),     \
                                   reinterpret_cast<float*>(b), n, units); \
    cudaMemcpy(host, b, n4 * 16, cudaMemcpyDeviceToHost);                 \
    for (int64_t i = 0; i < n; ++i)                                       \
      if (host[i] != 1.0f) {                                              \
        printf("%s: value %lld is %g, not 1\n", name, (long long)i,       \
               host[i]);                                                  \
        return 1;                                                         \
      }                                                                   \
    printf("%-40s %8.3f us/pass\n", name, timeit([&](float4* x, float4* y) { \
      tma<STAGES, T><<<g, T, ring>>>(reinterpret_cast<const float*>(x),   \
                                     reinterpret_cast<float*>(y), n, units); \
    }, a, b)); }
  for (int round = 0; round < 2; ++round) {
    P("persist vec8 cs+cs 256t 4/SM", 8, 3, 256, 4);
    P("persist vec8 plain 256t 4/SM", 8, 0, 256, 4);
    P("persist vec8 ldcs 256t 4/SM", 8, 1, 256, 4);
    P("persist vec8 stcs 256t 4/SM", 8, 2, 256, 4);
    P("persist vec4 plain 256t 8/SM", 4, 0, 256, 8);
    P("persist vec4 cs 256t 8/SM", 4, 3, 256, 8);
    P("persist vec2 plain 256t 8/SM", 2, 0, 256, 8);
    P("grid vec8 plain 256t", 8, 0, 256, 0);
    P("grid vec4 plain 256t", 4, 0, 256, 0);
    P("grid vec2 plain 128t", 2, 0, 128, 0);
    P("grid vec1 plain 128t", 1, 0, 128, 0);
    P("grid vec4 cs 256t", 4, 3, 256, 0);
    B("block vec1 128t", 1, 128);
    B("block vec2 128t", 2, 128);
    B("block vec4 128t", 4, 128);
    B("block vec4 256t", 4, 256);
    B("block vec8 256t", 8, 256);
    R("tma ring 8x8KB 256t 3/SM", 8, 256, 3);
  }
  return 0;
}
