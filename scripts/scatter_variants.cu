// Design variants of kernel S, the contact force scatter
// (hakai_tpu_torch/csrc/contact.cu): g[c, n] = the sum over node n's
// table entries, in table order, of +src[c, col] (its first entries) and
// -src[c, col] (the rest), in T, stored once as O.  Every variant gives
// the first design's bits: the same terms in the same order, a subtract
// written as the add of the negated value (IEEE: a - x == a + (-x)).
//
// Built into a shared library and driven by scripts/scatter_variants.py,
// which lowers the contact deck of chip_smoke.py's [contact] and times
// every variant on its table (its header says how to run it).
//
//   0 csr       the first design: a thread a node walks its CSR row
//               one entry at a time (index, then its three gathers)
//   1 csr8      a thread a node, its row's indices loaded 8 at a time in
//               one wave, then the wave's 24 gathers, then the sums
//   2 slot8     a slot-major (V, N) copy of the table (slot v of node n at
//               v * N + n, so a warp's index loads coalesce) and a packed
//               (N,) row word (length << 16 | adds): waves of 8 slots
//   3 slot16    as slot8, waves of 16 slots
//   4 sorted8   as slot8 over the nodes dealt by row length (longest
//               first, node order within a length), so a warp's rows end
//               together; the output stored through the permutation
//   5 lanes8    the CSR, 8 lanes a node: each lane loads every 8th entry of
//               the row, gathers it and writes the signed value to shared
//               memory in table order; one thread a (channel, node) sums
//   6 lanes4    as lanes8 with 4 lanes a node
//   7 lanes16   as lanes8 with 16 lanes a node
//   8 bsort32   the nodes in blocks of 32: the block's entries (a range of
//               the CSR) re-sorted by column, with each one's place in the
//               range (16 bits), so a warp's gathers fall on few lines;
//               each gathered value goes to its place in shared memory and
//               one thread a (channel, node) sums its row in table order
//   9 bsort64   as bsort32 with 64 nodes a block
//  10 bsort128  as bsort32 with 128 nodes a block
//  11 bsort32u8 as bsort32 with 8 entries a thread in flight, not 4
//  12 bsort32p  as bsort32 with each entry's column and place packed in
//               one 32-bit word (col << 11 | place: 4 bytes an entry, as
//               the CSR's; needs W < 2^21 and 2,048 entries a block)
//  13 bsort16   as bsort32 with 16 nodes a block
//  14 bsort32pu2 as bsort32p with 2 entries a thread in flight
//  15 bsort32pu1 as bsort32p with 1 entry a thread in flight
// and, as diagnostics of the shipped design (bsort32pu2), not the
// function (no bitwise check):
//  16 diag-gather  its loads alone: the words and the gathers, no shared
//                  memory, no sums
//  17 diag-place   its first phase: the loads and each value's store to
//                  its place in shared memory, no row sums
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

template <typename T, typename O>
__global__ void __launch_bounds__(kBlock)
csr(const T* __restrict__ src, int64_t ld, const int32_t* __restrict__ ptr,
    const int32_t* __restrict__ mid, const int32_t* __restrict__ col, int N,
    O* __restrict__ out) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  T acc[3] = {T(0), T(0), T(0)};
  const int b = ptr[n], m = mid[n], e = ptr[n + 1];
  for (int q = b; q < m; ++q) {
    const int64_t s = col[q];
#pragma unroll
    for (int r = 0; r < 3; ++r) acc[r] += src[r * ld + s];
  }
  for (int q = m; q < e; ++q) {
    const int64_t s = col[q];
#pragma unroll
    for (int r = 0; r < 3; ++r) acc[r] -= src[r * ld + s];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) out[r * (int64_t)N + n] = O(acc[r]);
}

// the sums of one wave of K loaded slots: slot k < len adds or subtracts
template <typename T, int K>
__device__ __forceinline__ void sum_wave(T (&acc)[3], const T (&x)[K][3],
                                         int v0, int len, int adds) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int r = 0; r < 3; ++r)
      if (v0 + k < len) acc[r] += v0 + k < adds ? x[k][r] : -x[k][r];
}

template <typename T, typename O, int K>
__global__ void __launch_bounds__(kBlock)
csr_wave(const T* __restrict__ src, int64_t ld,
         const int32_t* __restrict__ ptr, const int32_t* __restrict__ mid,
         const int32_t* __restrict__ col, int N, O* __restrict__ out) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int b = ptr[n], len = ptr[n + 1] - b, adds = mid[n] - b;
  T acc[3] = {T(0), T(0), T(0)};
  for (int v0 = 0; v0 < len; v0 += K) {
    int s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = v0 + k < len ? __ldcs(col + b + v0 + k) : 0;
    T x[K][3];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int r = 0; r < 3; ++r)
        x[k][r] = v0 + k < len ? src[r * ld + s[k]] : T(0);
    sum_wave<T, K>(acc, x, v0, len, adds);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) out[r * (int64_t)N + n] = O(acc[r]);
}

// slot-major table: slot v of row p at v * N + p; row word len << 16 |
// adds; perm (null: none) maps the row to its node
template <typename T, typename O, int K>
__global__ void __launch_bounds__(kBlock)
slot_wave(const T* __restrict__ src, int64_t ld,
          const int32_t* __restrict__ slot, const int32_t* __restrict__ word,
          const int32_t* __restrict__ perm, int N, O* __restrict__ out) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= N) return;
  const int w = word[p], len = w >> 16, adds = w & 0xffff;
  T acc[3] = {T(0), T(0), T(0)};
  for (int v0 = 0; v0 < len; v0 += K) {
    int s[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      s[k] = v0 + k < len ? __ldcs(slot + (int64_t)(v0 + k) * N + p) : 0;
    T x[K][3];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int r = 0; r < 3; ++r)
        x[k][r] = v0 + k < len ? src[r * ld + s[k]] : T(0);
    sum_wave<T, K>(acc, x, v0, len, adds);
  }
  const int64_t n = perm != nullptr ? perm[p] : p;
#pragma unroll
  for (int r = 0; r < 3; ++r) out[r * (int64_t)N + n] = O(acc[r]);
}

// G lanes a node, kBlock / G nodes a block; buf holds the signed values
// as [3][V][NB + 1] (padded against bank conflicts)
template <typename T, typename O, int G>
__global__ void __launch_bounds__(kBlock)
lanes(const T* __restrict__ src, int64_t ld, const int32_t* __restrict__ ptr,
      const int32_t* __restrict__ mid, const int32_t* __restrict__ col,
      int N, int V, O* __restrict__ out) {
  constexpr int NB = kBlock / G, P = NB + 1;
  extern __shared__ __align__(16) unsigned char raw[];
  T* buf = reinterpret_cast<T*>(raw);
  const int k = threadIdx.x / G, l = threadIdx.x % G;
  const int64_t n = (int64_t)blockIdx.x * NB + k;
  if (n < N) {
    const int b = ptr[n], len = ptr[n + 1] - b, adds = mid[n] - b;
    for (int v0 = l; v0 < len; v0 += 4 * G) {   // waves of 4 entries a lane
      int s[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        s[u] = v0 + u * G < len ? __ldcs(col + b + v0 + u * G) : 0;
      T x[4][3];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int r = 0; r < 3; ++r)
          x[u][r] = v0 + u * G < len ? src[r * ld + s[u]] : T(0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int v = v0 + u * G;
        if (v < len)
#pragma unroll
          for (int r = 0; r < 3; ++r)
            buf[(r * V + v) * P + k] = v < adds ? x[u][r] : -x[u][r];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 3 * NB) {
    const int r = threadIdx.x / NB, kk = threadIdx.x % NB;
    const int64_t nn = (int64_t)blockIdx.x * NB + kk;
    if (nn < N) {
      const int len = ptr[nn + 1] - ptr[nn];
      T acc = T(0);
      for (int v = 0; v < len; ++v) acc += buf[(r * V + v) * P + kk];
      out[r * (int64_t)N + nn] = O(acc);
    }
  }
}

// NB nodes a block; sc, sd: the block's entries sorted by column and each
// one's place in the block's range; buf (3, maxE) in shared memory
template <typename T, typename O, int NB, int U = 4, bool PACKED = false,
          int DIAG = 0>
__global__ void __launch_bounds__(kBlock)
bsort(const T* __restrict__ src, int64_t ld, const int32_t* __restrict__ ptr,
      const int32_t* __restrict__ mid, const int32_t* __restrict__ sc,
      const uint16_t* __restrict__ sd, int N, int maxE,
      O* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char raw[];
  T* buf = reinterpret_cast<T*>(raw);
  const int n0 = blockIdx.x * NB, n1 = n0 + NB < N ? n0 + NB : N;
  const int e0 = ptr[n0], E = ptr[n1] - e0;
  T sink = T(0);
  for (int q0 = threadIdx.x; q0 < E; q0 += U * kBlock) {
    int s[U], d[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * kBlock;
      if (PACKED) {
        const uint32_t w = q < E ? (uint32_t)__ldcs(sc + e0 + q) : 0u;
        s[u] = (int)(w >> 11);
        d[u] = (int)(w & 2047u);
      } else {
        s[u] = q < E ? __ldcs(sc + e0 + q) : 0;
        d[u] = q < E ? (int)__ldcs(sd + e0 + q) : 0;
      }
    }
    T x[U][3];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < 3; ++r)
        x[u][r] = q0 + u * kBlock < E ? src[r * ld + s[u]] : T(0);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (q0 + u * kBlock < E)
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          if (DIAG == 1) sink += x[u][r];
          else buf[r * maxE + d[u]] = x[u][r];
        }
  }
  if (DIAG == 1) {                       // keeps the loads; never stores
    if (sink == T(-12345.678)) out[0] = O(sink);
    return;
  }
  __syncthreads();
  if (DIAG == 2) {
    if (threadIdx.x == 0 && buf[0] == T(-12345.678)) out[0] = O(buf[0]);
    return;
  }
  for (int t = threadIdx.x; t < 3 * NB; t += kBlock) {
    const int r = t / NB, n = n0 + t % NB;
    if (n >= N) continue;
    const int b = ptr[n] - e0, m = mid[n] - e0, e = ptr[n + 1] - e0;
    const T* row = buf + r * maxE;
    T acc = T(0);
    for (int q = b; q < m; ++q) acc += row[q];
    for (int q = m; q < e; ++q) acc -= row[q];
    out[r * (int64_t)N + n] = O(acc);
  }
}

template <typename T, typename O, int NB, int U = 4, bool PACKED = false,
          int DIAG = 0>
int bsort_launch(const T* src, int ld, const int32_t* ptr, const int32_t* mid,
                 const int32_t* sc, const uint16_t* sd, int N, int maxE,
                 O* out, cudaStream_t st) {
  const size_t smem = sizeof(T) * 3 * (size_t)maxE;
  cudaError_t err = cudaFuncSetAttribute(
      bsort<T, O, NB, U, PACKED, DIAG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bsort<T, O, NB, U, PACKED, DIAG><<<(N + NB - 1) / NB, kBlock, smem, st>>>(
      src, ld, ptr, mid, sc, sd, N, maxE, out);
  return (int)cudaGetLastError();
}

template <typename T, typename O>
int run(int variant, const T* src, int ld, const int32_t* ptr,
        const int32_t* mid, const int32_t* col, const int32_t* slot,
        const int32_t* word, const int32_t* sslot, const int32_t* sword,
        const int32_t* perm, const int32_t* const* sc,
        const uint16_t* const* sd, const int* maxE, int N, int V, O* out,
        cudaStream_t st) {
  const int grid = (N + kBlock - 1) / kBlock;
  switch (variant) {
    case 0: csr<T, O><<<grid, kBlock, 0, st>>>(src, ld, ptr, mid, col, N, out);
      break;
    case 1: csr_wave<T, O, 8><<<grid, kBlock, 0, st>>>(src, ld, ptr, mid, col,
                                                        N, out);
      break;
    case 2: slot_wave<T, O, 8><<<grid, kBlock, 0, st>>>(src, ld, slot, word,
                                                         nullptr, N, out);
      break;
    case 3: slot_wave<T, O, 16><<<grid, kBlock, 0, st>>>(src, ld, slot, word,
                                                          nullptr, N, out);
      break;
    case 4: slot_wave<T, O, 8><<<grid, kBlock, 0, st>>>(src, ld, sslot, sword,
                                                         perm, N, out);
      break;
    case 5: case 6: case 7: {
      const int G = variant == 5 ? 8 : variant == 6 ? 4 : 16, nb = kBlock / G;
      const size_t smem = sizeof(T) * 3 * (size_t)V * (nb + 1);
      const int g = (N + nb - 1) / nb;
      auto kern = variant == 5 ? lanes<T, O, 8> : variant == 6
                  ? lanes<T, O, 4> : lanes<T, O, 16>;
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      kern<<<g, kBlock, smem, st>>>(src, ld, ptr, mid, col, N, V, out);
      break;
    }
    case 8: return bsort_launch<T, O, 32>(src, ld, ptr, mid, sc[0], sd[0], N,
                                          maxE[0], out, st);
    case 9: return bsort_launch<T, O, 64>(src, ld, ptr, mid, sc[1], sd[1], N,
                                          maxE[1], out, st);
    case 10: return bsort_launch<T, O, 128>(src, ld, ptr, mid, sc[2], sd[2],
                                            N, maxE[2], out, st);
    case 11: return bsort_launch<T, O, 32, 8>(src, ld, ptr, mid, sc[0], sd[0],
                                              N, maxE[0], out, st);
    case 12: return bsort_launch<T, O, 32, 4, true>(src, ld, ptr, mid, sc[3],
                                                    nullptr, N, maxE[0], out,
                                                    st);
    case 14: return bsort_launch<T, O, 32, 2, true>(src, ld, ptr, mid, sc[3],
                                                    nullptr, N, maxE[0], out,
                                                    st);
    case 15: return bsort_launch<T, O, 32, 1, true>(src, ld, ptr, mid, sc[3],
                                                    nullptr, N, maxE[0], out,
                                                    st);
    case 16: return bsort_launch<T, O, 32, 2, true, 1>(
        src, ld, ptr, mid, sc[3], nullptr, N, maxE[0], out, st);
    case 17: return bsort_launch<T, O, 32, 2, true, 2>(
        src, ld, ptr, mid, sc[3], nullptr, N, maxE[0], out, st);
    case 13: return bsort_launch<T, O, 16>(src, ld, ptr, mid, sc[4], sd[4], N,
                                           maxE[4], out, st);
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// variant (above), kind 0: float32 sums stored as float64, 1: float64;
// src (3, ld); ptr (N + 1), mid (N), col (nnz): the CSR; slot (V, N) and
// word (N): the slot-major table; sslot, sword, perm: the same dealt by
// row length; sc[5], sd[5], maxE[5]: the bsort tables of 32, 64, 128
// nodes a block, the packed words of 32 (sd[3] unused) and of 16
int sv_scatter(int variant, int kind, const void* src, int ld,
               const int32_t* ptr, const int32_t* mid, const int32_t* col,
               const int32_t* slot, const int32_t* word,
               const int32_t* sslot, const int32_t* sword,
               const int32_t* perm, const int32_t* const* sc,
               const uint16_t* const* sd, const int* maxE, int N, int V,
               double* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0)
    return run<float, double>(variant, (const float*)src, ld, ptr, mid, col,
                              slot, word, sslot, sword, perm, sc, sd, maxE, N,
                              V, out, st);
  return run<double, double>(variant, (const double*)src, ld, ptr, mid, col,
                             slot, word, sslot, sword, perm, sc, sd, maxE, N,
                             V, out, st);
}

const char* sv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
