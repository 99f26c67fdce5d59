// Static-index column gather: out[c, r] = src[c, idx[r]] for C channels.
//
// Replaces hakai_tpu/ops/gather_pallas.py:blocked_gather, the one TPU
// function behind three kernels: _make_diag_kernel (diagonal windows),
// _make_merged_kernel (merged windows, subgroups > 1) and
// _make_gather_kernel (chunk-select).  Those are three tilings of one
// gather that move index windows through VMEM by DMA; on Hopper the same
// gather is a plain indexed load, and the window plans have no use.
//
// The port runs it on the contact path: once per step over the merged
// kinematics index list (every pair's triangle vertices, candidate nodes
// and j-side nodes) from the (6, N) position/velocity rows.  Two entries:
//
// gather_cols_kernel, every column: a step with no carried activity (ranks,
//   and every call outside a chunk);
// gather_cols_kernel_listed (a name that begins with the first's, so a
//   trace's filter for G's kernels takes both), a chunk's step
//   (ops/activity.py): the node columns, as listed in ``dense``, and of
//   each pair only the q0, q1 and q2 columns of the triangles in its list
//   of active triangles (kernel A's broad_list, run before it), in their
//   places in the dense (6, R) output.  The rows it writes are those a reader reads: all six of
//   a candidate node's and of a q0 vertex (its velocity is the triangle's),
//   the position rows of a j-side node and of q1 and q2.  Every other
//   entry keeps what the buffer held: kernel A visits only listed
//   triangles, and kernel N reads the columns of in-range triangles only,
//   which are listed.
//
// What bounds it on an H100: device-memory bytes.  Each output column reads
// one index (4 bytes) and writes C values; the reads of src follow the
// renumbered mesh's locality and mostly hit L2.
//
// Design: one thread per output column r for all channels, so the index is
// read once; the index loads and the C output rows are coalesced.  The
// listed gather's grid is persistent, sized once for the whole inventory
// (a captured graph fixes it), and strides over the dense columns and then
// each pair's three vertex columns of its listed triangles, list order
// (increasing ids, so a warp's stores mostly share sectors).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kUnroll = 2;       // columns a thread of the listed gather
                                 // takes at once

template <typename T>
__global__ void __launch_bounds__(kBlock)
gather_cols_kernel(const T* __restrict__ src, int C, int64_t S,
                   const int32_t* __restrict__ idx, int64_t R,
                   T* __restrict__ out) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int64_t s = idx[r];
  for (int c = 0; c < C; ++c) out[c * R + r] = src[c * S + s];
}

// pairs: per carried pair [its list's offset in ids, its q0, q1, q2 column
// offsets]; counts: its list's count.  A thread takes kUnroll columns at
// once (an index past the end reloads the last one and stores nothing), so
// their index loads are in flight together; the dense columns first, then
// the listed ones.
template <typename T>
__global__ void __launch_bounds__(kBlock)
gather_cols_kernel_listed(const T* __restrict__ src, int64_t S,
                     const int32_t* __restrict__ idx, int64_t R,
                     T* __restrict__ out, const int32_t* __restrict__ dense,
                     int nd6, int nd, const int4* __restrict__ pairs, int P,
                     const int32_t* __restrict__ ids,
                     const int32_t* __restrict__ counts) {
  extern __shared__ int listed[];    // (P,) the pairs' counts
  if (threadIdx.x < P) listed[threadIdx.x] = counts[threadIdx.x];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i0 = tid; i0 < nd; i0 += kUnroll * stride) {
    int64_t r[kUnroll], s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * stride;
      r[u] = dense[i < nd ? i : nd - 1];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s[u] = idx[r[u]];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * stride;
      if (i >= nd) break;
      const int rows = i < nd6 ? 6 : 3;
      for (int c = 0; c < rows; ++c) out[c * R + r[u]] = src[c * S + s[u]];
    }
  }
  __syncthreads();
  // the listed columns: each pair's count of each vertex, in list order
  int64_t total = 0;
  for (int p = 0; p < P; ++p) total += 3 * (int64_t)listed[p];
  for (int64_t i0 = tid; i0 < total; i0 += kUnroll * stride) {
    int64_t r[kUnroll], s[kUnroll];
    int v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int64_t j = i0 + u * stride;
      j = j < total ? j : total - 1;
      int p = 0;
      while (j >= 3 * (int64_t)listed[p]) j -= 3 * (int64_t)listed[p++];
      const int n = listed[p];
      v[u] = (int)(j / n);
      const int4 row = pairs[p];
      const int off = v[u] == 0 ? row.y : v[u] == 1 ? row.z : row.w;
      r[u] = (int64_t)off + ids[row.x + (j - (int64_t)v[u] * n)];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s[u] = idx[r[u]];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * stride >= total) break;
      const int rows = v[u] == 0 ? 6 : 3;
      for (int c = 0; c < rows; ++c) out[c * R + r[u]] = src[c * S + s[u]];
    }
  }
}

template <typename T>
int launch(const T* src, int C, int64_t S, const int32_t* idx, int64_t R,
           T* out, void* stream) {
  if (R <= 0) return 0;
  const int64_t grid = (R + kBlock - 1) / kBlock;
  gather_cols_kernel<T><<<(unsigned)grid, kBlock, 0,
                          (cudaStream_t)stream>>>(src, C, S, idx, R, out);
  return (int)cudaGetLastError();
}

// the listed gather's grid: enough blocks for ``most`` columns, at most
// what the device holds resident
template <typename T>
int listed_grid(int64_t most, int* out) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, gather_cols_kernel_listed<T>, kBlock, 0);
    if (err != cudaSuccess) return (int)err;
    cached[dev] = sms * (per > 0 ? per : 1);
  }
  const int64_t need = (most + kBlock - 1) / kBlock;
  *out = (int)(need < cached[dev] ? need : cached[dev]);
  return 0;
}

template <typename T>
int launch_listed(const T* src, int S, const int32_t* idx, int R, T* out,
                  const int32_t* dense, int nd6, int nd,
                  const int4* pairs, int P, const int32_t* ids,
                  const int32_t* counts, int most, void* stream) {
  if (R <= 0 || nd6 < 0 || nd < nd6 || P < 0 || P > kBlock || most < nd)
    return (int)cudaErrorInvalidValue;
  if (most == 0) return 0;
  int grid = 0;
  const int err = listed_grid<T>(most, &grid);
  if (err != 0) return err;
  gather_cols_kernel_listed<T><<<grid, kBlock, P * sizeof(int),
                            (cudaStream_t)stream>>>(
      src, S, idx, R, out, dense, nd6, nd, pairs, P, ids, counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int hk_gather_cols_f32(const float* src, int C, int S, const int32_t* idx,
                       int R, float* out, void* stream) {
  return launch<float>(src, C, S, idx, R, out, stream);
}

int hk_gather_cols_f64(const double* src, int C, int S, const int32_t* idx,
                       int R, double* out, void* stream) {
  return launch<double>(src, C, S, idx, R, out, stream);
}

// src (6, S), S, idx, R, out (6, R), dense, nd6, nd, pairs (P, 4), P, ids,
// counts (P,), most (nd plus three columns a slot of the carried pairs),
// stream
int hk_gather_listed_f32(const float* src, int S, const int32_t* idx, int R,
                         float* out, const int32_t* dense, int nd6, int nd,
                         const int4* pairs, int P, const int32_t* ids,
                         const int32_t* counts, int most, void* stream) {
  return launch_listed<float>(src, S, idx, R, out, dense, nd6, nd, pairs, P,
                              ids, counts, most, stream);
}

int hk_gather_listed_f64(const double* src, int S, const int32_t* idx,
                         int R, double* out, const int32_t* dense, int nd6,
                         int nd, const int4* pairs, int P,
                         const int32_t* ids, const int32_t* counts, int most,
                         void* stream) {
  return launch_listed<double>(src, S, idx, R, out, dense, nd6, nd, pairs, P,
                               ids, counts, most, stream);
}

}  // extern "C"
