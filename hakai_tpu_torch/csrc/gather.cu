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
// and j-side nodes) from the (6, N) position/velocity rows.
//
// What bounds it on an H100: device-memory bytes.  Each output column reads
// one index (4 bytes) and writes C values; the reads of src follow the
// renumbered mesh's locality and mostly hit L2.
//
// Design: one thread per output column r for all channels, so the index is
// read once; the index loads and the C output rows are coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
gather_cols_kernel(const T* __restrict__ src, int C, int64_t S,
                   const int32_t* __restrict__ idx, int64_t R,
                   T* __restrict__ out) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int64_t s = idx[r];
  for (int c = 0; c < C; ++c) out[c * R + r] = src[c * S + s];
}

template <typename T>
int launch(const T* src, int C, int64_t S, const int32_t* idx, int64_t R,
           T* out, void* stream) {
  if (R <= 0) return 0;
  const int block = 256;
  const int64_t grid = (R + block - 1) / block;
  gather_cols_kernel<T><<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      src, C, S, idx, R, out);
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

}  // extern "C"
