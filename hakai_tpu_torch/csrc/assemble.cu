// Deterministic internal-force assembly: Qe (24, E) -> Q (3, N).
//
// Replaces the TPU assembly path: hakai_tpu/ops/gather_pallas.py
// _make_diag_kernel (through blocked_gather on plan_asm) followed by the
// XLA masked sum of hakai_tpu/ops/element.py:assemble_internal_force, and
// _make_phys_asm_kernel (through blocked_assemble_phys), which takes over
// at 400k elements.  One kernel serves every size.
//
// Q[c, n] = sum_{v < V} (inc_mask[v, n] ? qe_flat[c][inc_idx[v, n]] : 0)
// with qe_flat[c][i*E + e] = qe[c*8 + i, e], summed in the fixed order
// v = 0..V-1: no atomics, so a run is bitwise reproducible.
//
// What bounds it on an H100: device-memory bytes.  Each node reads its V
// incidence entries (index + mask, 5 bytes each) and gathers 3*V values of
// qe, which the renumbered mesh keeps within a narrow band of columns so
// the gathers mostly hit L2.
//
// Design: one thread per node handles all three channels, so the
// incidence row (the larger stream) is read once and not three times; the
// index and mask loads for consecutive nodes coalesce, and the Q stores
// are three coalesced rows.
//
// The sum runs in the type T of qe and is stored in the type O of Q.  In
// mixed precision (float32 qe, float64 nodal state) O is double: the f32
// sum rounded once to f64, the bits of the JAX package's
// assemble_internal_force(...).astype(model.dtype), with no second launch
// or f32 copy of Q.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T, typename O>
__global__ void __launch_bounds__(256)
assemble_kernel(const T* __restrict__ qe,             // (24, E)
                const int32_t* __restrict__ inc_idx,  // (V, N)
                const uint8_t* __restrict__ inc_mask, // (V, N)
                int V, int N, int E,
                O* __restrict__ Q) {                  // (3, N)
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int64_t E8 = 8 * (int64_t)E;
  T acc[3] = {T(0), T(0), T(0)};
  for (int v = 0; v < V; ++v) {
    const int64_t o = (int64_t)v * N + n;
    if (inc_mask[o]) {
      const int64_t s = inc_idx[o];
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[c] += qe[c * E8 + s];
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) Q[c * (int64_t)N + n] = O(acc[c]);
}

template <typename T, typename O>
int launch(const T* qe, const int32_t* inc_idx, const uint8_t* inc_mask,
           int V, int N, int E, O* Q, void* stream) {
  if (N <= 0) return 0;
  const int block = 256;
  const int grid = (N + block - 1) / block;
  assemble_kernel<T, O><<<grid, block, 0, (cudaStream_t)stream>>>(
      qe, inc_idx, inc_mask, V, N, E, Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int hk_assemble_f32(const float* qe, const int32_t* inc_idx,
                    const uint8_t* inc_mask, int V, int N, int E, float* Q,
                    void* stream) {
  return launch<float, float>(qe, inc_idx, inc_mask, V, N, E, Q, stream);
}

int hk_assemble_f64(const double* qe, const int32_t* inc_idx,
                    const uint8_t* inc_mask, int V, int N, int E, double* Q,
                    void* stream) {
  return launch<double, double>(qe, inc_idx, inc_mask, V, N, E, Q, stream);
}

// float32 sum, stored as float64 (mixed precision)
int hk_assemble_f32_f64(const float* qe, const int32_t* inc_idx,
                        const uint8_t* inc_mask, int V, int N, int E,
                        double* Q, void* stream) {
  return launch<float, double>(qe, inc_idx, inc_mask, V, N, E, Q, stream);
}

}  // extern "C"
