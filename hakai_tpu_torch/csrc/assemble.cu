// Deterministic internal-force assembly: Qe (24, E) -> Q (3, N), and its
// grouped entry, the gather-and-accumulate of blocked_assemble.
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
// The grouped entry replaces blocked_assemble (gather_pallas.py:589; its
// bodies _make_diag_asm_kernel :479 and _make_asm_kernel :539, which
// differ only in how the TPU stages its source window):
//   out[c, b*r_tile + t] = sum_{l < vl} mask[g] ? src[c, idx[g]] : 0,
//   g = (b*vl + l)*r_tile + t,
// the vl consecutive tiles of output block b summed in the TPU grid's
// order l = 0..vl-1.  It is the same kernel with another row functor: an
// output column's l-th entry is read at g instead of at v*N + n.  For the
// node-block-major grouping of the incidence table (its (V, nblk, r_tile)
// view transposed to (nblk, V, r_tile), vl = V) both read the same entries
// in the same order, so the two entries give the same bits.
//
// What bounds it on an H100: device-memory bytes.  Each output column
// reads its V incidence entries (index + mask, 5 bytes each) and gathers
// C*V source values, which the renumbered mesh keeps within a narrow band
// of columns so the gathers mostly hit L2.
//
// Design: one thread per output column handles all C channels, so the
// incidence row (the larger stream) is read once and not C times; the
// index and mask loads for consecutive columns coalesce (in the grouped
// layout too: t runs fastest), and the stores are C coalesced rows.
//
// The sum runs in the type T of the source and is stored in the type O of
// the output.  In mixed precision (float32 qe, float64 nodal state) O is
// double: the f32 sum rounded once to f64, the bits of the JAX package's
// assemble_internal_force(...).astype(model.dtype), with no second launch
// or f32 copy of Q.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// kernel B: entry v of node n is row v of the (V, N) incidence table
struct NodeMajor {
  int64_t n;
  __device__ int64_t operator()(int v, int64_t j) const { return v * n + j; }
};

// grouped: entry l of column j = b*r_tile + t lies at (b*vl + l)*r_tile + t
struct Grouped {
  int vl, r_tile;
  __device__ int64_t operator()(int l, int64_t j) const {
    const int64_t b = j / r_tile;
    return (b * vl + l) * r_tile + (j - b * r_tile);
  }
};

template <typename T, typename O, int C, class Row>
__global__ void __launch_bounds__(256)
assemble_kernel(const T* __restrict__ src,          // (C, S)
                const int32_t* __restrict__ idx,    // entries into S
                const uint8_t* __restrict__ mask,   // same layout as idx
                int V, int64_t S, int64_t n_out, Row row,
                O* __restrict__ out) {              // (C, n_out)
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_out) return;
  T acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = T(0);
  for (int v = 0; v < V; ++v) {
    const int64_t o = row(v, j);
    if (mask[o]) {
      const int64_t s = idx[o];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += src[c * S + s];
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) out[c * n_out + j] = O(acc[c]);
}

template <typename T, typename O, int C, class Row>
int launch(const T* src, const int32_t* idx, const uint8_t* mask, int V,
           int64_t S, int64_t n_out, Row row, O* out, void* stream) {
  if (n_out <= 0) return 0;
  const int block = 256;
  const int64_t grid = (n_out + block - 1) / block;
  assemble_kernel<T, O, C, Row><<<grid, block, 0, (cudaStream_t)stream>>>(
      src, idx, mask, V, S, n_out, row, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int hk_assemble_f32(const float* qe, const int32_t* inc_idx,
                    const uint8_t* inc_mask, int V, int N, int E, float* Q,
                    void* stream) {
  return launch<float, float, 3>(qe, inc_idx, inc_mask, V, 8 * (int64_t)E,
                                 N, NodeMajor{N}, Q, stream);
}

int hk_assemble_f64(const double* qe, const int32_t* inc_idx,
                    const uint8_t* inc_mask, int V, int N, int E, double* Q,
                    void* stream) {
  return launch<double, double, 3>(qe, inc_idx, inc_mask, V, 8 * (int64_t)E,
                                   N, NodeMajor{N}, Q, stream);
}

// float32 sum, stored as float64 (mixed precision)
int hk_assemble_f32_f64(const float* qe, const int32_t* inc_idx,
                        const uint8_t* inc_mask, int V, int N, int E,
                        double* Q, void* stream) {
  return launch<float, double, 3>(qe, inc_idx, inc_mask, V, 8 * (int64_t)E,
                                  N, NodeMajor{N}, Q, stream);
}

// grouped entries: src (3, S), idx/mask (n_out * vl,), out (3, n_out)
int hk_blocked_assemble_f32(const float* src, int S, const int32_t* idx,
                            const uint8_t* mask, int vl, int r_tile,
                            int n_out, float* out, void* stream) {
  return launch<float, float, 3>(src, idx, mask, vl, S, n_out,
                                 Grouped{vl, r_tile}, out, stream);
}

int hk_blocked_assemble_f64(const double* src, int S, const int32_t* idx,
                            const uint8_t* mask, int vl, int r_tile,
                            int n_out, double* out, void* stream) {
  return launch<double, double, 3>(src, idx, mask, vl, S, n_out,
                                   Grouped{vl, r_tile}, out, stream);
}

// float32 sum, stored as float64 (mixed precision)
int hk_blocked_assemble_f32_f64(const float* src, int S, const int32_t* idx,
                                const uint8_t* mask, int vl, int r_tile,
                                int n_out, double* out, void* stream) {
  return launch<float, double, 3>(src, idx, mask, vl, S, n_out,
                                  Grouped{vl, r_tile}, out, stream);
}

}  // extern "C"
