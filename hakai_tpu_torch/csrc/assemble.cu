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
// of columns so the gathers mostly hit L2.  About 20 MB at the bench bar's
// 141,312 nodes: ~6 us at the card's rate, so the kernel's time is its
// memory latency times the round trips a thread waits for one after the
// other, unless enough loads are in flight.
//
// Design: one thread per output column handles all C channels, so the
// incidence row (the larger stream) is read once and not C times; the
// index and mask loads for consecutive columns coalesce (in the grouped
// layout too: t runs fastest), and the stores are C coalesced rows.  A
// thread's slots are loaded in two waves of independent loads: first all
// its masks and indices (evict-first: the table is read once a step), then
// its C * V source values, predicated off for masked slots; then the sums
// in the order v = 0..V-1, a masked slot leaving the sum as it is.  So a
// thread waits for two memory round trips, not three for each slot in
// turn.  V = 8, the hex meshes' (and the
// halo windows') incidence, is a template argument, which keeps every
// slot's loads in flight at once in 56 registers; other V take their
// slots in chunks of 8 in the same two waves.  Two or four columns a
// thread, wider index loads and other block sizes measured no faster on
// an H100 (PERF.md, Findings).
//
// The sum runs in the type T of the source and is stored in the type O of
// the output.  In mixed precision (float32 qe, float64 nodal state) O is
// double: the f32 sum rounded once to f64, the bits of the JAX package's
// assemble_internal_force(...).astype(model.dtype), with no second launch
// or f32 copy of Q.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 8;     // incidence slots a thread has in flight
constexpr int kBlock = 256;

// kernel B: entry v of node j is row v of the (V, N) incidence table
struct NodeMajor {
  int64_t n;
  __device__ int64_t base(int64_t j) const { return j; }
  __device__ int64_t stride() const { return n; }
};

// grouped: entry l of column j = b*r_tile + t lies at (b*vl + l)*r_tile + t
struct Grouped {
  int vl, r_tile;
  __device__ int64_t base(int64_t j) const {
    const int64_t b = j / r_tile;
    return b * vl * r_tile + (j - b * r_tile);
  }
  __device__ int64_t stride() const { return r_tile; }
};

// VT > 0: exactly VT slots (V == VT); VT == 0: any V, kSlots at a time
template <typename T, typename O, int C, int VT, class Row>
__global__ void __launch_bounds__(kBlock)
assemble_kernel(const T* __restrict__ src,          // (C, S)
                const int32_t* __restrict__ idx,    // entries into S
                const uint8_t* __restrict__ mask,   // same layout as idx
                int V, int64_t S, int64_t n_out, Row row,
                O* __restrict__ out) {              // (C, n_out)
  constexpr int kW = VT > 0 ? VT : kSlots;          // slots a wave
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_out) return;
  const int64_t o0 = row.base(j), step = row.stride();
  T acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = T(0);
  for (int v0 = 0; v0 < (VT > 0 ? VT : V); v0 += kW) {
    bool m[kW];
    int32_t s[kW];
#pragma unroll
    for (int u = 0; u < kW; ++u) {       // wave 1: masks and indices
      const bool in = VT > 0 || v0 + u < V;
      const int64_t o = o0 + (v0 + u) * step;
      m[u] = in && __ldcs(mask + o);
      s[u] = in ? __ldcs(idx + o) : 0;
    }
    T val[kW][C];
#pragma unroll
    for (int u = 0; u < kW; ++u)         // wave 2: the source values
#pragma unroll
      for (int c = 0; c < C; ++c)
        val[u][c] = m[u] ? src[c * S + s[u]] : T(0);
#pragma unroll
    for (int u = 0; u < kW; ++u)         // the sums, in slot order
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (m[u]) acc[c] += val[u][c];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) out[c * n_out + j] = O(acc[c]);
}

template <typename T, typename O, int C, class Row>
int launch(const T* src, const int32_t* idx, const uint8_t* mask, int V,
           int64_t S, int64_t n_out, Row row, O* out, void* stream) {
  if (n_out <= 0) return 0;
  const int64_t grid = (n_out + kBlock - 1) / kBlock;
  const auto kernel = V == kSlots ? assemble_kernel<T, O, C, kSlots, Row>
                                  : assemble_kernel<T, O, C, 0, Row>;
  kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(src, idx, mask, V, S,
                                                     n_out, row, out);
  return (int)cudaGetLastError();
}

// What the instantiation a launch with V slots takes holds: out = {resident
// blocks an SM, registers a thread, static shared memory a block, local
// memory a thread (spills), dynamic shared memory a block (none)}.
template <typename T, typename O, class Row>
int resources(int V, int* out) {
  const auto kernel = V == kSlots ? assemble_kernel<T, O, 3, kSlots, Row>
                                  : assemble_kernel<T, O, 3, 0, Row>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  out[1] = fa.numRegs;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = (int)fa.localSizeBytes;
  out[4] = 0;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                            kBlock, 0);
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

// The resources of instantiation ``which`` (0 f32, 1 f64, 2 f32 -> f64 of
// kernel B, 3-5 the same of the grouped entry) for V slots into out[5] (see
// resources above).
int hk_assemble_resources(int which, int V, int* out) {
  switch (which) {
    case 0: return resources<float, float, NodeMajor>(V, out);
    case 1: return resources<double, double, NodeMajor>(V, out);
    case 2: return resources<float, double, NodeMajor>(V, out);
    case 3: return resources<float, float, Grouped>(V, out);
    case 4: return resources<double, double, Grouped>(V, out);
    case 5: return resources<float, double, Grouped>(V, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
