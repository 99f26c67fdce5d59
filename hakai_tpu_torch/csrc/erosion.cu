// Kernel E: the erosion walk of one explicit step.
//
// Replaces the XLA fusion of the JAX step's erosion epilogue,
// hakai_tpu/ops/erosion.py:29-74 (erosion_delete_mask, erode) with the
// packed step's triaxiality mask, hakai_tpu/ops/element_pallas.py:607-624
// (_fracture_epilogue); before this kernel it ran as some 34 PyTorch ops a
// step (35 with the generic step's zeroing).  One thread per element:
//
//   packed step: triax := flag ? triax : 0 (in place; a dead element's
//     stale stress counts as zero), the pre-erosion flag
//   v_e, t_e: the Gauss-point means of eq_ps and triax, summed k = 0..7
//     and divided by 8
//   fr: the fracture strain of the element's material at t_e from the
//     device knot table (fracture strain, triaxiality) per row: the last
//     row's strain by default, each non-vertical segment interpolating on
//     t0 <= t_e < t1, later segments winning; +inf for a material without
//     a table
//   delete = t_e >= 0 and v_e >= fr and alive; new flag = alive and not
//     delete
//   generic step: a dead element's stress and strain zeroed in place (only
//     dead elements are written)
//
// and, for the chunk-carried contact activity, whether any element died:
// each block ORs its deletions into carry[0], and the last block to finish
// moves the result to carry[2] and leaves carry[0] and carry[1] (the
// ticket) zero, so the flag is on the device for the next step's kernel A
// and no value is read back to the host.
//
// Bitwise contract: every output is the bits of the plain version
// (ops/erosion.py) on the card.  The knots are float64, as the host holds
// them; each segment's slope is formed in double as Python forms it, and
// every knot, slope and default reaches the element type rounded, as
// PyTorch rounds a Python scalar against a tensor.  Built with -fmad=false.
//
// What bounds it on an H100: device-memory bytes: 8 eq_ps and 8 triax
// values, the flag and material id in, the flags (and the masked triax)
// out, about 102 B an element in float32 (13.4 MB at 131,072 elements,
// 4.0 us); the generic step's zeroing writes only dead elements.  A thread
// issues its element's loads at once, before any store.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

template <typename EL>
struct Args {
  const EL* eq_ps;        // (8, E)
  EL* triax;              // (8, E); masked in place with mask_triax
  int mask_triax;
  const uint8_t* flag;    // (E,)
  const int32_t* mat_id;  // (E,)
  const double* knots;    // (M, K, 2): (fracture strain, triaxiality)
  const int32_t* knot_n;  // (M,)
  int M, K;
  int64_t E;
  uint8_t* new_flag;
  uint8_t* deleted;
  EL* stress;             // (6, 8, E) zeroed where dead, or null
  EL* strain;             // (6, E)
  int32_t* carry;         // [deletions, ticket, deleted last step], or null
};

template <typename EL>
__global__ void __launch_bounds__(kBlock)
erosion_kernel(Args<EL> a) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool del = false;
  if (e < a.E) {
    // every load first (the triaxiality too, before any of its in-place
    // stores), so a thread waits for one memory round trip
    EL eq[8], tr[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      eq[k] = __ldg(a.eq_ps + k * a.E + e);
      tr[k] = a.triax[k * a.E + e];
    }
    const bool alive = __ldg(a.flag + e) != 0;
    const int m = __ldg(a.mat_id + e);
    EL v = eq[0];
    for (int k = 1; k < 8; ++k) v = v + eq[k];
    v = v / EL(8);
    if (a.mask_triax && !alive) {
      for (int k = 0; k < 8; ++k) {
        tr[k] = EL(0);
        a.triax[k * a.E + e] = EL(0);
      }
    }
    EL t = tr[0];
    for (int k = 1; k < 8; ++k) t = t + tr[k];
    t = t / EL(8);
    EL fr = (EL)INFINITY;
    if (m >= 0 && m < a.M && a.knot_n[m] > 0) {
      const double* tab = a.knots + (int64_t)m * a.K * 2;
      const int nd = a.knot_n[m];
      fr = (EL)tab[2 * (nd - 1)];
      for (int j = 0; j + 1 < nd; ++j) {
        const double f0 = tab[2 * j], t0 = tab[2 * j + 1];
        const double f1 = tab[2 * j + 2], t1 = tab[2 * j + 3];
        if (t1 == t0) continue;
        const EL t0e = (EL)t0;
        if (t >= t0e && t < (EL)t1) {
          fr = (EL)f0 + (EL)((f1 - f0) / (t1 - t0)) * (t - t0e);
        }
      }
    }
    del = t >= EL(0) && v >= fr && alive;
    const bool keep = alive && !del;
    a.new_flag[e] = keep;
    a.deleted[e] = del;
    if (a.stress && !keep) {
      for (int r = 0; r < 48; ++r) a.stress[r * a.E + e] = EL(0);
      for (int r = 0; r < 6; ++r) a.strain[r * a.E + e] = EL(0);
    }
  }
  if (!a.carry) return;
  const int any = __syncthreads_or(del);
  if (threadIdx.x != 0) return;
  if (any) atomicOr(a.carry, 1);
  __threadfence();
  if (atomicAdd(a.carry + 1, 1) == (int)gridDim.x - 1) {
    a.carry[2] = atomicExch(a.carry, 0) != 0;
    atomicExch(a.carry + 1, 0);
  }
}

template <typename EL>
int entry(const EL* eq_ps, EL* triax, int mask_triax, const uint8_t* flag,
          const int32_t* mat_id, const double* knots, const int32_t* knot_n,
          int M, int K, int E, uint8_t* new_flag, uint8_t* deleted,
          EL* stress, EL* strain, int32_t* carry, void* stream) {
  if (E <= 0) return (int)cudaErrorInvalidValue;
  Args<EL> a{eq_ps, triax, mask_triax, flag, mat_id, knots, knot_n, M, K, E,
             new_flag, deleted, stress, strain, carry};
  const int64_t grid = ((int64_t)E + kBlock - 1) / kBlock;
  erosion_kernel<EL><<<(unsigned)grid, kBlock, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename EL>
int resources(int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, erosion_kernel<EL>);
  if (err != cudaSuccess) return (int)err;
  out[1] = fa.numRegs;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = (int)fa.localSizeBytes;
  out[4] = 0;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, erosion_kernel<EL>, kBlock, 0);
}

}  // namespace

extern "C" {

// eq_ps, triax, mask_triax, flag, mat_id, knots, knot_n, M, K, E, new_flag,
// deleted, stress, strain (null: no zeroing), carry (null: no carried
// flag), stream
int hk_erosion_f32(const float* eq_ps, float* triax, int mask_triax,
                   const uint8_t* flag, const int32_t* mat_id,
                   const double* knots, const int32_t* knot_n, int M, int K,
                   int E, uint8_t* new_flag, uint8_t* deleted, float* stress,
                   float* strain, int32_t* carry, void* stream) {
  return entry<float>(eq_ps, triax, mask_triax, flag, mat_id, knots, knot_n,
                      M, K, E, new_flag, deleted, stress, strain, carry,
                      stream);
}

int hk_erosion_f64(const double* eq_ps, double* triax, int mask_triax,
                   const uint8_t* flag, const int32_t* mat_id,
                   const double* knots, const int32_t* knot_n, int M, int K,
                   int E, uint8_t* new_flag, uint8_t* deleted, double* stress,
                   double* strain, int32_t* carry, void* stream) {
  return entry<double>(eq_ps, triax, mask_triax, flag, mat_id, knots, knot_n,
                       M, K, E, new_flag, deleted, stress, strain, carry,
                       stream);
}

// The resources of instantiation ``which`` (0 f32, 1 f64) into out[5]:
// resident blocks an SM, registers, static shared, local (spill) and
// dynamic shared bytes.
int hk_erosion_resources(int which, int* out) {
  switch (which) {
    case 0: return resources<float>(out);
    case 1: return resources<double>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
