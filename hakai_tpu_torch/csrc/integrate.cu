// Kernel I: the central-difference update of one explicit step.
//
// Replaces the XLA fusion of the JAX step's integrator,
// hakai_tpu/solver/explicit.py:34-119 (amplitude_values, apply_bc and
// _integrate), which jax.jit compiles into a few device kernels a step and
// which ran as some 45 launch-sized PyTorch ops before this kernel.  One
// thread per node does all three dofs:
//
//   t' = t + 1, current_time = t' * dt (read on the device: no host value)
//   each amplitude table's value, first segment holding current_time wins,
//     outside every segment the first segment extrapolated
//   a1 = M / dt^2, a2 = M * C / (2 dt)
//   numer = (F_c - Q + a1 * (2 u - u_prev)) + a2 * u_prev   (F_c: contact)
//   u_new = numer / (a1 + a2), then the prescribed value * its amplitude
//     at BC dofs, then 0 at padding nodes
//   velo = (u_new - u) / dt
//
// and, in the generic step, the element kernel's inputs (coord + u_new) and
// (u_new - u) rounded to the element type (the nodal difference first, as
// the JAX step takes it).  With the energy balance on, each block writes
// its partial sums of (F_c + f_bc) . du_mid and Q . du_mid (du_mid =
// (u_new - u_prev) / 2, f_bc the constraint force at BC dofs), in double;
// the last block to finish sums the partials in block order and stores
// dwork: one launch, and the same bits for the same grid.
//
// Bitwise contract: u_new, velo and the element inputs are the bits of the
// plain version (ops/integrate.py) on the card.  This source is built with
// -fmad=false (_build.SOURCE_FLAGS), every expression keeps the plain
// version's association order, division is IEEE, and the host's Python
// scalars (the damping constant) reach the kernel rounded to the nodal
// type, as PyTorch rounds a scalar against a tensor.
//
// What bounds it on an H100: device-memory bytes.  A node reads its mass,
// existence byte and three dofs of Q, u, u_prev and the BC mask (and the
// contact force), a BC dof its amplitude id and value, and a node writes
// u_new and velo: 68 B a node and 8 B a BC dof in float32 (9.6 MB, 2.9 us
// at the bench bar's 141,312 nodes, before its BC dofs).  The
// amplitude tables are tiny; each block evaluates them once into shared
// memory.  The design is the elementwise one: coalesced rows, no reuse to
// exploit, every launch-time constant read from the device so that a
// captured graph replays it.  A thread issues all its node's loads at
// once, through the non-coherent path, before the amplitude stage: a
// store may alias a later plain load, so loads issued dof by dof would
// wait for one memory round trip a dof.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

template <typename T, typename EL>
struct Args {
  const int32_t* t_in;
  int32_t* t_out;
  const T* dt;
  const T* diag_M;
  T damping;
  const T* Q;
  const T* disp;
  const T* dpre;
  const T* ext;              // contact force, or null
  const uint8_t* bcd_mask;
  const int32_t* bcd_amp;
  const T* bcd_value;
  const T* amp_time;
  const T* amp_value;
  const int32_t* amp_n;
  int A, L;
  const uint8_t* node_exists;
  const T* coord;            // with pos_e/du_e: the element inputs
  int64_t N;
  T* disp_new;
  T* velo;
  EL* pos_e;
  EL* du_e;
  double* partial;           // with dwork: 2 per block
  unsigned* ticket;          // blocks done; the last resets it
  T* dwork;                  // (2,), or null
};

// sum of two doubles over the block, in a fixed tree order; the result in
// thread 0
__device__ void block_sum2(double& a, double& b) {
  __shared__ double s[2][kBlock / 32];
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) {
    s[0][w] = a;
    s[1][w] = b;
  }
  __syncthreads();
  if (w == 0) {
    a = l < kBlock / 32 ? s[0][l] : 0.0;
    b = l < kBlock / 32 ? s[1][l] : 0.0;
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, o);
      b += __shfl_down_sync(0xffffffffu, b, o);
    }
  }
}

template <typename T, typename EL>
__global__ void __launch_bounds__(kBlock)
integrate_kernel(Args<T, EL> a) {
  extern __shared__ unsigned char smem_raw[];
  T* ampv = reinterpret_cast<T*>(smem_raw);
  // the node's loads first, all independent (read-only, through the
  // non-coherent path, so no store below waits for them): they are in
  // flight while the block evaluates the amplitude tables
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = n < a.N;
  const int64_t m = live ? n : 0;
  const T M = __ldg(a.diag_M + m);
  const bool exists = __ldg(a.node_exists + m) != 0;
  T q[3], u[3], up[3], ext[3], crd[3];
  bool bc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int64_t i = c * a.N + m;
    q[c] = __ldg(a.Q + i);
    u[c] = __ldg(a.disp + i);
    up[c] = __ldg(a.dpre + i);
    ext[c] = a.ext ? __ldg(a.ext + i) : T(0);
    crd[c] = a.pos_e ? __ldg(a.coord + i) : T(0);
    bc[c] = __ldg(a.bcd_mask + i) != 0;
  }
  const T dt = __ldg(a.dt);
  const int32_t tn = __ldg(a.t_in) + 1;
  const T ct = (T)tn * dt;
  for (int k = threadIdx.x; k < a.A; k += blockDim.x) {
    const T* tk = a.amp_time + (int64_t)k * a.L;
    const T* vk = a.amp_value + (int64_t)k * a.L;
    T t0 = tk[0], t1 = tk[1], v0 = vk[0], v1 = vk[1];
    bool found = false;
    const int nk = a.amp_n[k];
    for (int j = 0; j < a.L - 1; ++j) {
      const bool inside = ct >= tk[j] && ct <= tk[j + 1] && j < nk - 1
                          && !found;
      if (inside) {
        t0 = tk[j];
        t1 = tk[j + 1];
        v0 = vk[j];
        v1 = vk[j + 1];
        found = true;
      }
    }
    ampv[k] = v0 + (v1 - v0) * (ct - t0) / (t1 - t0);
  }
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.t_out = tn;

  double w_ext = 0.0, w_int = 0.0;
  if (live) {
    const T a1 = M / (dt * dt);
    const T a2 = M * a.damping / (T(2) * dt);
    const T s = a1 + a2;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int64_t i = c * a.N + n;
      const T force = a.ext ? ext[c] - q[c] : -q[c];
      const T numer = force + a1 * (T(2) * u[c] - up[c]) + a2 * up[c];
      T un = numer / s;
      if (bc[c]) {
        const int am = __ldg(a.bcd_amp + i);
        un = __ldg(a.bcd_value + i) * (am >= 0 && am < a.A ? ampv[am]
                                                            : T(1));
      }
      if (!exists) un = T(0);
      a.disp_new[i] = un;
      a.velo[i] = (un - u[c]) / dt;
      if (a.pos_e) {
        a.pos_e[i] = (EL)(crd[c] + un);
        a.du_e[i] = (EL)(un - u[c]);
      }
      if (a.dwork) {
        const T du_mid = T(0.5) * (un - up[c]);
        const T f_c = bc[c] ? s * un - numer : T(0);
        const T we = a.ext ? ext[c] + f_c : f_c;
        w_ext += (double)(we * du_mid);
        w_int += (double)(q[c] * du_mid);
      }
    }
  }
  if (!a.dwork) return;
  block_sum2(w_ext, w_int);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    a.partial[2 * blockIdx.x] = w_ext;
    a.partial[2 * blockIdx.x + 1] = w_int;
    __threadfence();
    last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double e = 0.0, wi = 0.0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x) {
    e += __ldcg(a.partial + 2 * b);
    wi += __ldcg(a.partial + 2 * b + 1);
  }
  block_sum2(e, wi);
  if (threadIdx.x == 0) {
    a.dwork[0] = (T)e;
    a.dwork[1] = (T)wi;
    *a.ticket = 0u;
  }
}

template <typename T, typename EL>
int launch(const Args<T, EL>& a, void* stream) {
  if (a.N <= 0) return (int)cudaErrorInvalidValue;
  const int64_t grid = (a.N + kBlock - 1) / kBlock;
  integrate_kernel<T, EL><<<(unsigned)grid, kBlock, a.A * sizeof(T),
                            (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename EL>
int entry(const int32_t* t_in, int32_t* t_out, const T* dt, const T* diag_M,
          double damping, const T* Q, const T* disp, const T* dpre,
          const T* ext, const uint8_t* bcd_mask, const int32_t* bcd_amp,
          const T* bcd_value, const T* amp_time, const T* amp_value,
          const int32_t* amp_n, int A, int L, const uint8_t* node_exists,
          const T* coord, int N, T* disp_new, T* velo, EL* pos_e, EL* du_e,
          double* partial, unsigned* ticket, T* dwork, void* stream) {
  Args<T, EL> a{t_in, t_out, dt, diag_M, (T)damping, Q, disp, dpre, ext,
                bcd_mask, bcd_amp, bcd_value, amp_time, amp_value, amp_n, A,
                L, node_exists, coord, N, disp_new, velo, pos_e, du_e,
                partial, ticket, dwork};
  return launch<T, EL>(a, stream);
}

template <typename T, typename EL>
int resources(int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, integrate_kernel<T, EL>);
  if (err != cudaSuccess) return (int)err;
  out[1] = fa.numRegs;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = (int)fa.localSizeBytes;
  out[4] = 0;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, integrate_kernel<T, EL>, kBlock, 0);
}

}  // namespace

extern "C" {

// t_in, t_out, dt, diag_M, damping, Q, disp, dpre, ext (null: no contact),
// bcd_mask, bcd_amp, bcd_value, amp_time, amp_value, amp_n, A, L,
// node_exists, coord, N, disp_new, velo, pos_e, du_e (null: no element
// inputs), partial, ticket, dwork (null: no energy balance), stream
int hk_integrate_f32(const int32_t* t_in, int32_t* t_out, const float* dt,
                     const float* diag_M, double damping, const float* Q,
                     const float* disp, const float* dpre, const float* ext,
                     const uint8_t* bcd_mask, const int32_t* bcd_amp,
                     const float* bcd_value, const float* amp_time,
                     const float* amp_value, const int32_t* amp_n, int A,
                     int L, const uint8_t* node_exists, const float* coord,
                     int N, float* disp_new, float* velo, float* pos_e,
                     float* du_e, double* partial, unsigned* ticket,
                     float* dwork, void* stream) {
  return entry<float, float>(t_in, t_out, dt, diag_M, damping, Q, disp, dpre,
                             ext, bcd_mask, bcd_amp, bcd_value, amp_time,
                             amp_value, amp_n, A, L, node_exists, coord, N,
                             disp_new, velo, pos_e, du_e, partial, ticket,
                             dwork, stream);
}

int hk_integrate_f64(const int32_t* t_in, int32_t* t_out, const double* dt,
                     const double* diag_M, double damping, const double* Q,
                     const double* disp, const double* dpre,
                     const double* ext, const uint8_t* bcd_mask,
                     const int32_t* bcd_amp, const double* bcd_value,
                     const double* amp_time, const double* amp_value,
                     const int32_t* amp_n, int A, int L,
                     const uint8_t* node_exists, const double* coord, int N,
                     double* disp_new, double* velo, double* pos_e,
                     double* du_e, double* partial, unsigned* ticket,
                     double* dwork, void* stream) {
  return entry<double, double>(t_in, t_out, dt, diag_M, damping, Q, disp,
                               dpre, ext, bcd_mask, bcd_amp, bcd_value,
                               amp_time, amp_value, amp_n, A, L, node_exists,
                               coord, N, disp_new, velo, pos_e, du_e, partial,
                               ticket, dwork, stream);
}

// float64 nodal state, float32 element inputs (mixed precision)
int hk_integrate_mixed(const int32_t* t_in, int32_t* t_out, const double* dt,
                       const double* diag_M, double damping, const double* Q,
                       const double* disp, const double* dpre,
                       const double* ext, const uint8_t* bcd_mask,
                       const int32_t* bcd_amp, const double* bcd_value,
                       const double* amp_time, const double* amp_value,
                       const int32_t* amp_n, int A, int L,
                       const uint8_t* node_exists, const double* coord, int N,
                       double* disp_new, double* velo, float* pos_e,
                       float* du_e, double* partial, unsigned* ticket,
                       double* dwork, void* stream) {
  return entry<double, float>(t_in, t_out, dt, diag_M, damping, Q, disp,
                              dpre, ext, bcd_mask, bcd_amp, bcd_value,
                              amp_time, amp_value, amp_n, A, L, node_exists,
                              coord, N, disp_new, velo, pos_e, du_e, partial,
                              ticket, dwork, stream);
}

// The resources of instantiation ``which`` (0 f32, 1 f64, 2 mixed) into
// out[5]: resident blocks an SM, registers, static shared, local (spill)
// and dynamic shared bytes (the amplitude values: A * sizeof(T) a launch).
int hk_integrate_resources(int which, int* out) {
  switch (which) {
    case 0: return resources<float, float>(out);
    case 1: return resources<double, double>(out);
    case 2: return resources<double, float>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
