// Kernel A: contact activity and the broad phase of one directional pair.
//
// Replaces the XLA fusion of the JAX step's pair_activity and
// _pair_force's prologue, hakai_tpu/ops/contact.py:45-59 and :160-236,
// which ran as some 80 PyTorch ops a pair before this kernel.  Three
// launches a pair:
//
// broad_activity, one block per 1,024 items of the triangle inventory, the
//   candidate (i) nodes and the j-side nodes: the activity masks
//     tri_active = (initially exposed | twin element dead) & owner alive
//     node_active = initially exposed | some owner of an internal face dead
//   recomputed from the life mask when ``changed`` is set (kernel E's flag
//   that the previous step deleted an element, or no flag: always) and
//   else read from the buffers that carry them (JAX's chunk-carried
//   activity, hakai_tpu/solver/explicit.py:157-181); whether any triangle
//   and any i node is active (an OR into the workspace); each node block's
//   masked box (min and max of x, y, z over its active nodes);
// broad_range, one block per triangle chunk of TB and per node chunk of
//   nb: every block first reduces the node blocks' boxes (a few dozen) to
//   the two sides' boxes, their overlap range [lo, hi], ``overlap`` and the
//   grid origin ``all_min`` (block 0 stores these); then its chunk's
//   range cull (a triangle is in unless all three vertices lie below lo,
//   or above hi, on some axis; a node is in if it lies within [lo, hi]),
//   masked by activity, and the chunk's box of its in-range q0 vertices
//   (triangles) or positions (nodes) and whether it holds any;
// broad_pairs, one thread per (triangle chunk, node chunk): ``pair_ok``,
//   both chunks non-empty and their boxes overlapping on every axis with
//   the pad 2 ddiv; it leaves the workspace's ORs zero for the next call.
//
// It writes the BroadPhase that kernel N reads.  Every output is a min, a
// max, an and/or or a comparison of the inputs (the one arithmetic, box -
// pad, rounds the pad to the element type as PyTorch rounds a Python
// scalar), so every output is bitwise the plain version's
// (ops/broad_cuda.py: pair_activity and broad_phase) on the card; mins and
// maxes propagate NaN as torch.amin, amax, minimum and maximum do.
//
// What the function needs from device memory: the three vertices of each
// active triangle and the position of each active node (an inactive one
// is out, and in no box, whatever its position), the activity inputs (or
// the carried masks) and the outputs, 6.5 MB a step for both pairs of the
// impact deck at its first deletion with the masks kept (65,280 of its
// 1,437,696 triangles active).  The kernel reads every item's
// coordinates all the same: skipping an inactive item's left its time
// unchanged on an H100, so bytes do not set it.  The node blocks'
// partial boxes are reduced again by every block of the second launch
// from L2, a few kB each, in place of a fourth launch; blocks of 1,024
// items put the impact deck's node sides (18,818 and 117,649 nodes) on
// 19 and 115 blocks.  Every read-only input is loaded through the non-coherent
// path, so the mask and range stores of one item do not hold back the
// next item's loads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kItems = 1024;     // items a block of broad_activity

template <typename T>
__device__ __forceinline__ T nmin(T a, T b) {
  return (isnan(a) || a < b) ? a : b;
}

template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  return (isnan(a) || a > b) ? a : b;
}

template <typename T>
struct Box {
  T lo[3], hi[3];
  __device__ void clear() {
    for (int d = 0; d < 3; ++d) {
      lo[d] = (T)INFINITY;
      hi[d] = -(T)INFINITY;
    }
  }
  // x of an item that is in (else +inf / -inf, as the plain where())
  __device__ void add(bool in, T x0, T x1, T x2) {
    const T x[3] = {x0, x1, x2};
    for (int d = 0; d < 3; ++d) {
      lo[d] = nmin(lo[d], in ? x[d] : (T)INFINITY);
      hi[d] = nmax(hi[d], in ? x[d] : -(T)INFINITY);
    }
  }
  __device__ void merge(const Box& o) {
    for (int d = 0; d < 3; ++d) {
      lo[d] = nmin(lo[d], o.lo[d]);
      hi[d] = nmax(hi[d], o.hi[d]);
    }
  }
  __device__ void load(const T* p) {
    for (int d = 0; d < 3; ++d) {
      lo[d] = p[d];
      hi[d] = p[3 + d];
    }
  }
  __device__ void store(T* p) const {
    for (int d = 0; d < 3; ++d) {
      p[d] = lo[d];
      p[3 + d] = hi[d];
    }
  }
};

// merge the block's boxes; the result in every thread (``scratch``: one box
// a warp)
template <typename T>
__device__ void block_box(Box<T>& b, Box<T>* scratch) {
  for (int o = 16; o > 0; o >>= 1) {
    Box<T> x;
    for (int d = 0; d < 3; ++d) {
      x.lo[d] = __shfl_down_sync(0xffffffffu, b.lo[d], o);
      x.hi[d] = __shfl_down_sync(0xffffffffu, b.hi[d], o);
    }
    b.merge(x);
  }
  const int w = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[w] = b;
  __syncthreads();
  b = scratch[0];
  for (int k = 1; k < kBlock / 32; ++k) b.merge(scratch[k]);
}

template <typename T>
struct Args {
  const T* kin;              // (6, R) merged kinematics
  int64_t R;
  int64_t q0, q1, q2, ci, cj;  // the pair's column offsets in kin
  int F2, Ci, Cj;
  // activity inputs (null flag: a fracture-free pair, all active)
  const uint8_t* flag;
  const uint8_t* tri_init;
  const int32_t* tri_twin;
  const int32_t* tri_elem;
  const uint8_t* cand_init;
  const int32_t* cand_twin;  // (Ci, VT)
  int VT;
  const uint8_t* jnode_init;
  const int32_t* jnode_twin;  // (Cj, VTj)
  int VTj;
  uint8_t* tri_a;            // the masks, written when recomputed
  uint8_t* ni_a;
  uint8_t* nj_a;
  const int32_t* changed;    // recompute when set; null: always
  int TB, nb, tc, nc;
  T pad;
  uint8_t* tri_in;
  uint8_t* node_in;
  T* all_min;
  uint8_t* pair_ok;          // (tc, nc)
  uint8_t* overlap;
  T* box;                    // (nbI + nbJ, 6) node blocks' boxes
  T* cbox;                   // (tc + nc, 6) chunk boxes
  int32_t* iws;              // [any triangle, any i node, chunk any (tc+nc)]
  int nbT, nbI, nbJ;
};

// the items of a block: what is left of n, at most per
__device__ __forceinline__ int items_left(int64_t left, int64_t per) {
  return (int)(left < per ? left : per);
}

__device__ __forceinline__ bool node_active(const uint8_t* flag,
                                            const uint8_t* init,
                                            const int32_t* twin, int VT,
                                            int64_t c) {
  bool a = __ldg(init + c) != 0;
  for (int k = 0; k < VT; ++k) {
    const int32_t e = __ldg(twin + c * VT + k);
    a = a || (e >= 0 && !__ldg(flag + e));
  }
  return a;
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
broad_activity(Args<T> a) {
  __shared__ Box<T> scratch[kBlock / 32];
  const bool dyn = a.flag != nullptr;
  const bool re = a.changed == nullptr || *a.changed != 0;
  int b = blockIdx.x;
  if (b < a.nbT) {                                       // triangles
    bool any = false;
    const int64_t f0 = (int64_t)b * kItems;
    const int end = items_left(a.F2 - f0, kItems);
#pragma unroll 4
    for (int k = threadIdx.x; k < end; k += kBlock) {
      const int64_t f = f0 + k;
      bool act;
      if (re) {
        const int32_t tw = __ldg(a.tri_twin + f);
        act = (__ldg(a.tri_init + f) || (tw >= 0 && !__ldg(a.flag + tw)))
              && __ldg(a.flag + __ldg(a.tri_elem + f));
        a.tri_a[f] = act;
      } else {
        act = __ldg(a.tri_a + f) != 0;
      }
      any = any || act;
    }
    if (__syncthreads_or(any) && threadIdx.x == 0) atomicOr(a.iws, 1);
    return;
  }
  b -= a.nbT;
  const bool side_i = b < a.nbI;
  const int64_t blk = side_i ? b : b - a.nbI;
  const int64_t n = side_i ? a.Ci : a.Cj, col = side_i ? a.ci : a.cj;
  uint8_t* mask = side_i ? a.ni_a : a.nj_a;
  Box<T> box;
  box.clear();
  bool any = false;
  const int end = items_left(n - blk * kItems, kItems);
#pragma unroll 4
  for (int k = threadIdx.x; k < end; k += kBlock) {
    const int64_t c = blk * kItems + k;
    const T x0 = __ldg(a.kin + col + c), x1 = __ldg(a.kin + a.R + col + c),
            x2 = __ldg(a.kin + 2 * a.R + col + c);
    bool act = true;
    if (dyn) {
      if (re) {
        act = side_i ? node_active(a.flag, a.cand_init, a.cand_twin, a.VT, c)
                     : node_active(a.flag, a.jnode_init, a.jnode_twin, a.VTj,
                                   c);
        mask[c] = act;
      } else {
        act = __ldg(mask + c) != 0;
      }
    }
    any = any || act;
    box.add(act, x0, x1, x2);
  }
  if (__syncthreads_or(any) && side_i && threadIdx.x == 0)
    atomicOr(a.iws + 1, 1);
  block_box(box, scratch);
  if (threadIdx.x == 0) box.store(a.box + 6 * b);
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
broad_range(Args<T> a) {
  __shared__ Box<T> scratch[kBlock / 32];
  const bool dyn = a.flag != nullptr;
  Box<T> bi, bj;
  bi.clear();
  bj.clear();
  for (int k = threadIdx.x; k < a.nbI + a.nbJ; k += kBlock) {
    Box<T> x;
    x.load(a.box + 6 * k);
    if (k < a.nbI) bi.merge(x);
    else bj.merge(x);
  }
  block_box(bi, scratch);
  block_box(bj, scratch);
  T lo[3], hi[3];
  for (int d = 0; d < 3; ++d) {
    lo[d] = nmax(bi.lo[d], bj.lo[d]);        // torch.maximum(min_i, min_j)
    hi[d] = nmin(bi.hi[d], bj.hi[d]);        // torch.minimum(max_i, max_j)
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    bool ov = lo[0] <= hi[0] && lo[1] <= hi[1] && lo[2] <= hi[2];
    if (dyn) ov = ov && a.iws[0] != 0 && a.iws[1] != 0;
    *a.overlap = ov;
    for (int d = 0; d < 3; ++d) a.all_min[d] = nmin(bi.lo[d], bj.lo[d]);
  }
  const int b = blockIdx.x;
  Box<T> box;
  box.clear();
  bool any = false;
  if (b < a.tc) {                                   // a triangle chunk
    const int64_t f0 = (int64_t)b * a.TB;
    const int end = items_left(a.F2 - f0, a.TB);
#pragma unroll 2
    for (int k = threadIdx.x; k < end; k += kBlock) {
      const int64_t f = f0 + k;
      T v[3][3];
      for (int d = 0; d < 3; ++d) {
        v[0][d] = __ldg(a.kin + d * a.R + a.q0 + f);
        v[1][d] = __ldg(a.kin + d * a.R + a.q1 + f);
        v[2][d] = __ldg(a.kin + d * a.R + a.q2 + f);
      }
      bool below = false, above = false;
      for (int d = 0; d < 3; ++d) {
        below = below || (v[0][d] < lo[d] && v[1][d] < lo[d]
                          && v[2][d] < lo[d]);
        above = above || (v[0][d] > hi[d] && v[1][d] > hi[d]
                          && v[2][d] > hi[d]);
      }
      const bool in = !(below || above) && (!dyn || __ldg(a.tri_a + f));
      a.tri_in[f] = in;
      any = any || in;
      box.add(in, v[0][0], v[0][1], v[0][2]);
    }
  } else {                                          // a node chunk
    const int64_t c0 = (int64_t)(b - a.tc) * a.nb;
    const int end = items_left(a.Ci - c0, a.nb);
#pragma unroll 4
    for (int k = threadIdx.x; k < end; k += kBlock) {
      const int64_t c = c0 + k;
      T p[3];
      bool in = !dyn || __ldg(a.ni_a + c);
      for (int d = 0; d < 3; ++d) {
        p[d] = __ldg(a.kin + d * a.R + a.ci + c);
        in = in && p[d] >= lo[d] && p[d] <= hi[d];
      }
      a.node_in[c] = in;
      any = any || in;
      box.add(in, p[0], p[1], p[2]);
    }
  }
  any = __syncthreads_or(any);
  block_box(box, scratch);
  if (threadIdx.x == 0) {
    box.store(a.cbox + 6 * b);
    a.iws[2 + b] = any;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
broad_pairs(Args<T> a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) {
    a.iws[0] = 0;
    a.iws[1] = 0;
  }
  if (i >= (int64_t)a.tc * a.nc) return;
  const int t = (int)(i / a.nc), n = (int)(i - (int64_t)t * a.nc);
  const T* bt = a.cbox + 6 * t;
  const T* bn = a.cbox + 6 * (a.tc + n);
  bool ok = true;
  for (int d = 0; d < 3; ++d)
    ok = ok && bt[d] - a.pad <= bn[3 + d] && bn[d] - a.pad <= bt[3 + d];
  a.pair_ok[i] = ok && a.iws[2 + t] && a.iws[2 + a.tc + n];
}

inline int64_t blocks_of(int64_t n, int64_t per) {
  return (n + per - 1) / per;
}

template <typename T>
int launch(Args<T> a, void* stream) {
  if (a.Ci <= 0 || a.Cj <= 0 || a.F2 <= 0 || a.tc <= 0 || a.nc <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  a.nbT = a.flag ? (int)blocks_of(a.F2, kItems) : 0;
  a.nbI = (int)blocks_of(a.Ci, kItems);
  a.nbJ = (int)blocks_of(a.Cj, kItems);
  broad_activity<T><<<a.nbT + a.nbI + a.nbJ, kBlock, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  broad_range<T><<<a.tc + a.nc, kBlock, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t g = blocks_of((int64_t)a.tc * a.nc, kBlock);
  broad_pairs<T><<<(unsigned)g, kBlock, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int entry(const T* kin, int R, int q0, int q1, int q2, int ci, int cj,
          int F2, int Ci, int Cj, const uint8_t* flag,
          const uint8_t* tri_init, const int32_t* tri_twin,
          const int32_t* tri_elem, const uint8_t* cand_init,
          const int32_t* cand_twin, int VT, const uint8_t* jnode_init,
          const int32_t* jnode_twin, int VTj, uint8_t* tri_a, uint8_t* ni_a,
          uint8_t* nj_a, const int32_t* changed, int TB, int nb, int tc,
          int nc, double pad, uint8_t* tri_in, uint8_t* node_in, T* all_min,
          uint8_t* pair_ok, uint8_t* overlap, T* box, T* cbox, int32_t* iws,
          void* stream) {
  Args<T> a{kin, R, q0, q1, q2, ci, cj, F2, Ci, Cj, flag, tri_init,
            tri_twin, tri_elem, cand_init, cand_twin, VT, jnode_init,
            jnode_twin, VTj, tri_a, ni_a, nj_a, changed, TB, nb, tc, nc,
            (T)pad, tri_in, node_in, all_min, pair_ok, overlap, box, cbox,
            iws, 0, 0, 0};
  return launch<T>(a, stream);
}

template <typename T>
int resources(int stage, int* out) {
  const void* k = stage == 0 ? (const void*)broad_activity<T>
                  : stage == 1 ? (const void*)broad_range<T>
                               : (const void*)broad_pairs<T>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return (int)err;
  out[1] = fa.numRegs;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = (int)fa.localSizeBytes;
  out[4] = 0;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, kBlock,
                                                            0);
}

}  // namespace

extern "C" {

// kin, R, q0, q1, q2, ci, cj (column offsets), F2, Ci, Cj, flag (null: a
// fracture-free pair), tri_init, tri_twin, tri_elem, cand_init, cand_twin,
// VT, jnode_init, jnode_twin, VTj, tri_a, ni_a, nj_a, changed (null:
// recompute), TB, nb, tri_chunks, n_chunks, pad, tri_in, node_in, all_min,
// pair_ok, overlap, box, cbox, iws, stream
int hk_broad_f32(const float* kin, int R, int q0, int q1, int q2, int ci,
                 int cj, int F2, int Ci, int Cj, const uint8_t* flag,
                 const uint8_t* tri_init, const int32_t* tri_twin,
                 const int32_t* tri_elem, const uint8_t* cand_init,
                 const int32_t* cand_twin, int VT, const uint8_t* jnode_init,
                 const int32_t* jnode_twin, int VTj, uint8_t* tri_a,
                 uint8_t* ni_a, uint8_t* nj_a, const int32_t* changed,
                 int TB, int nb, int tc, int nc, double pad, uint8_t* tri_in,
                 uint8_t* node_in, float* all_min, uint8_t* pair_ok,
                 uint8_t* overlap, float* box, float* cbox, int32_t* iws,
                 void* stream) {
  return entry<float>(kin, R, q0, q1, q2, ci, cj, F2, Ci, Cj, flag, tri_init,
                      tri_twin, tri_elem, cand_init, cand_twin, VT,
                      jnode_init, jnode_twin, VTj, tri_a, ni_a, nj_a, changed,
                      TB, nb, tc, nc, pad, tri_in, node_in, all_min, pair_ok,
                      overlap, box, cbox, iws, stream);
}

int hk_broad_f64(const double* kin, int R, int q0, int q1, int q2, int ci,
                 int cj, int F2, int Ci, int Cj, const uint8_t* flag,
                 const uint8_t* tri_init, const int32_t* tri_twin,
                 const int32_t* tri_elem, const uint8_t* cand_init,
                 const int32_t* cand_twin, int VT, const uint8_t* jnode_init,
                 const int32_t* jnode_twin, int VTj, uint8_t* tri_a,
                 uint8_t* ni_a, uint8_t* nj_a, const int32_t* changed,
                 int TB, int nb, int tc, int nc, double pad, uint8_t* tri_in,
                 uint8_t* node_in, double* all_min, uint8_t* pair_ok,
                 uint8_t* overlap, double* box, double* cbox, int32_t* iws,
                 void* stream) {
  return entry<double>(kin, R, q0, q1, q2, ci, cj, F2, Ci, Cj, flag,
                       tri_init, tri_twin, tri_elem, cand_init, cand_twin, VT,
                       jnode_init, jnode_twin, VTj, tri_a, ni_a, nj_a,
                       changed, TB, nb, tc, nc, pad, tri_in, node_in, all_min,
                       pair_ok, overlap, box, cbox, iws, stream);
}

// The resources of launch ``stage`` (0 broad_activity, 1 broad_range, 2
// broad_pairs) of instantiation ``which`` (0 f32, 1 f64) into out[5]:
// resident blocks an SM, registers, static shared, local (spill) and
// dynamic shared bytes.
int hk_broad_resources(int which, int stage, int* out) {
  switch (which) {
    case 0: return resources<float>(stage, out);
    case 1: return resources<double>(stage, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
