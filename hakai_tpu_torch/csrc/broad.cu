// Kernel A: contact activity and the broad phase of one directional pair.
//
// Replaces the XLA fusion of the JAX step's pair_activity and
// _pair_force's prologue, hakai_tpu/ops/contact.py:45-59 and :160-236,
// which ran as some 80 PyTorch ops a pair before this kernel.  Two C
// entries.
//
// hk_broad_list, on a pair whose masks a chunk carries (ops/activity.py),
// before the step's gather (kernel G, which gathers only the listed
// triangles' columns): broad_list, a persistent grid of blocks of 512
// threads, a group of 8 triangle chunks of TB ids a turn (a thread loads
// its slot of each chunk at once).  When ``changed`` is set
// (kernel E's flag that the previous step deleted an element, or the
// chunk's entry) it recomputes the triangle mask
//     tri_active = (initially exposed | twin element dead) & owner alive
// into the carried buffer (JAX's chunk-carried activity,
// hakai_tpu/solver/explicit.py:157-181) and lists the active triangles:
// their ids in increasing order, and per triangle chunk the start of its
// run in the list, an exclusive sum of the chunks' counts (the last entry
// the list's count), so a chunk's items lie side by side.  The sum takes
// one pass, by decoupled look-back: blocks take groups in increasing order
// from a ticket, publish their count, and add the counts their
// predecessors published until they meet a published prefix (a block waits
// only on groups taken before its own, so the grid cannot deadlock).  The
// same sweep clears tri_in on every slot that is not active, so that an
// unlisted slot reads false until the next rebuild (N reads tri_in
// densely), and counts the rebuild.  When ``changed`` is clear every block
// returns at once.
//
// hk_broad_f32/_f64, three launches:
// broad_activity, one block per 256 candidate (i) nodes and per 256 j-side
//   nodes, a node a thread, and, on a pair whose masks are recomputed every
//   call (no carry: ranks), per 1,024 triangles of the inventory: the masks
//     node_active = initially exposed | some owner of an internal face dead
//   (and tri_active as above) recomputed from the life mask when
//   ``changed`` is set (or absent) and else read from the carried buffers;
//   whether any i node (and any triangle) is active (an OR into the
//   workspace); each node block's masked box (min and max of x, y, z over
//   its active nodes).  The last block to finish (a ticket) reduces the
//   node blocks' boxes to the two sides' boxes, their overlap range
//   [lo, hi], ``overlap`` and the grid origin ``all_min``, once a call;
// broad_range: the range cull (a triangle is in unless all three vertices
//   lie below lo, or above hi, on some axis; a node is in if it lies within
//   [lo, hi]), masked by activity, and each chunk's box of its in-range q0
//   vertices (triangles) or positions (nodes) and whether it holds any.  A
//   block per node chunk of nb; on a listed pair two warps per triangle
//   chunk of TB, over that chunk's run of the list only (an empty run gives
//   the empty box and no item), else a block per triangle chunk over its
//   slots;
// broad_pairs, one thread per (triangle chunk, node chunk): ``pair_ok``,
//   both chunks non-empty and their boxes overlapping on every axis with
//   the pad 2 ddiv; it leaves the workspace's ORs zero for the next call.
//
// It writes the BroadPhase that kernel N reads.  Every output is a min, a
// max, an and/or or a comparison of the inputs (the one arithmetic, box -
// pad, rounds the pad to the element type as PyTorch rounds a Python
// scalar), so every output is bitwise the plain version's
// (ops/broad_cuda.py: pair_activity and broad_phase) on the card; mins and
// maxes propagate NaN as torch.amin, amax, minimum and maximum do.  A
// chunk's members are ids / TB on both paths and min and max do not depend
// on order, so the listed path's boxes are the dense sweep's.
//
// What the function needs from device memory: the three vertices of each
// active triangle and the position of each active node (an inactive one
// is out, and in no box, whatever its position), the activity inputs (or
// the carried masks) and the outputs.  The dense sweep's time was set by
// its blocks, one thread a slot of the whole inventory (~5% of it active
// on the impact deck), not by its bytes: skipping an inactive item's reads
// inside the same grid left it unchanged.  So a carried pair visits the
// list.  Every read-only input is loaded through the non-coherent path, so
// the mask and range stores of one item do not hold back the next item's
// loads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kItems = 1024;     // triangles a block of broad_activity
constexpr int kList = 512;       // threads a block of broad_list (>= TB)
constexpr int kGroup = 8;        // triangle chunks a turn of broad_list
constexpr int kBatch = 4;        // items a lane loads at once (broad_range)
constexpr int kWarps = kBlock / 32;
constexpr int kTeam = 64;        // threads a listed chunk of broad_range
// int32 words of the workspace: [any triangle, any i node, broad_activity's
// blocks done, pad], then chunk any (tc + nc)
constexpr int kAny = 4;

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
  // another block's box: read past L1, which may hold a stale line
  __device__ void load(const T* p) {
    for (int d = 0; d < 3; ++d) {
      lo[d] = __ldcg(p + d);
      hi[d] = __ldcg(p + 3 + d);
    }
  }
  __device__ void store(T* p) const {
    for (int d = 0; d < 3; ++d) {
      p[d] = lo[d];
      p[3 + d] = hi[d];
    }
  }
};

// merge the warp's boxes; the result in lane 0
template <typename T>
__device__ void warp_box(Box<T>& b) {
  for (int o = 16; o > 0; o >>= 1) {
    Box<T> x;
    for (int d = 0; d < 3; ++d) {
      x.lo[d] = __shfl_down_sync(0xffffffffu, b.lo[d], o);
      x.hi[d] = __shfl_down_sync(0xffffffffu, b.hi[d], o);
    }
    b.merge(x);
  }
}

// merge the block's boxes; the result in every thread (``scratch``: one box
// a warp)
template <typename T>
__device__ void block_box(Box<T>& b, Box<T>* scratch) {
  warp_box(b);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) scratch[w] = b;
  __syncthreads();
  if (w == 0) {
    if (lane < kWarps) b = scratch[lane];
    else b.clear();
    warp_box(b);
    if (lane == 0) scratch[0] = b;
  }
  __syncthreads();
  b = scratch[0];
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
  // the carried list (null: the dense sweep): active ids, chunk starts
  const int32_t* ids;
  const int32_t* starts;     // (tc + 1,)
  int TB, nb, tc, nc;
  T pad;
  uint8_t* tri_in;
  uint8_t* node_in;
  T* all_min;
  uint8_t* pair_ok;          // (tc, nc)
  uint8_t* overlap;
  T* box;                    // (nbI + nbJ + 1, 6) node blocks' boxes, range
  T* cbox;                   // (tc + nc, 6) chunk boxes
  int32_t* iws;              // kAny words, then chunk any (tc + nc)
  int nbT, nbI, nbJ, tcb;    // blocks: triangle, i, j; range's triangle
};

// the items of a block: what is left of n, at most per
__device__ __forceinline__ int items_left(int64_t left, int64_t per) {
  return (int)(left < per ? left : per);
}

// The activity tests load every input whatever the others hold (a twin of
// -1 reads element 0's flag, unused), so no load waits on another's value
// but the life mask's on the ids: the loads of several items and twins are
// in flight together.
__device__ __forceinline__ bool tri_active(const uint8_t* flag,
                                           const uint8_t* init,
                                           const int32_t* twin,
                                           const int32_t* elem, int64_t f) {
  const int32_t tw = __ldg(twin + f), el = __ldg(elem + f);
  const bool ini = __ldg(init + f) != 0;
  const bool tw_alive = __ldg(flag + (tw >= 0 ? tw : 0)) != 0;
  const bool alive = __ldg(flag + el) != 0;
  return (ini | ((tw >= 0) & !tw_alive)) & alive;
}

__device__ __forceinline__ bool node_active(const uint8_t* flag,
                                            const uint8_t* init,
                                            const int32_t* twin, int VT,
                                            int64_t c) {
  bool a = __ldg(init + c) != 0;
#pragma unroll 4
  for (int k = 0; k < VT; ++k) {
    const int32_t e = __ldg(twin + c * VT + k);
    a = a | ((e >= 0) & !__ldg(flag + (e >= 0 ? e : 0)));
  }
  return a;
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
broad_activity(Args<T> a) {
  __shared__ Box<T> scratch[kWarps];
  const bool dyn = a.flag != nullptr;
  const bool re = a.changed == nullptr || *a.changed != 0;
  const int b = blockIdx.x;
  if (b < a.nbT) {                                       // triangles
    bool any = false;
    const int64_t f0 = (int64_t)b * kItems;
    const int end = items_left(a.F2 - f0, kItems);
#pragma unroll 4
    for (int k = threadIdx.x; k < end; k += kBlock) {
      const int64_t f = f0 + k;
      const bool act = tri_active(a.flag, a.tri_init, a.tri_twin, a.tri_elem,
                                  f);
      a.tri_a[f] = act;
      any = any || act;
    }
    if (__syncthreads_or(any) && threadIdx.x == 0) atomicOr(a.iws, 1);
  } else {                                               // nodes
    const bool side_i = b - a.nbT < a.nbI;
    const int64_t c = (int64_t)(side_i ? b - a.nbT : b - a.nbT - a.nbI)
                      * kBlock + threadIdx.x;
    const int64_t n = side_i ? a.Ci : a.Cj, col = side_i ? a.ci : a.cj;
    uint8_t* mask = side_i ? a.ni_a : a.nj_a;
    Box<T> box;
    box.clear();
    bool act = false;
    if (c < n) {
      const T x0 = __ldg(a.kin + col + c),
              x1 = __ldg(a.kin + a.R + col + c),
              x2 = __ldg(a.kin + 2 * a.R + col + c);
      act = true;
      if (dyn) {
        if (re) {
          act = side_i ? node_active(a.flag, a.cand_init, a.cand_twin, a.VT,
                                     c)
                       : node_active(a.flag, a.jnode_init, a.jnode_twin,
                                     a.VTj, c);
          mask[c] = act;
        } else {
          act = __ldg(mask + c) != 0;
        }
      }
      box.add(act, x0, x1, x2);
    }
    if (__syncthreads_or(act) && side_i && threadIdx.x == 0)
      atomicOr(a.iws + 1, 1);
    block_box(box, scratch);
    if (threadIdx.x == 0) box.store(a.box + 6 * (b - a.nbT));
  }
  // the last block to finish reduces the node blocks' boxes
  // (threadFenceReduction)
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(a.iws + 2, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
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
  if (threadIdx.x != 0) return;
  T* range = a.box + 6 * (a.nbI + a.nbJ);
  bool ov = true;
  for (int d = 0; d < 3; ++d) {
    range[d] = nmax(bi.lo[d], bj.lo[d]);      // torch.maximum(min_i, min_j)
    range[3 + d] = nmin(bi.hi[d], bj.hi[d]);  // torch.minimum(max_i, max_j)
    ov = ov && range[d] <= range[3 + d];
    a.all_min[d] = nmin(bi.lo[d], bj.lo[d]);
  }
  if (dyn) {
    const bool any_tri = a.starts ? __ldcg(a.starts + a.tc) > 0
                                  : __ldcg(a.iws) != 0;
    ov = ov && any_tri && __ldcg(a.iws + 1) != 0;
  }
  *a.overlap = ov;
  a.iws[2] = 0;
}

template <typename T>
__device__ __forceinline__ bool tri_in_range(const Args<T>& a, int64_t f,
                                             const T lo[3], const T hi[3],
                                             T v0[3]) {
  T v[3][3];
  for (int d = 0; d < 3; ++d) {
    v[0][d] = __ldg(a.kin + d * a.R + a.q0 + f);
    v[1][d] = __ldg(a.kin + d * a.R + a.q1 + f);
    v[2][d] = __ldg(a.kin + d * a.R + a.q2 + f);
    v0[d] = v[0][d];
  }
  bool below = false, above = false;
  for (int d = 0; d < 3; ++d) {
    below = below || (v[0][d] < lo[d] && v[1][d] < lo[d] && v[2][d] < lo[d]);
    above = above || (v[0][d] > hi[d] && v[1][d] > hi[d] && v[2][d] > hi[d]);
  }
  return !(below || above);
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
broad_range(Args<T> a) {
  __shared__ Box<T> scratch[kWarps];
  const bool dyn = a.flag != nullptr;
  const T* range = a.box + 6 * (a.nbI + a.nbJ);
  T lo[3], hi[3];
  for (int d = 0; d < 3; ++d) {
    lo[d] = range[d];
    hi[d] = range[3 + d];
  }
  const int b = blockIdx.x;
  Box<T> box;
  box.clear();
  bool any = false;
  if (b < a.tcb && a.starts) {      // two warps per listed triangle chunk
    const int team = threadIdx.x / kTeam, tt = threadIdx.x % kTeam;
    const int c = b * (kBlock / kTeam) + team;
    const bool real = c < a.tc;
    const int end = real ? __ldg(a.starts + c + 1) : 0;
    // kBatch items a thread at once, their loads all in flight together;
    // past the run's end a thread reloads its last item (no branch around
    // the loads) and stores nothing
    for (int k0 = (real ? __ldg(a.starts + c) : 0) + tt; k0 < end;
         k0 += kTeam * kBatch) {
      int64_t f[kBatch];
      bool in[kBatch];
      T v0[kBatch][3];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + kTeam * u;
        f[u] = __ldg(a.ids + (k < end ? k : end - 1));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        in[u] = tri_in_range(a, f[u], lo, hi, v0[u]);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (k0 + kTeam * u >= end) break;
        a.tri_in[f[u]] = in[u];
        any = any || in[u];
        box.add(in[u], v0[u][0], v0[u][1], v0[u][2]);
      }
    }
    __shared__ bool anys[kWarps];
    any = __any_sync(0xffffffffu, any);
    warp_box(box);
    const int w = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      scratch[w] = box;
      anys[w] = any;
    }
    __syncthreads();
    if (tt == 0 && real) {
      for (int k = 1; k < kTeam / 32; ++k) {
        box.merge(scratch[w + k]);
        any = any || anys[w + k];
      }
      box.store(a.cbox + 6 * c);
      a.iws[kAny + c] = any;
    }
    return;
  }
  int chunk;
  if (b < a.tcb) {                                  // a triangle chunk
    chunk = b;
    const int64_t f0 = (int64_t)b * a.TB;
    const int end = items_left(a.F2 - f0, a.TB);
#pragma unroll 2
    for (int k = threadIdx.x; k < end; k += kBlock) {
      const int64_t f = f0 + k;
      T v0[3];
      const bool in = tri_in_range(a, f, lo, hi, v0)
                      && (!dyn || __ldg(a.tri_a + f));
      a.tri_in[f] = in;
      any = any || in;
      box.add(in, v0[0], v0[1], v0[2]);
    }
  } else {                                          // a node chunk
    chunk = a.tc + b - a.tcb;
    const int64_t c0 = (int64_t)(b - a.tcb) * a.nb;
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
    box.store(a.cbox + 6 * chunk);
    a.iws[kAny + chunk] = any;
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
  a.pair_ok[i] = ok && a.iws[kAny + t] && a.iws[kAny + a.tc + n];
}

inline int64_t blocks_of(int64_t n, int64_t per) {
  return (n + per - 1) / per;
}

template <typename T>
int launch(Args<T> a, void* stream) {
  if (a.Ci <= 0 || a.Cj <= 0 || a.F2 <= 0 || a.tc <= 0 || a.nc <= 0
      || (a.starts && !a.flag))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  a.nbT = a.flag && !a.starts ? (int)blocks_of(a.F2, kItems) : 0;
  a.nbI = (int)blocks_of(a.Ci, kBlock);
  a.nbJ = (int)blocks_of(a.Cj, kBlock);
  a.tcb = a.starts ? (int)blocks_of(a.tc, kBlock / kTeam) : a.tc;
  broad_activity<T><<<a.nbT + a.nbI + a.nbJ, kBlock, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  broad_range<T><<<a.tcb + a.nc, kBlock, 0, s>>>(a);
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
          uint8_t* nj_a, const int32_t* changed, const int32_t* ids,
          const int32_t* starts, int TB, int nb, int tc, int nc, double pad,
          uint8_t* tri_in, uint8_t* node_in, T* all_min, uint8_t* pair_ok,
          uint8_t* overlap, T* box, T* cbox, int32_t* iws, void* stream) {
  Args<T> a{kin, R, q0, q1, q2, ci, cj, F2, Ci, Cj, flag, tri_init,
            tri_twin, tri_elem, cand_init, cand_twin, VT, jnode_init,
            jnode_twin, VTj, tri_a, ni_a, nj_a, changed, ids, starts, TB, nb,
            tc, nc, (T)pad, tri_in, node_in, all_min, pair_ok, overlap, box,
            cbox, iws, 0, 0, 0, 0};
  return launch<T>(a, stream);
}

// ---- the list of a carried pair's active triangles ----

struct ListArgs {
  const uint8_t* flag;
  const uint8_t* tri_init;
  const int32_t* tri_twin;
  const int32_t* tri_elem;
  int F2, TB, tc;
  const int32_t* changed;
  uint8_t* tri_a;
  uint8_t* tri_in;
  int32_t* ids;              // (F2,): the first starts[tc] are the list
  int32_t* starts;           // (tc + 1,)
  int32_t* count;            // the list's count, for the gather
  unsigned long long* look;  // (tc + 1,): look-back words, the ticket last
  int32_t* stats;            // [rebuilds after a deletion, listed, most]
  int last;                  // the model's last carried pair: fold stats
};

// a look-back word: the rebuild's tag (3 epoch + 1: the group's count, 3
// epoch + 2: the sum of the counts up to and with the group) over the
// value; a word of an earlier rebuild has a smaller tag
__device__ __forceinline__ unsigned long long look_word(unsigned tag,
                                                        int value) {
  return ((unsigned long long)tag << 32) | (unsigned)value;
}

__global__ void __launch_bounds__(kList) broad_list(ListArgs a) {
  const int changed = *a.changed;
  if (changed == 0) return;
  // per chunk of the turn's group, per warp: its active slots, then their
  // exclusive sum over the group in (chunk, warp) order
  __shared__ unsigned long long turn;
  __shared__ int base, counts[kGroup * (kList / 32)];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int groups = (a.tc + kGroup - 1) / kGroup;
  // the ticket never resets: a rebuild takes groups + gridDim.x tickets
  // (each block one past the groups), so a ticket names its rebuild (the
  // epoch) and its group
  const unsigned long long per = groups + gridDim.x;
  for (;;) {
    if (t == 0) turn = atomicAdd(a.look + a.tc, 1ull);
    __syncthreads();
    const unsigned epoch = (unsigned)(turn / per);
    const int g = (int)(turn - epoch * per);
    if (g >= groups) break;
    const unsigned agg = 3 * epoch + 1, incl = 3 * epoch + 2;
    // slot t of each chunk of the group: kGroup independent loads in flight
    bool act[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int64_t f = (int64_t)(g * kGroup + u) * a.TB + t;
      const bool slot = t < a.TB && f < a.F2;
      act[u] = slot & tri_active(a.flag, a.tri_init, a.tri_twin, a.tri_elem,
                                 slot ? f : 0);
    }
    unsigned bal[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int64_t f = (int64_t)(g * kGroup + u) * a.TB + t;
      if (t < a.TB && f < a.F2) {
        a.tri_a[f] = act[u];
        if (!act[u]) a.tri_in[f] = 0;
      }
      bal[u] = __ballot_sync(0xffffffffu, act[u]);
      if (lane == 0) counts[u * (kList / 32) + w] = __popc(bal[u]);
    }
    __syncthreads();
    if (w == 0) {
      // the group's kGroup x 16 counts, kGroup / 2 a lane, summed in order
      constexpr int per_lane = kGroup * (kList / 32) / 32;
      int own[per_lane], x = 0;
#pragma unroll
      for (int q = 0; q < per_lane; ++q) {
        own[q] = counts[lane * per_lane + q];
        x += own[q];
      }
      const int mine = x;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      const int count = __shfl_sync(0xffffffffu, x, 31);
      int run = x - mine;
#pragma unroll
      for (int q = 0; q < per_lane; ++q) {
        counts[lane * per_lane + q] = run;
        run += own[q];
      }
      volatile unsigned long long* look = a.look;
      int before = 0;
      if (g == 0) {
        if (lane == 0) look[g] = look_word(incl, count);
      } else {
        if (lane == 0) look[g] = look_word(agg, count);
        // a window of 32 predecessors a lane each, nearest first: the
        // counts up to the nearest published prefix, taken with it (before
        // group 0: a prefix of 0)
        for (int top = g - 1;; top -= 32) {
          const int j = top - lane;
          unsigned long long word = j >= 0 ? look[j] : look_word(incl, 0);
          while ((unsigned)(word >> 32) < agg) word = look[j];
          const unsigned prefix =
              __ballot_sync(0xffffffffu, (unsigned)(word >> 32) == incl);
          const int stop = prefix ? __ffs(prefix) - 1 : 31;
          before += __reduce_add_sync(
              0xffffffffu, lane <= stop ? (int)(unsigned)word : 0);
          if (prefix) break;
        }
        if (lane == 0) look[g] = look_word(incl, before + count);
      }
      if (lane == 0) {
        base = before;
        if (g == groups - 1) {
          a.starts[a.tc] = before + count;
          *a.count = before + count;
          a.stats[1] += before + count;
          if (a.last) {
            a.stats[2] = max(a.stats[2], a.stats[1]);
            a.stats[1] = 0;
            a.stats[0] += changed & 1;
          }
        }
      }
    }
    __syncthreads();
    if (t < kGroup) {
      const int c = g * kGroup + t;
      if (c < a.tc) a.starts[c] = base + counts[t * (kList / 32)];
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (act[u])
        a.ids[base + counts[u * (kList / 32) + w]
              + __popc(bal[u] & ((1u << lane) - 1u))] =
            (int)((int64_t)(g * kGroup + u) * a.TB + t);
    }
    __syncthreads();
  }
}

// resident blocks a device: the persistent grid of broad_list
int list_grid(int* out) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, broad_list,
                                                        kList, 0);
    if (err != cudaSuccess) return (int)err;
    cached[dev] = sms * (per > 0 ? per : 1);
  }
  *out = cached[dev];
  return 0;
}

template <typename T>
int resources(int stage, int* out) {
  const void* k = stage == 0   ? (const void*)broad_activity<T>
                  : stage == 1 ? (const void*)broad_range<T>
                  : stage == 2 ? (const void*)broad_pairs<T>
                               : (const void*)broad_list;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return (int)err;
  out[1] = fa.numRegs;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = (int)fa.localSizeBytes;
  out[4] = 0;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, k, stage == 3 ? kList : kBlock, 0);
}

}  // namespace

extern "C" {

// kin, R, q0, q1, q2, ci, cj (column offsets), F2, Ci, Cj, flag (null: a
// fracture-free pair), tri_init, tri_twin, tri_elem, cand_init, cand_twin,
// VT, jnode_init, jnode_twin, VTj, tri_a, ni_a, nj_a, changed (null:
// recompute), ids, starts (null: the dense sweep), TB, nb, tri_chunks,
// n_chunks, pad, tri_in, node_in, all_min, pair_ok, overlap, box, cbox,
// iws, stream
int hk_broad_f32(const float* kin, int R, int q0, int q1, int q2, int ci,
                 int cj, int F2, int Ci, int Cj, const uint8_t* flag,
                 const uint8_t* tri_init, const int32_t* tri_twin,
                 const int32_t* tri_elem, const uint8_t* cand_init,
                 const int32_t* cand_twin, int VT, const uint8_t* jnode_init,
                 const int32_t* jnode_twin, int VTj, uint8_t* tri_a,
                 uint8_t* ni_a, uint8_t* nj_a, const int32_t* changed,
                 const int32_t* ids, const int32_t* starts, int TB, int nb,
                 int tc, int nc, double pad, uint8_t* tri_in,
                 uint8_t* node_in, float* all_min, uint8_t* pair_ok,
                 uint8_t* overlap, float* box, float* cbox, int32_t* iws,
                 void* stream) {
  return entry<float>(kin, R, q0, q1, q2, ci, cj, F2, Ci, Cj, flag, tri_init,
                      tri_twin, tri_elem, cand_init, cand_twin, VT,
                      jnode_init, jnode_twin, VTj, tri_a, ni_a, nj_a, changed,
                      ids, starts, TB, nb, tc, nc, pad, tri_in, node_in,
                      all_min, pair_ok, overlap, box, cbox, iws, stream);
}

int hk_broad_f64(const double* kin, int R, int q0, int q1, int q2, int ci,
                 int cj, int F2, int Ci, int Cj, const uint8_t* flag,
                 const uint8_t* tri_init, const int32_t* tri_twin,
                 const int32_t* tri_elem, const uint8_t* cand_init,
                 const int32_t* cand_twin, int VT, const uint8_t* jnode_init,
                 const int32_t* jnode_twin, int VTj, uint8_t* tri_a,
                 uint8_t* ni_a, uint8_t* nj_a, const int32_t* changed,
                 const int32_t* ids, const int32_t* starts, int TB, int nb,
                 int tc, int nc, double pad, uint8_t* tri_in,
                 uint8_t* node_in, double* all_min, uint8_t* pair_ok,
                 uint8_t* overlap, double* box, double* cbox, int32_t* iws,
                 void* stream) {
  return entry<double>(kin, R, q0, q1, q2, ci, cj, F2, Ci, Cj, flag,
                       tri_init, tri_twin, tri_elem, cand_init, cand_twin, VT,
                       jnode_init, jnode_twin, VTj, tri_a, ni_a, nj_a,
                       changed, ids, starts, TB, nb, tc, nc, pad, tri_in,
                       node_in, all_min, pair_ok, overlap, box, cbox, iws,
                       stream);
}

// flag, tri_init, tri_twin, tri_elem, F2, TB, tri_chunks, changed, tri_a,
// tri_in, ids, starts, count, look, stats, last, stream
int hk_broad_list(const uint8_t* flag, const uint8_t* tri_init,
                  const int32_t* tri_twin, const int32_t* tri_elem, int F2,
                  int TB, int tc, const int32_t* changed, uint8_t* tri_a,
                  uint8_t* tri_in, int32_t* ids, int32_t* starts,
                  int32_t* count, unsigned long long* look, int32_t* stats,
                  int last, void* stream) {
  if (F2 <= 0 || TB <= 0 || TB > kList || tc != (F2 + TB - 1) / TB)
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  const int err = list_grid(&grid);
  if (err != 0) return err;
  ListArgs a{flag, tri_init, tri_twin, tri_elem, F2, TB, tc, changed, tri_a,
             tri_in, ids, starts, count, look, stats, last};
  const int groups = (tc + kGroup - 1) / kGroup;
  const int blocks = grid < groups ? grid : groups;
  broad_list<<<blocks, kList, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The resources of launch ``stage`` (0 broad_activity, 1 broad_range, 2
// broad_pairs, 3 broad_list) of instantiation ``which`` (0 f32, 1 f64) into
// out[5]: resident blocks an SM, registers, static shared, local (spill)
// and dynamic shared bytes.
int hk_broad_resources(int which, int stage, int* out) {
  switch (which) {
    case 0: return resources<float>(stage, out);
    case 1: return resources<double>(stage, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
