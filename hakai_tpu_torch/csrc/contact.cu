// Penalty contact: the node-vs-triangle narrow phase (kernel N) and the
// per-node force scatter (kernel S).
//
// N is the port's design for hakai_tpu/ops/contact.py:_pair_force's block
// loop (blk_pair, contact.py:252-374), which is XLA on the TPU, not Pallas.
// It evaluates, for every (triangle block, node block) pair that the broad
// phase kept (pair_ok), the +-1 grid-cell test, the self-pair own-element
// exclusion, the circumradius cull, the closed-form solve of
// [v1 v2 -n] x = p - q0 with its accept window 0 <= x1, 0 <= x2,
// x1 + x2 <= 1, 0 < d <= d_lim, and the penalty + Coulomb friction +
// damping force (HAKAI_j.jl:2487-2618).  The reference's own CUDA kernel
// (gpu_contact) is the precedent.
//
// S replaces the TPU's scatter-as-gather chain (blocked_gather through the
// plans plan_fgi, plan_fgt, plan_pick and plan_fx: gather_pallas.py
// _make_diag_kernel and _make_merged_kernel): each node sums its own rows of
// a fixed-order table.
//
// Determinism: no float atomics.  N runs twice over the same block pairs,
// once with a node per thread (its force, summed over the surviving
// triangle blocks in increasing order, each block's triangles in order)
// and once with a triangle per thread (its reaction / 3, summed over the
// surviving node blocks in order, each block's nodes in order): the order
// of hakai_tpu's loop, which adds a whole block's sum per block pair.  Both
// call the same device function on the same inputs, so they agree on every
// accept decision and every per-pair force.  The source is compiled
// without FMA contraction (-fmad=false, set in _build.py) and writes every
// operation in the association order of the plain PyTorch version
// (ops/contact.py), so kernel and plain version take bitwise equal accept
// decisions on equal inputs.
//
// What bounds N on an H100: operations, and in practice their latency: the
// JAX blocking asks for (surviving block pairs) x TB x nb tests, most of
// which fail the integer cell test.  Each CTA of NT threads stages NT
// triangles' geometry (node launch) or NT nodes (triangle launch) in
// shared memory, where the other side reads them by broadcast.  Before
// staging a tile, a CTA drops the items whose cell lies more than one cell
// outside the box of its own items' cells: they would fail the cell test
// against all of them, so the cull is exact, and the tile is compacted in
// order, so every sum keeps its order.  A CTA whose pair's overlap flag is
// false, or whose block pair was culled, skips the work at once without
// any read back to the host.
//
// A launch of either side has a CTA per (own block, tile of NT items),
// too few to fill the card when the own side has few blocks (the slab's
// nodes against the cube's triangles: 10 node blocks x 32 tiles).  So the
// other side's blocks are dealt out over gridDim.z splits, z taking blocks
// z, z + S, z + 2S, ...: each split sums its blocks in increasing order
// into its own rows of a (S, 3, len) buffer, and sum_splits adds the S
// rows in split order.  S depends on the shapes alone, so the order of
// every sum is fixed and two runs are bitwise equal.  On request each
// side also writes, per item and split, its count of accepted pairs (the
// check against the plain version reads them; a step passes none).
//
// S is bound by device-memory bytes: its table (4 bytes a column index)
// and the gathered force columns.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 64;     // threads per CTA = shared-memory tile length

template <typename T>
struct Geo {               // one triangle, as the node test reads it
  T ctr[3], q0[3], vj[3], nrm[3], im[3][3], rmax, kpen;
  int cell[3];
  int en[8];               // own element's nodes (self pairs)
  int in;
};

template <typename T>
struct Node {              // one candidate node
  T p[3], v[3], m;
  int cell[3];
  int id;
  int in;
};

template <typename T>
struct Args {
  const T* kin;            // (6, R): position rows 0..2, velocity 3..5
  int64_t R, t0, t1, t2, cs;   // column offsets of q0/q1/q2 and the nodes
  int F2, Ci, TB, nb, tri_chunks, n_chunks;
  const uint8_t* tri_in;   // (F2,)
  const uint8_t* node_in;  // (Ci,)
  const uint8_t* pair_ok;  // (tri_chunks, n_chunks)
  const uint8_t* overlap;  // ()
  // (3, tri_chunks) and (3, n_chunks) block boxes of the broad phase:
  // q0 over the in-range triangles, positions over the in-range nodes
  const T *tmin, *tmax, *nmin, *nmax;
  const T* lo;             // (3,) grid origin (all_min)
  const T* mass;           // (Ci,)
  const int32_t* ids;      // (Ci,) candidate node ids
  const int32_t* enodes;   // (8, F2) or null
  T young, kc, Cr, myu, d_lim, ddiv;
  T* force;                // row stride ld, columns off ...
  int64_t ld, off;
  int32_t* count;          // (splits, len) accepted pairs per item, or null
  T* part;                 // (splits, 3, len) partial sums, or null
  int splits;              // gridDim.z
};

template <typename T>
__device__ __forceinline__ T mx(T a, T b) { return a > b ? a : b; }

template <typename T>
__device__ __forceinline__ T sq3(T x, T y, T z) { return (x * x + y * y) + z * z; }

template <typename T>
__device__ __forceinline__ int cell_of(T x, T lo, T ddiv) {
  return (int)ceil((x - lo) / ddiv);
}

// per-triangle geometry (contact.py:266-303)
template <typename T, bool SELF>
__device__ void load_geo(const Args<T>& a, int64_t k, Geo<T>& g) {
  T q0[3], q1[3], q2[3], c[3], v1[3], v2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    q0[i] = a.kin[i * a.R + a.t0 + k];
    q1[i] = a.kin[i * a.R + a.t1 + k];
    q2[i] = a.kin[i * a.R + a.t2 + k];
    g.vj[i] = a.kin[(3 + i) * a.R + a.t0 + k];
    g.q0[i] = q0[i];
    c[i] = ((q0[i] + q1[i]) + q2[i]) / T(3);
    g.ctr[i] = c[i];
    v1[i] = q1[i] - q0[i];
    v2[i] = q2[i] - q0[i];
    g.cell[i] = cell_of(q0[i], a.lo[i], a.ddiv);
  }
  const T r0 = sq3(q0[0] - c[0], q0[1] - c[1], q0[2] - c[2]);
  const T r1 = sq3(q1[0] - c[0], q1[1] - c[1], q1[2] - c[2]);
  const T r2 = sq3(q2[0] - c[0], q2[1] - c[1], q2[2] - c[2]);
  g.rmax = sqrt(mx(mx(r0, r1), r2));
  const T L1 = sqrt(sq3(v1[0], v1[1], v1[2]));
  const T L2 = sqrt(sq3(v2[0], v2[1], v2[2]));
  const T Lm = mx(L1, L2);
  const T safe_L = Lm == T(0) ? T(1) : Lm;
  const T cr[3] = {v1[1] * v2[2] - v1[2] * v2[1],
                   v1[2] * v2[0] - v1[0] * v2[2],
                   v1[0] * v2[1] - v1[1] * v2[0]};
  const T mag = sqrt(sq3(cr[0], cr[1], cr[2]));
  const T den = mag == T(0) ? T(1) : mag;
#pragma unroll
  for (int i = 0; i < 3; ++i) g.nrm[i] = cr[i] / den;
  const T d12 = (v1[0] * v2[0] + v1[1] * v2[1]) + v1[2] * v2[2];
  const T S = T(0.5) * sqrt(mx((L1 * L1) * (L2 * L2) - d12 * d12, T(0)));
  g.kpen = ((a.young * S) / safe_L) * a.kc;
  // adjugate rows of A = [v1 v2 -n] over det(A) (my3SolveAb,
  // HAKAI_j.jl:3342-3372); A[k][i] is column k's component i
  const T A[3][3] = {{v1[0], v1[1], v1[2]},
                     {v2[0], v2[1], v2[2]},
                     {-g.nrm[0], -g.nrm[1], -g.nrm[2]}};
  const T det = (((((A[0][0] * A[1][1]) * A[2][2]
                    + (A[1][0] * A[2][1]) * A[0][2])
                   + (A[2][0] * A[0][1]) * A[1][2])
                  - (A[0][0] * A[2][1]) * A[1][2])
                 - (A[1][0] * A[0][1]) * A[2][2])
                - (A[2][0] * A[1][1]) * A[0][2];
  const T sd = det == T(0) ? T(1) : det;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int c1 = (r + 1) % 3, c2 = (r + 2) % 3;
    g.im[r][0] = (A[c1][1] * A[c2][2] - A[c2][1] * A[c1][2]) / sd;
    g.im[r][1] = (A[c2][0] * A[c1][2] - A[c1][0] * A[c2][2]) / sd;
    g.im[r][2] = (A[c1][0] * A[c2][1] - A[c2][0] * A[c1][1]) / sd;
  }
  if (SELF) {
#pragma unroll
    for (int i = 0; i < 8; ++i) g.en[i] = a.enodes[i * (int64_t)a.F2 + k];
  }
  g.in = 1;
}

template <typename T>
__device__ void load_node(const Args<T>& a, int64_t n, Node<T>& nd) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    nd.p[i] = a.kin[i * a.R + a.cs + n];
    nd.v[i] = a.kin[(3 + i) * a.R + a.cs + n];
    nd.cell[i] = cell_of(nd.p[i], a.lo[i], a.ddiv);
  }
  nd.m = a.mass[n];
  nd.id = a.ids[n];
  nd.in = 1;
}

// one (triangle, node) test and force (contact.py:312-340)
template <typename T, bool SELF>
__device__ __forceinline__ bool pair_force(const Args<T>& a, const Geo<T>& g,
                                           const Node<T>& n, T f[3]) {
  if (!(g.in && n.in)) return false;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if (abs(g.cell[i] - n.cell[i]) > 1) return false;
  if (SELF) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (g.en[i] == n.id) return false;
  }
  const T dpc = sqrt(sq3(n.p[0] - g.ctr[0], n.p[1] - g.ctr[1],
                         n.p[2] - g.ctr[2]));
  if (!(dpc < g.rmax)) return false;
  const T b[3] = {n.p[0] - g.q0[0], n.p[1] - g.q0[1], n.p[2] - g.q0[2]};
  const T x1 = (g.im[0][0] * b[0] + g.im[0][1] * b[1]) + g.im[0][2] * b[2];
  const T x2 = (g.im[1][0] * b[0] + g.im[1][1] * b[1]) + g.im[1][2] * b[2];
  const T d = (g.im[2][0] * b[0] + g.im[2][1] * b[1]) + g.im[2][2] * b[2];
  if (!(x1 >= T(0) && x2 >= T(0) && x1 + x2 <= T(1) && d > T(0)
        && d <= a.d_lim))
    return false;
  const T F = g.kpen * d;
  const T vr[3] = {n.v[0] - g.vj[0], n.v[1] - g.vj[1], n.v[2] - g.vj[2]};
  const T magv = sqrt(sq3(vr[0], vr[1], vr[2]));
  const T den = magv == T(0) ? T(1) : magv;
  T ve[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) ve[i] = magv > T(0) ? vr[i] / den : T(0);
  const T dot = (ve[0] * g.nrm[0] + ve[1] * g.nrm[1]) + ve[2] * g.nrm[2];
  const T Cd = (T(2) * sqrt(n.m * g.kpen)) * a.Cr;
  const T mF = a.myu * F;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    f[i] = (F * g.nrm[i] - mF * (ve[i] - dot * g.nrm[i])) - Cd * vr[i];
  return true;
}

__device__ __forceinline__ bool near(const int cell[3], const int lo[3],
                                     const int hi[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if ((long long)cell[i] < (long long)lo[i] - 1
        || (long long)cell[i] > (long long)hi[i] + 1)
      return false;
  return true;
}

// Whether block b's cell box, from its coordinate box, comes within one
// cell of the CTA's cell box [lo, hi].  cell_of is monotone in x (IEEE
// subtraction, division by ddiv > 0 and ceil all are), so the cells of
// the box's corners bound the cells of every item in the block: a block
// that fails this fails every cell test against the CTA's items.
template <typename T>
__device__ __forceinline__ bool block_meets(const Args<T>& a, const T* bmin,
                                            const T* bmax, int nblk, int b,
                                            const int lo[3],
                                            const int hi[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int blo = cell_of(bmin[r * (int64_t)nblk + b], a.lo[r], a.ddiv);
    const int bhi = cell_of(bmax[r * (int64_t)nblk + b], a.lo[r], a.ddiv);
    if ((long long)bhi < (long long)lo[r] - 1
        || (long long)blo > (long long)hi[r] + 1)
      return false;
  }
  return true;
}

// The CTA's box of the grid cells of its active items (lo > hi: none).
// An item of the other side whose cell lies more than one cell outside it
// fails the +-1 cell test against every item of the CTA, so it is skipped
// with the same result as testing it: the cull is exact.
__device__ __forceinline__ void cta_box(bool active, const int cell[3],
                                        int* s_lo, int* s_hi, int lo[3],
                                        int hi[3]) {
  if (threadIdx.x < 3) {
    s_lo[threadIdx.x] = INT_MAX;
    s_hi[threadIdx.x] = INT_MIN;
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      atomicMin(&s_lo[i], cell[i]);
      atomicMax(&s_hi[i], cell[i]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    lo[i] = s_lo[i];
    hi[i] = s_hi[i];
  }
}

// This thread's slot among the CTA's threads with ``keep`` set, in thread
// order (so a compacted tile keeps the items' order); the count in *total.
__device__ __forceinline__ int compact_slot(bool keep, int* s_warp,
                                            int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) s_warp[warp] = __popc(m);
  __syncthreads();
  int off = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    off += w < warp ? s_warp[w] : 0;
    tot += s_warp[w];
  }
  *total = tot;
  return off + __popc(m & ((1u << lane) - 1u));
}

// this CTA's sums for column i of a side of len columns: into the force
// buffer, or into split blockIdx.z's rows of the partial buffer; and the
// item's count of accepted pairs in this split, when asked for
template <typename T>
__device__ __forceinline__ void store(const Args<T>& a, int64_t i,
                                      int64_t len, const T acc[3],
                                      int hits) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    if (a.splits == 1) a.force[r * a.ld + a.off + i] = acc[r];
    else a.part[((int64_t)blockIdx.z * 3 + r) * len + i] = acc[r];
  }
  if (a.count != nullptr) a.count[(int64_t)blockIdx.z * len + i] = hits;
}

// a node per thread: force_i of node block blockIdx.x
template <typename T, bool SELF>
__global__ void __launch_bounds__(NT) narrow_nodes(Args<T> a) {
  __shared__ Geo<T> tile[NT];
  __shared__ int s_lo[3], s_hi[3], s_warp[NT / 32];
  const int c = blockIdx.x;
  const int j = blockIdx.y * NT + threadIdx.x;
  const int64_t n = (int64_t)c * a.nb + j;
  T acc[3] = {T(0), T(0), T(0)};
  int hits = 0;
  if (*a.overlap) {
    Node<T> nd;
    nd.in = 0;
    if (j < a.nb && n < a.Ci && a.node_in[n]) load_node(a, n, nd);
    int lo[3], hi[3];
    cta_box(nd.in, nd.cell, s_lo, s_hi, lo, hi);
    for (int t = blockIdx.z; lo[0] <= hi[0] && t < a.tri_chunks;
         t += gridDim.z) {
      if (!a.pair_ok[(int64_t)t * a.n_chunks + c]
          || !block_meets(a, a.tmin, a.tmax, a.tri_chunks, t, lo, hi))
        continue;
      T blk[3] = {T(0), T(0), T(0)};
      for (int s = 0; s < a.TB; s += NT) {
        const int i = s + threadIdx.x;
        const int64_t k = (int64_t)t * a.TB + i;
        __syncthreads();
        bool keep = false;
        if (i < a.TB && k < a.F2 && a.tri_in[k]) {
          int cell[3];
#pragma unroll
          for (int r = 0; r < 3; ++r)
            cell[r] = cell_of(a.kin[r * a.R + a.t0 + k], a.lo[r], a.ddiv);
          keep = near(cell, lo, hi);
        }
        int m;
        const int slot = compact_slot(keep, s_warp, &m);
        if (keep) load_geo<T, SELF>(a, k, tile[slot]);
        __syncthreads();
        if (!nd.in) continue;
        for (int q = 0; q < m; ++q) {
          T f[3];
          if (pair_force<T, SELF>(a, tile[q], nd, f)) {
#pragma unroll
            for (int r = 0; r < 3; ++r) blk[r] += f[r];
            ++hits;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 3; ++r) acc[r] += blk[r];
    }
  }
  if (j < a.nb) store(a, n, (int64_t)a.n_chunks * a.nb, acc, hits);
}

// a triangle per thread: force_t (the reaction / 3) of triangle block
// blockIdx.x
template <typename T, bool SELF>
__global__ void __launch_bounds__(NT) narrow_tris(Args<T> a) {
  __shared__ Node<T> tile[NT];
  __shared__ int s_lo[3], s_hi[3], s_warp[NT / 32];
  const int t = blockIdx.x;
  const int j = blockIdx.y * NT + threadIdx.x;
  const int64_t k = (int64_t)t * a.TB + j;
  T acc[3] = {T(0), T(0), T(0)};
  int hits = 0;
  if (*a.overlap) {
    Geo<T> g;
    g.in = 0;
    if (j < a.TB && k < a.F2 && a.tri_in[k]) load_geo<T, SELF>(a, k, g);
    int lo[3], hi[3];
    cta_box(g.in, g.cell, s_lo, s_hi, lo, hi);
    for (int c = blockIdx.z; lo[0] <= hi[0] && c < a.n_chunks;
         c += gridDim.z) {
      if (!a.pair_ok[(int64_t)t * a.n_chunks + c]
          || !block_meets(a, a.nmin, a.nmax, a.n_chunks, c, lo, hi))
        continue;
      T blk[3] = {T(0), T(0), T(0)};
      for (int s = 0; s < a.nb; s += NT) {
        const int i = s + threadIdx.x;
        const int64_t n = (int64_t)c * a.nb + i;
        __syncthreads();
        bool keep = false;
        if (i < a.nb && n < a.Ci && a.node_in[n]) {
          int cell[3];
#pragma unroll
          for (int r = 0; r < 3; ++r)
            cell[r] = cell_of(a.kin[r * a.R + a.cs + n], a.lo[r], a.ddiv);
          keep = near(cell, lo, hi);
        }
        int m;
        const int slot = compact_slot(keep, s_warp, &m);
        if (keep) load_node(a, n, tile[slot]);
        __syncthreads();
        if (!g.in) continue;
        for (int q = 0; q < m; ++q) {
          T f[3];
          if (pair_force<T, SELF>(a, g, tile[q], f)) {
#pragma unroll
            for (int r = 0; r < 3; ++r) blk[r] += f[r];
            ++hits;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 3; ++r) acc[r] += blk[r] / T(3);
    }
  }
  if (j < a.TB) store(a, k, (int64_t)a.tri_chunks * a.TB, acc, hits);
}

// sum of the S splits' rows in split order, into the force columns
template <typename T>
__global__ void __launch_bounds__(256)
sum_splits(const T* __restrict__ part, int splits, int64_t len,
           T* __restrict__ force, int64_t ld, int64_t off) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= len) return;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    T s = part[r * len + n];
    for (int z = 1; z < splits; ++z) s += part[((int64_t)z * 3 + r) * len + n];
    force[r * ld + off + n] = s;
  }
}

template <typename T>
int narrow(const Args<T>& a, int side, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool self = a.enodes != nullptr;
  if (a.splits < 1 || (a.splits > 1 && a.part == nullptr))
    return (int)cudaErrorInvalidValue;
  int64_t len;
  if (side == 0) {
    if (a.n_chunks <= 0) return 0;
    const dim3 grid(a.n_chunks, (a.nb + NT - 1) / NT, a.splits);
    if (self) narrow_nodes<T, true><<<grid, NT, 0, st>>>(a);
    else narrow_nodes<T, false><<<grid, NT, 0, st>>>(a);
    len = (int64_t)a.n_chunks * a.nb;
  } else {
    if (a.tri_chunks <= 0) return 0;
    const dim3 grid(a.tri_chunks, (a.TB + NT - 1) / NT, a.splits);
    if (self) narrow_tris<T, true><<<grid, NT, 0, st>>>(a);
    else narrow_tris<T, false><<<grid, NT, 0, st>>>(a);
    len = (int64_t)a.tri_chunks * a.TB;
  }
  if (a.splits > 1)
    sum_splits<T><<<(unsigned)((len + 255) / 256), 256, 0, st>>>(
        a.part, a.splits, len, a.force, a.ld, a.off);
  return (int)cudaGetLastError();
}

// g[c, n] = sum of src[c, col[q]] over q in ptr[n]..mid[n], minus those
// over mid[n]..ptr[n+1], in table order, in T; stored as O
template <typename T, typename O>
__global__ void __launch_bounds__(256)
scatter_kernel(const T* __restrict__ src, int64_t ld,
               const int32_t* __restrict__ ptr,
               const int32_t* __restrict__ mid,
               const int32_t* __restrict__ col, int N, O* __restrict__ out) {
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

template <typename T, typename O>
int scatter(const T* src, int ld, const int32_t* ptr, const int32_t* mid,
            const int32_t* col, int N, O* out, void* stream) {
  if (N <= 0) return 0;
  const int block = 256;
  scatter_kernel<T, O><<<(N + block - 1) / block, block, 0,
                         (cudaStream_t)stream>>>(src, ld, ptr, mid, col, N,
                                                 out);
  return (int)cudaGetLastError();
}

template <typename T>
int narrow_entry(const T* kin, int R, int t0, int t1, int t2, int cs, int F2,
                 int Ci, int TB, int nb, int tri_chunks, int n_chunks,
                 const uint8_t* tri_in, const uint8_t* node_in,
                 const uint8_t* pair_ok, const uint8_t* overlap,
                 const T* tmin, const T* tmax, const T* nmin, const T* nmax,
                 const T* lo, const T* mass, const int32_t* ids,
                 const int32_t* enodes, T young, T kc, T Cr, T myu, T d_lim,
                 T ddiv, T* force, int ld, int off, int32_t* count, T* part,
                 int splits, int side, void* stream) {
  Args<T> a;
  a.kin = kin; a.R = R; a.t0 = t0; a.t1 = t1; a.t2 = t2; a.cs = cs;
  a.F2 = F2; a.Ci = Ci; a.TB = TB; a.nb = nb;
  a.tri_chunks = tri_chunks; a.n_chunks = n_chunks;
  a.tri_in = tri_in; a.node_in = node_in; a.pair_ok = pair_ok;
  a.overlap = overlap; a.tmin = tmin; a.tmax = tmax; a.nmin = nmin;
  a.nmax = nmax; a.lo = lo; a.mass = mass; a.ids = ids;
  a.enodes = enodes; a.young = young; a.kc = kc; a.Cr = Cr; a.myu = myu;
  a.d_lim = d_lim; a.ddiv = ddiv; a.force = force; a.ld = ld; a.off = off;
  a.count = count; a.part = part; a.splits = splits;
  return narrow<T>(a, side, stream);
}

}  // namespace

extern "C" {

// side 0: force_i (a node per thread); side 1: force_t (a triangle per
// thread).  part is (splits, 3, len), or null when splits is 1; count is
// (splits, len) int32, or null: each item's accepted pairs per split.
int hk_narrow_f32(const float* kin, int R, int t0, int t1, int t2, int cs,
                  int F2, int Ci, int TB, int nb, int tri_chunks,
                  int n_chunks, const uint8_t* tri_in, const uint8_t* node_in,
                  const uint8_t* pair_ok, const uint8_t* overlap,
                  const float* tmin, const float* tmax, const float* nmin,
                  const float* nmax, const float* lo, const float* mass,
                  const int32_t* ids, const int32_t* enodes, float young,
                  float kc, float Cr,
                  float myu, float d_lim, float ddiv, float* force, int ld,
                  int off, int32_t* count, float* part, int splits, int side,
                  void* stream) {
  return narrow_entry<float>(kin, R, t0, t1, t2, cs, F2, Ci, TB, nb,
                             tri_chunks, n_chunks, tri_in, node_in, pair_ok,
                             overlap, tmin, tmax, nmin, nmax, lo, mass, ids,
                             enodes, young, kc, Cr, myu, d_lim, ddiv, force,
                             ld, off, count, part, splits, side, stream);
}

int hk_narrow_f64(const double* kin, int R, int t0, int t1, int t2, int cs,
                  int F2, int Ci, int TB, int nb, int tri_chunks,
                  int n_chunks, const uint8_t* tri_in, const uint8_t* node_in,
                  const uint8_t* pair_ok, const uint8_t* overlap,
                  const double* tmin, const double* tmax, const double* nmin,
                  const double* nmax, const double* lo, const double* mass,
                  const int32_t* ids, const int32_t* enodes, double young,
                  double kc, double Cr,
                  double myu, double d_lim, double ddiv, double* force,
                  int ld, int off, int32_t* count, double* part, int splits,
                  int side, void* stream) {
  return narrow_entry<double>(kin, R, t0, t1, t2, cs, F2, Ci, TB, nb,
                              tri_chunks, n_chunks, tri_in, node_in, pair_ok,
                              overlap, tmin, tmax, nmin, nmax, lo, mass,
                              ids, enodes, young, kc, Cr, myu, d_lim, ddiv,
                              force, ld, off, count, part, splits, side,
                              stream);
}

// src, ld, ptr, mid, col, N, out, stream
int hk_scatter_f32(const float* src, int ld, const int32_t* ptr,
                   const int32_t* mid, const int32_t* col, int N, float* out,
                   void* stream) {
  return scatter<float, float>(src, ld, ptr, mid, col, N, out, stream);
}

int hk_scatter_f64(const double* src, int ld, const int32_t* ptr,
                   const int32_t* mid, const int32_t* col, int N,
                   double* out, void* stream) {
  return scatter<double, double>(src, ld, ptr, mid, col, N, out, stream);
}

// float32 sum, stored as float64 (mixed precision)
int hk_scatter_f32_f64(const float* src, int ld, const int32_t* ptr,
                       const int32_t* mid, const int32_t* col, int N,
                       double* out, void* stream) {
  return scatter<float, double>(src, ld, ptr, mid, col, N, out, stream);
}

}  // extern "C"
