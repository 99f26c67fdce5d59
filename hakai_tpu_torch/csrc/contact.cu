// Penalty contact: the node-vs-triangle narrow phase (kernel N) and the
// per-node force scatter (kernel S).
//
// N is the port's design for hakai_tpu/ops/contact.py:_pair_force's block
// loop (blk_pair, contact.py:252-374), which is XLA on the TPU, not Pallas.
// It evaluates, for the (triangle, node) pairs of the block pairs that the
// broad phase kept (pair_ok), the +-1 grid-cell test, the self-pair
// own-element exclusion, the circumradius cull, the closed-form solve of
// [v1 v2 -n] x = p - q0 with its accept window 0 <= x1, 0 <= x2,
// x1 + x2 <= 1, 0 < d <= d_lim, and the penalty + Coulomb friction +
// damping force (HAKAI_j.jl:2487-2618).  The reference's own CUDA kernel
// (gpu_contact) is the precedent.
//
// S replaces the TPU's scatter-as-gather chain (blocked_gather through the
// plans plan_fgi, plan_fgt, plan_pick and plan_fx: gather_pallas.py
// _make_diag_kernel and _make_merged_kernel): each node sums its own rows of
// a fixed-order table, in table order: no atomics, no reassociation.
//
// What bounds N on an H100: the JAX blocking asks for (surviving block
// pairs) x TB x nb tests, 3.6e9 at the contact deck's kernel state, of
// which only the pairs within one grid cell of each other can pass the
// cell test; reading each in-range item once and writing each force
// column once (21 MB in float32) takes ~0.006 ms at 3.35 TB/s.  So N
// visits only the pairs that a spatial hash on the device puts near each
// other, and its time is set by how many candidates each item's warp
// visits, not by bytes.  The grid cell is ddiv, ddiv_scale times the
// model's largest element edge: on a deck whose largest element is much
// larger than the contact surfaces' (the impact's slab is 0.2 mm thick,
// its cube's elements 0.0125 mm) the 27 cells around an item hold
// thousands of the other side's items, of which the radius cull passes a
// few.  So each call bins by a second, finer cell when the radius cull
// allows it (the fine hash), and by ddiv's cell when not.
//
// The fine cell h is 17/16 of R, the largest circumradius (rmax) of the
// call's in-range triangles, found on the device.  A pair passes the
// radius cull only if the node lies within rmax <= R of the triangle's
// centroid, so its centroid's fine cell and the node's lie within one
// fine cell of each other on each axis: the 27 fine cells around an item
// hold every candidate that the cull can pass, and skipping the rest is
// exact.  (The rounding: a pass of fl(sqrt(fl(|p - c|^2))) < rmax bounds
// each axis's |p - c| by rmax (1 + 4u); the fine coordinate
// fl(fl(x - lo) * fl(1 / h)) is (x - lo) / h within 3.1u of its size, and
// E, the largest |x - lo| of the call's items, is held to E / h <= 2^15;
// so two coordinates of a passing pair differ by less than 16/17 (1 + 5u)
// + 2^16 * 3.1u < 0.96 < 1, and their floors by at most one.)  The fine
// hash keys triangles by their centroid and nodes by their position;
// every candidate it yields still goes through every test of the ddiv
// sweep: the +-1 ddiv-cell test (each item record keeps its ddiv cell),
// the block-pair mask, the own-element exclusion, the radius cull, the
// solve and its accept window.  (The tests are pure predicates, so their
// conjunction is one whatever order evaluates it: the probe takes the
// radius cull, which reads only the cull values already in registers,
// before it reads the mask's byte and the own element's ids.)  A call
// keeps the 27 ddiv cells when the fine cell would not be at least 2x
// finer than ddiv (2 h > ddiv: uniform meshes, where ddiv is 1.1 element
// edges and a triangle's reach ~0.75 of one, self pairs at
// ddiv_scale_self 0.6, and a call whose in-range triangles include a
// large one, as the impact's slab side faces once its elements erode), or
// when E / h > 2^15 (the rounding argument would not hold), or R or E is
// not finite; the device decides, with no read to the host.  The fine and
// the ddiv hash share one workspace: one of them is built a call.
//
// Per pair and call, five launches on one stream and no read back to the
// host:
//   1. narrow_bin, a thread per force column: zeros for a slot out of range
//      (most of a fracture deck's face inventory); for an in-range item its
//      ddiv cell (cell_of), a triangle's geometry (centroid, circumradius,
//      normal, penalty stiffness, the solve's adjugate rows) into the
//      workspace once, a node's position, mass and velocity beside it, its
//      place in the work list of in-range items, and R and E raised to its
//      circumradius and its distance from the grid origin (integer
//      atomicMax on the float's bits, after a plain read that skips most);
//      an item of a block that a rank does not sum (list_nodes, list_tris)
//      has its column written zero here and is hashed but not probed;
//   2. narrow_hash, a thread per in-range item: the call's rule (fine or
//      ddiv cells, from R and E, as every later kernel reads it from the
//      header that block 0 writes), the item's cell in it, and its slot in
//      its bucket (atomicAdd on the bucket's count) of its side's hash
//      (triangles by q0's ddiv cell or their centroid's fine cell, nodes
//      by their position's; B buckets each, B a power of two set by the
//      shapes);
//   3. narrow_scan, at most a block an SM, 1,024 buckets a step: the
//      call's buckets' starts (an exclusive sum of the counts, each step's
//      offset the sum of the earlier steps' counts, which narrow_hash also
//      keeps); R and E zeroed for the next call.  A call takes the least
//      power of two of buckets a side, 64 to B, not below its in-range
//      items, so the scan reads few buckets where few items are in range;
//   4. narrow_sort, a thread per in-range item: the item, its ddiv cell
//      and what the radius cull reads of it (centroid and circumradius, or
//      position and mass) at its bucket's start plus its slot: a counting
//      sort, so a bucket's items lie side by side;
//   5. narrow_probe, a persistent grid of warps over the work list: a
//      node's lanes read the bucket ranges of the triangle hash's 27 cells
//      around its own at once and stride over them laid end to end, a
//      triangle's over the node hash's (hundreds of items a cell on the
//      ddiv hash, a few on the fine hash), and take only the items whose
//      cell is the probed cell, so hash collisions drop out and a bucket
//      that two probed cells share is not visited twice; an item whose
//      other side's hash is empty writes zeros.  A candidate must lie in a
//      block pair (k / TB, n / nb) of the side's mask (pair_ok, or a
//      rank's share under deal_block_pairs): on one device a pair within
//      one cell always does, the block boxes being padded by 2 ddiv, but
//      the test keeps the result free of that argument and dealt ranks
//      exact.
//
// Determinism: no float atomics (the counts are integers, R and E maxima,
// and a bucket's order changes no sum).  An item sums its accepted pairs
// in increasing order of the other side's index, whichever hash listed
// them: each lane keeps the kList smallest it accepted and has not summed,
// with their pair forces, sorted in registers; the warp merges the
// lanes' lists by repeated warp minima and sums them, as far as the
// smallest kList-th entry of a lane that held more, and sweeps the 27
// cells again from there while any lane held more, so no pair is dropped
// however many there are.  Within a block of the other side (TB triangles
// or nb nodes) the sum runs sequentially into blk, and blk adds to the
// item's sum block by block in increasing order (the triangle side adds
// blk / 3): the association of hakai_tpu's loop, which adds a whole
// block's sum per block pair.  Both sides call the same device functions
// on the same workspace, so they agree on every accept decision and every
// per-pair force; both hashes accept the same pairs, so a call's forces
// and counts are bitwise the same on either.  The source is compiled
// without FMA contraction (-fmad=false, set in _build.py) and writes
// every operation in the association order of the plain PyTorch version
// (ops/contact.py), so kernel and plain version take bitwise equal accept
// decisions on equal inputs.  Every force column of the pair is written
// each call, zeros included; on request each item also writes its count of
// accepted pairs, of the candidates its warp visited (those of its probed
// cells) and of those that passed the radius cull, and the call's rule
// stays in the workspace's header.
//
// S is bound by device-memory bytes: its table (4 bytes an entry), the
// force buffer and the output, 41 MB at the contact deck's kernel state
// in float32 -> float64 (0.0123 ms at 3.35 TB/s).  A thread a node walking
// its row waits ~74 memory round trips one after the other, and a warp's
// 37 index loads touch 32 lines each.  So S reads its table in blocks of
// nodes sorted by column: the index loads coalesce, a warp's gathers fall
// on few lines, and every load of a thread's entries is in flight at
// once; the row sums then read shared memory.  A thread a node with its
// row's loads in waves, a slot-major copy of the table, nodes dealt by row
// length and 4 to 16 lanes a node each did no better on an H100
// (PERF.md, Findings).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // threads per CTA of the narrow-phase kernels
constexpr int kScan = 1024;     // threads (and buckets) of a narrow_scan block
constexpr int kList = 2;        // accepted pairs a lane sorts a sweep
constexpr int kBatch = 2;       // strides of a sweep whose reads overlap
constexpr int kGeo = 28;        // workspace values per triangle
constexpr int kNode = 8;        // workspace values per node
constexpr int kHeader = 16;     // int32 words of the work list's header
constexpr unsigned kWarp = 0xffffffffu;

// the header (int32 words): [0] the work list's counter, [1] its final
// count, [2] the call's rule (1: the fine hash), [3] the call's buckets a
// side less one (its mask), [4, 6) R and [6, 8) E as the bits of the
// element type (raised by narrow_bin, zeroed by narrow_scan), [8, 10)
// 1 / h (rule, mask and 1 / h written by narrow_hash)
constexpr int kRule = 2, kMask = 3, kReach = 4, kExtent = 6, kInv = 8;

// one triangle, as the tests read it; its workspace row holds, in fours,
// ctr|rmax, q0|kpen, vj|-, nrm|-, im[0]|-, im[1]|-, im[2]|-
template <typename T>
struct Geo {
  T ctr[3], rmax, q0[3], kpen, vj[3], nrm[3], im[3][3];
};

// one candidate node; its workspace row holds p|m, v|-
template <typename T>
struct Node {
  T p[3], m, v[3];
  int id;
};

template <typename T>
struct Args {
  const T* kin;            // (6, R): position rows 0..2, velocity 3..5
  int64_t R, t0, t1, t2, cs;   // column offsets of q0/q1/q2 and the nodes
  int F2, Ci, TB, nb, tri_chunks, n_chunks;
  const uint8_t* tri_in;   // (F2,)
  const uint8_t* node_in;  // (Ci,)
  // (tri_chunks, n_chunks) block pairs summed by the node side and by the
  // triangle side
  const uint8_t *ok_nodes, *ok_tris;
  // (n_chunks,) node blocks and (tri_chunks,) triangle blocks with a set
  // block pair in that side's mask, or null (all): an item of another
  // block is hashed but not probed, so its column is written zero
  const uint8_t *list_nodes, *list_tris;
  const uint8_t* overlap;  // ()
  const T* lo;             // (3,) grid origin (all_min)
  const T* mass;           // (Ci,)
  const int32_t* ids;      // (Ci,) candidate node ids
  const int32_t* enodes;   // (8, F2) or null
  T young, kc, Cr, myu, d_lim, ddiv;
  T* force;                // row stride ld; node slot n at column off_i + n,
  int64_t ld, off_i, off_t;    // triangle k at off_t + k
  int32_t* count;          // (3, Cp + Tp) per item: accepted pairs,
                           // candidates visited, past the radius cull; or
                           // null
  // the workspace: buckets [0, B) hash the triangles, [B, 2B) the nodes;
  // fill, tile_fill, the header's counter and R and E are zero between
  // calls
  int32_t* fill;           // (2B,) items a bucket
  int32_t* start;          // (2B + 1,) a bucket's first sorted item
  int32_t* tile_fill;      // (tiles,) items in each kScan buckets
  int32_t* head;           // (kHeader,) the header
  int32_t* work;           // (F2 + Ci,) the in-range items' columns
  int tiles;               // 2B / kScan, 1 at least
  int4* link;              // (F2 + Ci,) slot in the bucket, the ddiv cell
  int4* sorted;            // (F2 + Ci,) item, ddiv cell, by bucket
  T* cull;                 // (F2 + Ci, 4) ctr|rmax or p|m, by bucket
  T* tgeo;                 // (F2, kGeo)
  T* ngeo;                 // (Ci, kNode)
  uint32_t mask;           // B - 1: a call takes the least power of two of
                           // buckets a side, 64 to B, not below its items
};

template <typename T>
__device__ __forceinline__ T mx(T a, T b) { return a > b ? a : b; }

template <typename T>
__device__ __forceinline__ T sq3(T x, T y, T z) { return (x * x + y * y) + z * z; }

template <typename T>
__device__ __forceinline__ int cell_of(T x, T lo, T ddiv) {
  return (int)ceil((x - lo) / ddiv);
}

// the fine cell of a coordinate: floor((x - lo) * (1 / h)), two roundings
template <typename T>
__device__ __forceinline__ int fine_of(T x, T lo, T inv) {
  return (int)floor((x - lo) * inv);
}

__device__ __forceinline__ uint32_t bucket(int x, int y, int z,
                                           uint32_t mask) {
  return (((uint32_t)x * 73856093u) ^ ((uint32_t)y * 19349663u)
          ^ ((uint32_t)z * 83492791u)) & mask;
}

// an element-type value as unsigned bits in the header: for a value >= 0
// (or NaN with its sign cleared) the bits order as the values do
__device__ __forceinline__ unsigned int to_bits(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ unsigned long long to_bits(double x) {
  return (unsigned long long)__double_as_longlong(x);
}
__device__ __forceinline__ float from_bits(unsigned int u) {
  return __uint_as_float(u);
}
__device__ __forceinline__ double from_bits(unsigned long long u) {
  return __longlong_as_double((long long)u);
}

template <typename T>
struct BitsOf;
template <>
struct BitsOf<float> { using type = unsigned int; };
template <>
struct BitsOf<double> { using type = unsigned long long; };
template <typename T>
using Bits = typename BitsOf<T>::type;

template <typename T>
__device__ __forceinline__ T load_word(const int32_t* w) {
  return from_bits(*reinterpret_cast<const Bits<T>*>(w));
}

// the header's maximum at w raised to |v|; the plain read skips the
// atomic once the maximum is above v
template <typename T>
__device__ __forceinline__ void raise_max(int32_t* w, T v) {
  Bits<T>* p = reinterpret_cast<Bits<T>*>(w);
  const Bits<T> b = to_bits(fabs(v));
  if (b > *reinterpret_cast<volatile Bits<T>*>(p)) atomicMax(p, b);
}

// the call's rule from R and E (every thread of narrow_hash takes it
// alike): the fine hash when its cell h = 17/16 R is at most half of ddiv
// and E / h <= 2^15, with 1 / h; R = 0, or R or E not finite, keeps ddiv's
template <typename T>
__device__ __forceinline__ bool fine_rule(const Args<T>& a, T* inv) {
  const T h = load_word<T>(a.head + kReach) * T(1.0625);
  *inv = T(1) / h;
  return h * T(2) <= a.ddiv
         && load_word<T>(a.head + kExtent) * *inv <= T(32768);
}

// place of this thread in a list: one atomicAdd per converged group of
// the warp's lanes
__device__ __forceinline__ int append(int32_t* counter) {
  const unsigned act = __activemask();
  const int lane = threadIdx.x & 31, leader = __ffs(act) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(act));
  base = __shfl_sync(act, base, leader);
  return base + __popc(act & ((1u << lane) - 1u));
}

// four workspace values (a row's fours are 16-byte aligned for float,
// 32-byte for double)
__device__ __forceinline__ void ld4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void ld4(const double* p, double v[4]) {
  const double2 x = reinterpret_cast<const double2*>(p)[0];
  const double2 y = reinterpret_cast<const double2*>(p)[1];
  v[0] = x.x; v[1] = x.y; v[2] = y.x; v[3] = y.y;
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st4(double* p, double a, double b, double c,
                                    double d) {
  reinterpret_cast<double2*>(p)[0] = make_double2(a, b);
  reinterpret_cast<double2*>(p)[1] = make_double2(c, d);
}

// per-triangle geometry (contact.py:266-303) into triangle k's row; its
// centroid and circumradius into c and rmax
template <typename T>
__device__ void tri_geometry(const Args<T>& a, int64_t k, T c[3], T& rmax) {
  T q0[3], q1[3], q2[3], v1[3], v2[3], vj[3], nrm[3], im[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    q0[i] = a.kin[i * a.R + a.t0 + k];
    q1[i] = a.kin[i * a.R + a.t1 + k];
    q2[i] = a.kin[i * a.R + a.t2 + k];
    vj[i] = a.kin[(3 + i) * a.R + a.t0 + k];
    c[i] = ((q0[i] + q1[i]) + q2[i]) / T(3);
    v1[i] = q1[i] - q0[i];
    v2[i] = q2[i] - q0[i];
  }
  const T r0 = sq3(q0[0] - c[0], q0[1] - c[1], q0[2] - c[2]);
  const T r1 = sq3(q1[0] - c[0], q1[1] - c[1], q1[2] - c[2]);
  const T r2 = sq3(q2[0] - c[0], q2[1] - c[1], q2[2] - c[2]);
  rmax = sqrt(mx(mx(r0, r1), r2));
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
  for (int i = 0; i < 3; ++i) nrm[i] = cr[i] / den;
  const T d12 = (v1[0] * v2[0] + v1[1] * v2[1]) + v1[2] * v2[2];
  const T S = T(0.5) * sqrt(mx((L1 * L1) * (L2 * L2) - d12 * d12, T(0)));
  const T kpen = ((a.young * S) / safe_L) * a.kc;
  // adjugate rows of A = [v1 v2 -n] over det(A) (my3SolveAb,
  // HAKAI_j.jl:3342-3372); A[k][i] is column k's component i
  const T A[3][3] = {{v1[0], v1[1], v1[2]},
                     {v2[0], v2[1], v2[2]},
                     {-nrm[0], -nrm[1], -nrm[2]}};
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
    im[r][0] = (A[c1][1] * A[c2][2] - A[c2][1] * A[c1][2]) / sd;
    im[r][1] = (A[c2][0] * A[c1][2] - A[c1][0] * A[c2][2]) / sd;
    im[r][2] = (A[c1][0] * A[c2][1] - A[c2][0] * A[c1][1]) / sd;
  }
  T* g = a.tgeo + k * kGeo;
  st4(g, c[0], c[1], c[2], rmax);
  st4(g + 4, q0[0], q0[1], q0[2], kpen);
  st4(g + 8, vj[0], vj[1], vj[2], T(0));
  st4(g + 12, nrm[0], nrm[1], nrm[2], T(0));
#pragma unroll
  for (int r = 0; r < 3; ++r)
    st4(g + 16 + 4 * r, im[r][0], im[r][1], im[r][2], T(0));
}

// what the radius cull reads of a triangle (its row, or its sorted cull
// values), then the rest of its row
template <typename T>
__device__ __forceinline__ void load_cull(const T* p, Geo<T>& g) {
  T v[4];
  ld4(p, v);
  g.ctr[0] = v[0]; g.ctr[1] = v[1]; g.ctr[2] = v[2]; g.rmax = v[3];
}

template <typename T>
__device__ __forceinline__ void load_rest(const Args<T>& a, int64_t k,
                                          Geo<T>& g) {
  const T* row = a.tgeo + k * kGeo;
  T v[4];
  ld4(row + 4, v);
  g.q0[0] = v[0]; g.q0[1] = v[1]; g.q0[2] = v[2]; g.kpen = v[3];
  ld4(row + 8, v);
  g.vj[0] = v[0]; g.vj[1] = v[1]; g.vj[2] = v[2];
  ld4(row + 12, v);
  g.nrm[0] = v[0]; g.nrm[1] = v[1]; g.nrm[2] = v[2];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    ld4(row + 16 + 4 * r, v);
    g.im[r][0] = v[0]; g.im[r][1] = v[1]; g.im[r][2] = v[2];
  }
}

// a node's position and mass (its row, or its sorted cull values), then
// its velocity and id
template <typename T>
__device__ __forceinline__ void load_pos(const T* p, Node<T>& nd) {
  T v[4];
  ld4(p, v);
  nd.p[0] = v[0]; nd.p[1] = v[1]; nd.p[2] = v[2]; nd.m = v[3];
}

template <typename T>
__device__ __forceinline__ void load_vel(const Args<T>& a, int64_t n,
                                         Node<T>& nd) {
  T v[4];
  ld4(a.ngeo + n * kNode + 4, v);
  nd.v[0] = v[0]; nd.v[1] = v[1]; nd.v[2] = v[2];
  nd.id = a.ids[n];
}

template <bool SELF>
__device__ __forceinline__ bool own_element(const int32_t* enodes, int F2,
                                            int64_t k, int id) {
  if (SELF) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (enodes[i * (int64_t)F2 + k] == id) return true;
  }
  return false;
}

template <typename T>
__device__ __forceinline__ bool within_radius(const Geo<T>& g,
                                              const Node<T>& n) {
  const T dpc = sqrt(sq3(n.p[0] - g.ctr[0], n.p[1] - g.ctr[1],
                         n.p[2] - g.ctr[2]));
  return dpc < g.rmax;
}

// the +-1 ddiv-cell test of a candidate's record against the probing
// item's ddiv cell
__device__ __forceinline__ bool near_cell(const int4& r, const int c[3]) {
  return abs(r.y - c[0]) <= 1 && abs(r.z - c[1]) <= 1
         && abs(r.w - c[2]) <= 1;
}

// the solve, its accept window and the force of a (triangle, node) pair
// that passed the cell, own-element and radius tests (contact.py:312-340)
template <typename T>
__device__ __forceinline__ bool pair_force(const Args<T>& a, const Geo<T>& g,
                                           const Node<T>& n, T f[3]) {
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

// The cell of a probing item and the call's hash: its ddiv cell, and on
// the fine hash its fine cell and 1 / h
template <typename T>
struct Probe {
  int c[3];                // ddiv cell
  int f[3];                // fine cell (fine hash only)
  bool fine;
  uint32_t mask;           // the call's buckets a side less one
  T inv, lo[3];
};

// f(record, cull values), spread over the warp's lanes, once for every
// item of side `side`'s hash whose cell lies within one cell of the
// probing item's in each direction.  Lane l < 27 reads the bucket range of
// cell l around the item (its ddiv cell, or on the fine hash its fine
// cell); the warp then strides over the 27 ranges laid end to end, each
// lane finding its range by a binary search over the ranges' offsets and
// reading kBatch strides' records and cull values at once, so a sweep
// costs two dependent reads and as many more as the ranges hold items
// over 32 kBatch, whether the cells hold thousands of items or a few.
// Each bucket is filtered by the exact cell: the record's ddiv cell, or
// the fine cell of its cull values.  Every lane runs every stride (f only
// where its place lies in the ranges)
template <typename T, typename F>
__device__ __forceinline__ void for_near(const Args<T>& a, int side,
                                         const Probe<T>& pr, int lane, F f) {
  const int key[3] = {pr.fine ? pr.f[0] : pr.c[0],
                       pr.fine ? pr.f[1] : pr.c[1],
                       pr.fine ? pr.f[2] : pr.c[2]};
  const int32_t* start = a.start + side * (pr.mask + 1);
  int first = 0, size = 0;
  if (lane < 27) {
    const uint32_t b = bucket(key[0] + lane % 3 - 1, key[1] + lane / 3 % 3 - 1,
                              key[2] + lane / 9 - 1, pr.mask);
    first = start[b];
    size = start[b + 1] - first;
  }
  int end = size;                              // the ranges' inclusive sums
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int z = __shfl_up_sync(kWarp, end, d);
    if (lane >= d) end += z;
  }
  const int total = __shfl_sync(kWarp, end, 31), off = end - size;
  for (int base = 0; base < total; base += 32 * kBatch) {
    int c[kBatch], j[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = base + 32 * u + lane;
      c[u] = 0;                                // the last range from <= q
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        const int o = __shfl_sync(kWarp, off, (c[u] + step) & 31);
        if (c[u] + step < 27 && o <= q) c[u] += step;
      }
      const int from = __shfl_sync(kWarp, first, c[u]),
                at = __shfl_sync(kWarp, off, c[u]);
      j[u] = q < total ? from + q - at : -1;
    }
    // the batch's records and cull values, read together
    int4 r[kBatch];
    T v[kBatch][4];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (j[u] >= 0) {
        r[u] = a.sorted[j[u]];
        ld4(a.cull + 4 * (int64_t)j[u], v[u]);
      }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (j[u] < 0) continue;
      const int x = key[0] + c[u] % 3 - 1, y = key[1] + c[u] / 3 % 3 - 1,
                z = key[2] + c[u] / 9 - 1;
      if (pr.fine ? fine_of(v[u][0], pr.lo[0], pr.inv) == x
                        && fine_of(v[u][1], pr.lo[1], pr.inv) == y
                        && fine_of(v[u][2], pr.lo[2], pr.inv) == z
                  : r[u].y == x && r[u].z == y && r[u].w == z)
        f(r[u], v[u]);
    }
  }
}

// the kList smallest indices added, ascending (INT_MAX: an empty slot),
// each with its pair force, and how many were added; constant indices
// keep it in registers
template <typename T>
struct Smallest {
  int v[kList];
  T f[kList][3];
  int added = 0;

  __device__ __forceinline__ Smallest() {
#pragma unroll
    for (int s = 0; s < kList; ++s) v[s] = INT_MAX;
  }
  __device__ __forceinline__ void add(int k, const T g[3]) {
    ++added;
#pragma unroll
    for (int s = kList - 1; s >= 0; --s) {
      if (v[s] <= k) continue;
      const bool shift = s > 0 && v[s - 1] > k;
#pragma unroll
      for (int r = 0; r < 3; ++r) f[s][r] = shift ? f[s - 1][r] : g[r];
      v[s] = shift ? v[s - 1] : k;
    }
  }
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int s = 0; s + 1 < kList; ++s) {
      v[s] = v[s + 1];
#pragma unroll
      for (int r = 0; r < 3; ++r) f[s][r] = f[s + 1][r];
    }
    v[kList - 1] = INT_MAX;
  }
  // the largest index below which this lane's list is complete
  __device__ __forceinline__ int complete_to() const {
    return added > kList ? v[kList - 1] : INT_MAX;
  }
};

// the accepted pairs of one item, whose lanes each hold a Smallest of a
// sweep, in increasing index order up to the lanes' common complete_to:
// sum(k, f) on every lane for each, f the pair force from the lane that
// holds k (the warp's lanes agree on every value).  Returns how far the
// sweep's pairs are summed (INT_MAX: all of them).
template <typename T, typename Sum>
__device__ __forceinline__ int merge(Smallest<T>& s, Sum sum) {
  const int lim = __reduce_min_sync(kWarp, s.complete_to());
  for (;;) {
    const int k = __reduce_min_sync(kWarp, s.v[0]);
    if (k == INT_MAX || k > lim) break;
    const int owner = __ffs(__ballot_sync(kWarp, s.v[0] == k)) - 1;
    T f[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) f[r] = __shfl_sync(kWarp, s.f[0][r], owner);
    if (s.v[0] == k) s.pop();
    sum(k, f);
  }
  return lim;
}

// a probing item's count of accepted pairs, and on its lane, of the
// candidates it visited in the first sweep and of those past the radius
// cull
struct Tally {
  int hits = 0, visits = 0, near = 0;
};

// force_i of in-range node n (its accepted triangles in increasing order,
// summed per triangle block into blk, the blocks added in order) into acc,
// on every lane of the node's warp
template <typename T, bool SELF>
__device__ void node_sums(const Args<T>& a, int64_t n, Probe<T> pr,
                          int lane, T acc[3], Tally& t) {
  Node<T> nd;
  load_pos(a.ngeo + n * kNode, nd);
  load_vel(a, n, nd);
  const int4 own = a.link[a.F2 + n];
  pr.c[0] = own.y; pr.c[1] = own.z; pr.c[2] = own.w;
  if (pr.fine) {
#pragma unroll
    for (int r = 0; r < 3; ++r) pr.f[r] = fine_of(nd.p[r], pr.lo[r], pr.inv);
  }
  const uint8_t* ok = a.ok_nodes + n / a.nb;   // column of (t, n / nb)
  T blk[3] = {T(0), T(0), T(0)};
  int last = -1, cur = -1;
  for (;;) {
    Smallest<T> s;
    const bool first = last < 0;
    for_near(a, 0, pr, lane, [&](const int4& r, const T v[4]) {
      const int k = r.x;
      t.visits += first;
      if (k <= last || (pr.fine && !near_cell(r, pr.c))) return;
      // the tests in order: the mask, the own element, the radius cull;
      // the cull reads nothing more, so the mask's byte and the rest of
      // the triangle's row are read, together, only where it passes
      Geo<T> g;
      g.ctr[0] = v[0]; g.ctr[1] = v[1]; g.ctr[2] = v[2]; g.rmax = v[3];
      const bool near = within_radius(g, nd);
      if (!near) return;
      const bool in_blocks = ok[(int64_t)(k / a.TB) * a.n_chunks];
      load_rest(a, k, g);
      if (!in_blocks || own_element<SELF>(a.enodes, a.F2, k, nd.id))
        return;
      t.near += first;
      T f[3];
      if (pair_force(a, g, nd, f)) s.add(k, f);
    });
    last = merge(s, [&](int k, const T f[3]) {
      if (k / a.TB != cur) {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          acc[r] += blk[r];
          blk[r] = T(0);
        }
        cur = k / a.TB;
      }
#pragma unroll
      for (int r = 0; r < 3; ++r) blk[r] += f[r];
      ++t.hits;
    });
    if (last == INT_MAX) break;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) acc[r] += blk[r];
}

// force_t of in-range triangle k (its accepted nodes in increasing order,
// summed per node block into blk, blk / 3 added block by block) into acc,
// on every lane of the triangle's warp
template <typename T, bool SELF>
__device__ void tri_sums(const Args<T>& a, int64_t k, Probe<T> pr, int lane,
                         T acc[3], Tally& t) {
  Geo<T> g;
  load_cull(a.tgeo + k * kGeo, g);
  load_rest(a, k, g);
  int en[8];
  if (SELF) {
#pragma unroll
    for (int i = 0; i < 8; ++i) en[i] = a.enodes[i * (int64_t)a.F2 + k];
  }
  const int4 own = a.link[k];
  pr.c[0] = own.y; pr.c[1] = own.z; pr.c[2] = own.w;
  if (pr.fine) {
#pragma unroll
    for (int r = 0; r < 3; ++r) pr.f[r] = fine_of(g.ctr[r], pr.lo[r], pr.inv);
  }
  const uint8_t* ok = a.ok_tris + (int64_t)(k / a.TB) * a.n_chunks;
  T blk[3] = {T(0), T(0), T(0)};
  int last = -1, cur = -1;
  for (;;) {
    Smallest<T> s;
    const bool first = last < 0;
    for_near(a, 1, pr, lane, [&](const int4& r, const T v[4]) {
      const int n = r.x;
      t.visits += first;
      if (n <= last || (pr.fine && !near_cell(r, pr.c))) return;
      // the tests in order: the mask, the own element, the radius cull;
      // the cull reads nothing more, so the mask's byte and the node's id
      // and velocity are read, together, only where it passes
      Node<T> nd;
      nd.p[0] = v[0]; nd.p[1] = v[1]; nd.p[2] = v[2]; nd.m = v[3];
      if (!within_radius(g, nd)) return;
      const bool in_blocks = ok[n / a.nb];
      load_vel(a, n, nd);
      if (!in_blocks) return;
      if (SELF) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (en[i] == nd.id) return;
      }
      t.near += first;
      T f[3];
      if (pair_force(a, g, nd, f)) s.add(n, f);
    });
    last = merge(s, [&](int n, const T f[3]) {
      if (n / a.nb != cur) {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          acc[r] += blk[r] / T(3);
          blk[r] = T(0);
        }
        cur = n / a.nb;
      }
#pragma unroll
      for (int r = 0; r < 3; ++r) blk[r] += f[r];
      ++t.hits;
    });
    if (last == INT_MAX) break;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) acc[r] += blk[r] / T(3);
}

// column i's zeros: its force and, on request, its counts
template <typename T>
__device__ __forceinline__ void zero_column(const Args<T>& a, int64_t i,
                                            int64_t col, int64_t cols) {
#pragma unroll
  for (int r = 0; r < 3; ++r) a.force[r * a.ld + col] = T(0);
  if (a.count != nullptr) {
#pragma unroll
    for (int r = 0; r < 3; ++r) a.count[r * cols + i] = 0;
  }
}

// a thread per force column (node slots, then triangle slots): zeros for
// one out of range; an in-range item's ddiv cell, workspace row and place
// in the work list, R and E raised; zeros for an item of a block that is
// not listed
template <typename T>
__global__ void __launch_bounds__(kThreads) narrow_bin(Args<T> a) {
  const int64_t Cp = (int64_t)a.n_chunks * a.nb;
  const int64_t cols = Cp + (int64_t)a.tri_chunks * a.TB;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cols) return;
  const bool tri = i >= Cp;
  const int64_t j = tri ? i - Cp : i;          // the index on its side
  const bool item = j < (tri ? a.F2 : a.Ci);
  const int64_t out = tri ? a.off_t + j : a.off_i + j;
  if (!item || !*a.overlap || !(tri ? a.tri_in[j] : a.node_in[j])) {
    zero_column(a, i, out, cols);
    return;
  }
  const int64_t col = tri ? a.t0 + j : a.cs + j;   // q0, or the node
  int c[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    c[r] = cell_of(a.kin[r * a.R + col], a.lo[r], a.ddiv);
  T x[3];                                      // centroid, or position
  if (tri) {
    T rmax;
    tri_geometry(a, j, x, rmax);
    raise_max(a.head + kReach, rmax);
  } else {
#pragma unroll
    for (int r = 0; r < 3; ++r) x[r] = a.kin[r * a.R + col];
    T* w = a.ngeo + j * kNode;
    st4(w, x[0], x[1], x[2], a.mass[j]);
    st4(w + 4, a.kin[3 * a.R + col], a.kin[4 * a.R + col],
        a.kin[5 * a.R + col], T(0));
  }
  raise_max(a.head + kExtent,
            mx(mx(fabs(x[0] - a.lo[0]), fabs(x[1] - a.lo[1])),
               fabs(x[2] - a.lo[2])));
  a.link[tri ? j : a.F2 + j] = make_int4(0, c[0], c[1], c[2]);
  a.work[append(a.head)] = (int)i;
  const uint8_t* listed = tri ? a.list_tris : a.list_nodes;
  if (listed != nullptr && !listed[tri ? j / a.TB : j / a.nb])
    zero_column(a, i, out, cols);
}

// an in-range item's cell in the call's hash: its ddiv cell, or the fine
// cell of its row's first three values (centroid, or position)
template <typename T>
__device__ __forceinline__ uint32_t item_bucket(const Args<T>& a, bool tri,
                                                int64_t j, const int4& l,
                                                bool fine, T inv,
                                                uint32_t mask) {
  int c[3] = {l.y, l.z, l.w};
  if (fine) {
    T v[4];
    ld4(tri ? a.tgeo + j * kGeo : a.ngeo + j * kNode, v);
#pragma unroll
    for (int r = 0; r < 3; ++r) c[r] = fine_of(v[r], a.lo[r], inv);
  }
  return (tri ? 0 : mask + 1) + bucket(c[0], c[1], c[2], mask);
}

// one atomicAdd per group of converged lanes of the warp with the same
// key, each adding one to *p
__device__ __forceinline__ void grouped_inc(int32_t* p, unsigned key) {
  const unsigned same = __match_any_sync(__activemask(), key);
  if ((int)(threadIdx.x & 31) == __ffs(same) - 1)
    atomicAdd(p, __popc(same));
}

// this lane's place among the lanes of the warp that add to *p: one
// atomicAdd per group of converged lanes with the same p
__device__ __forceinline__ int grouped_add(int32_t* p, unsigned key) {
  const unsigned act = __activemask();
  const unsigned same = __match_any_sync(act, key);
  const int lane = threadIdx.x & 31, leader = __ffs(same) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(p, __popc(same));
  base = __shfl_sync(same, base, leader);
  return base + __popc(same & ((1u << lane) - 1u));
}

// a thread per in-range item: the call's rule and buckets (block 0 writes
// them to the header), the item's bucket and its slot there
template <typename T>
__global__ void __launch_bounds__(kThreads) narrow_hash(Args<T> a) {
  T inv;
  const bool fine = fine_rule(a, &inv);
  const int n = a.head[0];
  uint32_t mask = 63;
  while (mask < a.mask && (int64_t)mask + 1 < n) mask = 2 * mask + 1;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.head[kRule] = fine;
    a.head[kMask] = (int)mask;
    *reinterpret_cast<Bits<T>*>(a.head + kInv) = to_bits(inv);
  }
  const int64_t Cp = (int64_t)a.n_chunks * a.nb;
  for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < n;
       w += gridDim.x * blockDim.x) {
    const int64_t i = a.work[w];
    const bool tri = i >= Cp;
    const int64_t j = tri ? i - Cp : i, li = tri ? j : a.F2 + j;
    const uint32_t b = item_bucket(a, tri, j, a.link[li], fine, inv, mask);
    grouped_inc(a.tile_fill + b / kScan, b / kScan);
    a.link[li].x = grouped_add(a.fill + b, b);
  }
}

// kScan buckets a step of a block, over the call's buckets (n = 2
// (head[kMask] + 1)): start = the exclusive sum of fill, and the total at
// start[n]; fill left zero; the work list's count moved to head[1], its
// counter, R and E zeroed
__global__ void __launch_bounds__(kScan)
narrow_scan(int32_t* __restrict__ fill, int32_t* __restrict__ start,
            const int32_t* __restrict__ tile_fill, int32_t* head) {
  __shared__ int part[kScan / 32];
  __shared__ int offset;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = 2 * (head[kMask] + 1);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    head[1] = head[0];
    head[0] = 0;
#pragma unroll
    for (int w = kReach; w < kInv; ++w) head[w] = 0;
  }
  for (int tile = blockIdx.x; tile * kScan < n; tile += gridDim.x) {
    __syncthreads();                           // part and offset are free
    int o = 0;                                 // the earlier tiles' items
    for (int q = threadIdx.x; q < tile; q += kScan) o += tile_fill[q];
    o = __reduce_add_sync(kWarp, o);
    if (lane == 0) part[warp] = o;
    __syncthreads();
    if (warp == 0) {
      const int w = __reduce_add_sync(kWarp, lane < kScan / 32 ? part[lane]
                                                               : 0);
      if (lane == 0) offset = w;
    }
    __syncthreads();
    const int b = tile * kScan + threadIdx.x;
    const int x = b < n ? fill[b] : 0;
    int y = x;                                 // inclusive, in the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int z = __shfl_up_sync(kWarp, y, d);
      if (lane >= d) y += z;
    }
    if (lane == 31) part[warp] = y;
    __syncthreads();
    if (warp == 0) {
      int w = lane < kScan / 32 ? part[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int z = __shfl_up_sync(kWarp, w, d);
        if (lane >= d) w += z;
      }
      if (lane < kScan / 32) part[lane] = w;
    }
    __syncthreads();
    const int incl = offset + y + (warp > 0 ? part[warp - 1] : 0);
    if (b < n) {
      start[b] = incl - x;
      fill[b] = 0;
    }
    if (b == n - 1) start[n] = incl;
  }
}

// a thread per in-range item: the item, its ddiv cell and its cull values
// at its bucket's start plus its slot
template <typename T>
__global__ void __launch_bounds__(kThreads) narrow_sort(Args<T> a) {
  const bool fine = a.head[kRule] != 0;
  const uint32_t mask = (uint32_t)a.head[kMask];
  const T inv = load_word<T>(a.head + kInv);
  const int64_t Cp = (int64_t)a.n_chunks * a.nb;
  const int n = a.head[1];
  for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < n;
       w += gridDim.x * blockDim.x) {
    const int64_t i = a.work[w];
    const bool tri = i >= Cp;
    const int64_t j = tri ? i - Cp : i;
    const int4 l = a.link[tri ? j : a.F2 + j];
    const int pos = a.start[item_bucket(a, tri, j, l, fine, inv, mask)]
                    + l.x;
    a.sorted[pos] = make_int4((int)j, l.y, l.z, l.w);
    T v[4];
    ld4(tri ? a.tgeo + j * kGeo : a.ngeo + j * kNode, v);
    st4(a.cull + 4 * (int64_t)pos, v[0], v[1], v[2], v[3]);
  }
}

// a persistent grid of warps over the work list: each listed item's sums
// into its force column (and on request its counts); tile_fill zeroed for
// the next call
template <typename T, bool SELF>
__global__ void __launch_bounds__(kThreads) narrow_probe(Args<T> a) {
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < a.tiles;
       q += gridDim.x * blockDim.x)
    a.tile_fill[q] = 0;
  const int64_t Cp = (int64_t)a.n_chunks * a.nb;
  const int64_t cols = Cp + (int64_t)a.tri_chunks * a.TB;
  const int lane = threadIdx.x & 31, items = a.head[1];
  Probe<T> pr;
  pr.fine = a.head[kRule] != 0;
  pr.mask = (uint32_t)a.head[kMask];
  pr.inv = load_word<T>(a.head + kInv);
#pragma unroll
  for (int r = 0; r < 3; ++r) pr.lo[r] = a.lo[r];
  // whether each hash holds an item (triangles, nodes): an item facing an
  // empty hash has no candidate
  const int tris = a.start[pr.mask + 1];
  const bool hashed[2] = {tris > 0, a.start[2 * (pr.mask + 1)] > tris};
  for (int w = blockIdx.x * (kThreads / 32) + threadIdx.x / 32; w < items;
       w += gridDim.x * (kThreads / 32)) {
    const int64_t i = a.work[w];
    const bool tri = i >= Cp;
    const int64_t j = tri ? i - Cp : i;
    const uint8_t* listed = tri ? a.list_tris : a.list_nodes;
    if (listed != nullptr && !listed[tri ? j / a.TB : j / a.nb]) continue;
    T acc[3] = {T(0), T(0), T(0)};
    Tally t;
    if (tri ? hashed[1] : hashed[0]) {
      if (tri)
        tri_sums<T, SELF>(a, j, pr, lane, acc, t);
      else
        node_sums<T, SELF>(a, j, pr, lane, acc, t);
    }
    const int visits = __reduce_add_sync(kWarp, t.visits);
    const int near = __reduce_add_sync(kWarp, t.near);
    if (lane == 0) {
      const int64_t col = tri ? a.off_t + j : a.off_i + j;
#pragma unroll
      for (int r = 0; r < 3; ++r) a.force[r * a.ld + col] = acc[r];
      if (a.count != nullptr) {
        a.count[i] = t.hits;
        a.count[cols + i] = visits;
        a.count[2 * cols + i] = near;
      }
    }
  }
}

template <typename T>
int narrow(const Args<T>& a, int B, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 64 || (B & (B - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int64_t cols = (int64_t)a.n_chunks * a.nb
                       + (int64_t)a.tri_chunks * a.TB;
  const int64_t items = (int64_t)a.F2 + a.Ci;
  if (cols <= 0) return 0;
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  narrow_bin<T><<<(unsigned)((cols + kThreads - 1) / kThreads), kThreads, 0,
                  st>>>(a);
  // a thread an item, at most 4 blocks an SM
  const int64_t per = (items + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(per < 4 * sms ? (per > 0 ? per : 1)
                                                 : 4 * sms);
  narrow_hash<T><<<grid, kThreads, 0, st>>>(a);
  narrow_scan<<<(unsigned)(a.tiles < sms ? a.tiles : sms), kScan, 0, st>>>(
      a.fill, a.start, a.tile_fill, a.head);
  if (items > 0) {
    narrow_sort<T><<<grid, kThreads, 0, st>>>(a);
    // a warp an item, at most 16 blocks an SM
    const int64_t need = (items + kThreads / 32 - 1) / (kThreads / 32);
    const unsigned warps = (unsigned)(need < 16 * sms ? need : 16 * sms);
    if (a.enodes != nullptr)
      narrow_probe<T, true><<<warps, kThreads, 0, st>>>(a);
    else
      narrow_probe<T, false><<<warps, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// Kernel S: g[c, n] = the sum of src[c, col[q]] over q in ptr[n]..mid[n],
// minus those over mid[n]..ptr[n+1], in table order, in T; stored as O.
// A block sums the nodes n0 .. n0 + nb - 1, whose entries are the range
// e0 = ptr[n0] .. ptr[n0 + nb] of the table.  First every thread takes
// entries of the range in `word`'s order (sorted by column: neighbouring
// threads gather neighbouring columns, so a warp's loads fall on few
// lines), kScatterWave at a time, all their loads in flight together, and
// writes each gathered value to its place in shared memory, (3, emax) in
// T; then one thread a (channel, node) sums the node's places in table
// order, adds before subtracts as the table has them.
constexpr int kScatterThreads = 256;
constexpr int kScatterWave = 2;       // entries a thread has in flight

template <typename T, typename O>
__global__ void __launch_bounds__(kScatterThreads)
scatter_kernel(const T* __restrict__ src, int64_t ld,
               const int32_t* __restrict__ ptr,
               const int32_t* __restrict__ mid,
               const uint32_t* __restrict__ word, int nb, int bits, int emax,
               int N, O* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char scatter_raw[];
  T* buf = reinterpret_cast<T*>(scatter_raw);
  const int n0 = blockIdx.x * nb, n1 = n0 + nb < N ? n0 + nb : N;
  const int e0 = ptr[n0], E = ptr[n1] - e0;
  const uint32_t place = (1u << bits) - 1u;
  for (int q0 = threadIdx.x; q0 < E; q0 += kScatterWave * kScatterThreads) {
    int s[kScatterWave], d[kScatterWave];
#pragma unroll
    for (int u = 0; u < kScatterWave; ++u) {
      const int q = q0 + u * kScatterThreads;
      const uint32_t w = q < E ? __ldcs(word + e0 + q) : 0u;
      s[u] = (int)(w >> bits);
      d[u] = (int)(w & place);
    }
    T x[kScatterWave][3];
#pragma unroll
    for (int u = 0; u < kScatterWave; ++u)
#pragma unroll
      for (int r = 0; r < 3; ++r)
        x[u][r] = q0 + u * kScatterThreads < E ? src[r * ld + s[u]] : T(0);
#pragma unroll
    for (int u = 0; u < kScatterWave; ++u)
      if (q0 + u * kScatterThreads < E)
#pragma unroll
        for (int r = 0; r < 3; ++r) buf[r * emax + d[u]] = x[u][r];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 3 * nb; t += kScatterThreads) {
    const int r = t / nb, n = n0 + t % nb;
    if (n >= N) continue;
    const int b = ptr[n] - e0, m = mid[n] - e0, e = ptr[n + 1] - e0;
    const T* row = buf + r * emax;
    T acc = T(0);
    for (int q = b; q < m; ++q) acc += row[q];
    for (int q = m; q < e; ++q) acc -= row[q];
    out[r * (int64_t)N + n] = O(acc);
  }
}

template <typename T, typename O>
int scatter(const T* src, int ld, const int32_t* ptr, const int32_t* mid,
            const uint32_t* word, int nb, int bits, int emax, int N, O* out,
            void* stream) {
  if (N <= 0) return 0;
  const size_t smem = sizeof(T) * 3 * (size_t)emax;
  cudaError_t err = cudaFuncSetAttribute(
      scatter_kernel<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  scatter_kernel<T, O><<<(N + nb - 1) / nb, kScatterThreads, smem,
                         (cudaStream_t)stream>>>(src, ld, ptr, mid, word, nb,
                                                 bits, emax, N, out);
  return (int)cudaGetLastError();
}

// What a launch over blocks of emax entries takes: out = {resident blocks
// an SM, registers a thread, static shared bytes a block, local bytes a
// thread (spills), dynamic shared bytes a block}.
template <typename T, typename O>
int scatter_resources(int emax, int* out) {
  const size_t smem = sizeof(T) * 3 * (size_t)emax;
  cudaError_t err = cudaFuncSetAttribute(
      scatter_kernel<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, scatter_kernel<T, O>);
  if (err != cudaSuccess) return (int)err;
  out[1] = fa.numRegs;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = (int)fa.localSizeBytes;
  out[4] = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, scatter_kernel<T, O>, kScatterThreads, smem);
}

template <typename T>
int narrow_entry(const T* kin, int R, int t0, int t1, int t2, int cs, int F2,
                 int Ci, int TB, int nb, int tri_chunks, int n_chunks,
                 const uint8_t* tri_in, const uint8_t* node_in,
                 const uint8_t* ok_nodes, const uint8_t* ok_tris,
                 const uint8_t* list_nodes, const uint8_t* list_tris,
                 const uint8_t* overlap, const T* lo, const T* mass,
                 const int32_t* ids, const int32_t* enodes, T young, T kc,
                 T Cr, T myu, T d_lim, T ddiv, T* force, int ld, int off_i,
                 int off_t, int32_t* count, int32_t* iws, T* fws, int B,
                 void* stream) {
  Args<T> a;
  a.kin = kin; a.R = R; a.t0 = t0; a.t1 = t1; a.t2 = t2; a.cs = cs;
  a.F2 = F2; a.Ci = Ci; a.TB = TB; a.nb = nb;
  a.tri_chunks = tri_chunks; a.n_chunks = n_chunks;
  a.tri_in = tri_in; a.node_in = node_in; a.ok_nodes = ok_nodes;
  a.ok_tris = ok_tris; a.list_nodes = list_nodes; a.list_tris = list_tris;
  a.overlap = overlap; a.lo = lo; a.mass = mass;
  a.ids = ids; a.enodes = enodes; a.young = young; a.kc = kc; a.Cr = Cr;
  a.myu = myu; a.d_lim = d_lim; a.ddiv = ddiv; a.force = force; a.ld = ld;
  a.off_i = off_i; a.off_t = off_t; a.count = count;
  // the workspace: iws = fill (2B) | start (2B + 4) | tile_fill (tiles,
  // in fours) | the header (kHeader) | work (F2 + Ci, in fours) | link,
  // sorted (4 (F2 + Ci) each); fws = triangle rows (kGeo F2) | node rows
  // (kNode Ci) | sorted cull values (4 (F2 + Ci))
  const int64_t items = (int64_t)F2 + Ci;
  a.tiles = (2 * B + kScan - 1) / kScan;
  a.fill = iws;
  a.start = iws + 2 * (int64_t)B;
  a.tile_fill = a.start + 2 * (int64_t)B + 4;
  a.head = a.tile_fill + (a.tiles + 3) / 4 * 4;
  a.work = a.head + kHeader;
  a.link = reinterpret_cast<int4*>(a.work + (items + 3) / 4 * 4);
  a.sorted = a.link + items;
  a.tgeo = fws;
  a.ngeo = fws + (int64_t)kGeo * F2;
  a.cull = a.ngeo + (int64_t)kNode * Ci;
  a.mask = (uint32_t)B - 1u;
  return narrow<T>(a, B, stream);
}

}  // namespace

extern "C" {

// One pair's narrow phase: force_i into columns off_i.. (Cp of them) and
// force_t into off_t.. (Tp) of force (3 rows, stride ld).  ok_nodes and
// ok_tris are the (tri_chunks, n_chunks) block pairs each side sums;
// list_nodes (n_chunks,) and list_tris (tri_chunks,) flag the blocks of
// each side with a set pair in its mask, or are null (every block: an item
// of a block without one finds no candidate, so listing it only costs
// time).  count is (3, Cp + Tp) int32 (per column: accepted pairs,
// candidates visited, of those past the radius cull) or null.  B is a
// power of two, 64 at least; iws is int32 of 4B + 4 + r4(tiles) + 16 +
// r4(F2 + Ci) + 8 (F2 + Ci), with tiles = max(1, 2B / 1024) and r4
// rounding up to a multiple of 4, zero when allocated (each call leaves
// its counters zero, and word 2 of the header, at 4B + 4 + r4(tiles), the
// call's rule: 1 where it took the fine hash); fws is (32 F2 + 12 Ci,) of
// the element type; both 32-byte aligned.
int hk_narrow_f32(const float* kin, int R, int t0, int t1, int t2, int cs,
                  int F2, int Ci, int TB, int nb, int tri_chunks,
                  int n_chunks, const uint8_t* tri_in, const uint8_t* node_in,
                  const uint8_t* ok_nodes, const uint8_t* ok_tris,
                  const uint8_t* list_nodes, const uint8_t* list_tris,
                  const uint8_t* overlap, const float* lo, const float* mass,
                  const int32_t* ids, const int32_t* enodes, float young,
                  float kc, float Cr, float myu, float d_lim, float ddiv,
                  float* force, int ld, int off_i, int off_t, int32_t* count,
                  int32_t* iws, float* fws, int B, void* stream) {
  return narrow_entry<float>(kin, R, t0, t1, t2, cs, F2, Ci, TB, nb,
                             tri_chunks, n_chunks, tri_in, node_in, ok_nodes,
                             ok_tris, list_nodes, list_tris, overlap, lo,
                             mass, ids, enodes, young, kc, Cr, myu, d_lim,
                             ddiv, force, ld, off_i, off_t, count, iws, fws,
                             B, stream);
}

int hk_narrow_f64(const double* kin, int R, int t0, int t1, int t2, int cs,
                  int F2, int Ci, int TB, int nb, int tri_chunks,
                  int n_chunks, const uint8_t* tri_in, const uint8_t* node_in,
                  const uint8_t* ok_nodes, const uint8_t* ok_tris,
                  const uint8_t* list_nodes, const uint8_t* list_tris,
                  const uint8_t* overlap, const double* lo,
                  const double* mass, const int32_t* ids,
                  const int32_t* enodes, double young, double kc, double Cr,
                  double myu, double d_lim, double ddiv, double* force,
                  int ld, int off_i, int off_t, int32_t* count, int32_t* iws,
                  double* fws, int B, void* stream) {
  return narrow_entry<double>(kin, R, t0, t1, t2, cs, F2, Ci, TB, nb,
                              tri_chunks, n_chunks, tri_in, node_in,
                              ok_nodes, ok_tris, list_nodes, list_tris,
                              overlap, lo, mass, ids, enodes, young, kc, Cr,
                              myu, d_lim, ddiv, force, ld, off_i, off_t,
                              count, iws, fws, B, stream);
}

// src (3, ld), ptr (N + 1), mid (N), word (nnz: column << bits | place,
// in blocks of nb nodes, at most emax entries a block), N, out, stream
int hk_scatter_f32(const float* src, int ld, const int32_t* ptr,
                   const int32_t* mid, const uint32_t* word, int nb,
                   int bits, int emax, int N, float* out, void* stream) {
  return scatter<float, float>(src, ld, ptr, mid, word, nb, bits, emax, N,
                               out, stream);
}

int hk_scatter_f64(const double* src, int ld, const int32_t* ptr,
                   const int32_t* mid, const uint32_t* word, int nb,
                   int bits, int emax, int N, double* out, void* stream) {
  return scatter<double, double>(src, ld, ptr, mid, word, nb, bits, emax, N,
                                 out, stream);
}

// float32 sum, stored as float64 (mixed precision)
int hk_scatter_f32_f64(const float* src, int ld, const int32_t* ptr,
                       const int32_t* mid, const uint32_t* word, int nb,
                       int bits, int emax, int N, double* out,
                       void* stream) {
  return scatter<float, double>(src, ld, ptr, mid, word, nb, bits, emax, N,
                                out, stream);
}

// The resources of instantiation `which` (0 f32, 1 f64, 2 f32 -> f64) for
// blocks of emax entries into out[5] (see scatter_resources).
int hk_scatter_resources(int which, int emax, int* out) {
  switch (which) {
    case 0: return scatter_resources<float, float>(emax, out);
    case 1: return scatter_resources<double, double>(emax, out);
    case 2: return scatter_resources<float, double>(emax, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
