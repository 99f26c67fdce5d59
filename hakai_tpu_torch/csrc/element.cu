// Fused per-element hex8 update: nodal gather, B-bar kinematics, elastic
// trial, J2 radial return, GP-mean strain, the internal-force fold and,
// optionally, the triaxiality of the final stress.
//
// Replaces the TPU kernels of hakai_tpu/ops/element_pallas.py:
//  * _make_mxu_kernel through element_core_packed_mxu, both its fused-
//    gather call (packed_element_step_fused with a GatherPhysPlan; f32) and
//    its plain call on pos24/du24 rows (the mixed-precision path of
//    packed_element_step);
//  * _make_packed_kernel through element_core_packed (element_kernel=
//    "pallas"), which computes the same function on the VPU alone;
//  * _make_kernel through element_core_pallas, the unpacked element update
//    of the generic step() (hakai_tpu/ops/element.py:element_core).
//
// Two load stages and two state layouts of one kernel template:
//  * packed (the chunk loop): packed Gauss state P (72, E) in and out
//    (stress rows c*8+k, GP-mean strain 48:54, zero pad 54:56, eq_ps 56:64,
//    yield 64:72); the kernel gathers the nodal disp and dprev and forms
//    pos = coord_e + (d - d_node0), du = d - dprev;
//  * generic (step()): stress (6, 8, E), strain (6, E), eq_ps (8, E) and
//    yield (8, E) as separate arrays, whose rows are the packed rows 0:48,
//    48:54, 56:64 and 64:72, so one struct of four row bases serves both;
//    the kernel gathers the nodal position (coord + disp) and increment in
//    the element type and centres the position on node 0 in that type,
//    after the gather: the bits of _element_math's pos_e - pos_e[:, 0:1].
// Both write qe (24, E) = (3, 8, E) with rows b*8+i, masked by the life
// flag, and with a triax pointer the (8, E) triaxiality of the final stress
// (want_triax; the formula and the vm < 1e-10 / vm == 0 guards of
// element_pallas.py:448-455).  The generic stage, given a neg pointer,
// also adds to it the number of Gauss points of live elements whose detJ
// is negative (NEG; the count hakai_tpu/ops/element.py:element_core forms
// beside its TPU kernel when a metrics stream is on): each warp ballots
// its 32 points, each block adds its warps' counts with one atomicAdd.
// Integer sums, so the count is exact in any block order; the caller
// zeroes it.  The packed instantiations take NEG = false and compile as
// they did without it.  The math is hakai_tpu/ops/element.py:
// _element_math, direct form.
//
// Two scalar types: K for the nodal disp/dprev, T for the element math and
// every element array.  The packed stage is instantiated <float, float>,
// <double, double> and <double, float> (mixed precision), the generic one
// <float, float> and <double, double>: in mixed mode the generic step hands
// the kernel float32 positions and increments, as the JAX step hands its
// element math.  In mixed mode the packed stage takes both kinematic
// differences, d - d_node0 and d - dprev, in K and casts to T once, which
// gives the bits the JAX package's gather_disp_e + element_kinematics hand
// its TPU kernel; the (3, 8, E) float64 element copy of disp that the JAX
// package carries through its chunk loop is never formed.
//
// What bounds it on an H100: device-memory bytes.  Per element a step
// reads P (72 values), coord_e (24), 8 node ids, 6 values for each of the 8
// nodes from disp/dprev, and the per-element constants, and writes P (72)
// and qe (24) (and triax (8)) -- about 1 KB in f32 against ~6 kFLOP, far
// below the card's FLOP:byte balance.  The generic stage reads no coord_e.
// The bytes arrive only as fast as enough loads are in flight: a block's
// loads that wait on one another, or on a barrier, leave the memory idle
// while the block computes.  Next to them, the instructions: a Gauss-point
// thread issues ~600 floating-point and ~150 shared-memory instructions,
// which keep the SM's issue slots about as busy as the memory, so the
// kernel runs at about half its byte bound.
//
// Design:
//  * one block = 32 elements x 8 Gauss points (blockDim (32, 8)); thread
//    (x, k) owns Gauss point k of element x.  Each warp is one Gauss point
//    of 32 consecutive elements, so every state/coord_e/qe row access is
//    one coalesced 128-byte (f32) transaction and every read of the
//    constant shape-gradient table is warp-uniform (a __constant__
//    broadcast).
//  * every load that needs no other load is issued at the top, before the
//    first barrier, and held in registers: the thread's two node ids (its
//    node slot k and node 0), its coord_e rows, the stress, eq_ps, yield
//    and strain rows of its Gauss point and the element's constants.
//    Then the only dependent loads are the nodal gather (disp, dprev and
//    node 0's disp, by node id), so a block waits for two memory round
//    trips before it computes.
//  * the hardening tables (M, W), when they fit in kTableBytes, are staged
//    once a block into shared memory at the top, so the slope lookup makes
//    no device-memory load after the kinematics; larger tables are read
//    from device memory as before.
//  * the gather is indexed loads through elem (8, E): thread (x, j) loads
//    node j's two nodal values and node 0's displacement and writes the
//    node-0-centred position and the increment to shared memory, so no
//    (3, 8, E) pos/du copy ever reaches device memory (the TPU kernels
//    needed window DMAs and a diagonal resolve, or an XLA gather, for the
//    same thing).
//  * the constant contractions (J, Gdu, the Qe fold) are register FMAs in
//    full precision; the TPU kernel's MXU matmuls and their bf16x3 split
//    do not carry over.
//  * the three sums over Gauss points (V and the volbar numerator, the
//    strain increments with sum_w_sig_m, and the Qe fold) go through
//    shared memory in the fixed order k = 0..7, so the kernel is
//    deterministic and uses no atomics.  For the Qe fold, thread (x, i)
//    sums node i's three force rows over k, so the qe stores coalesce too.
//    Four barriers a block: after the gather and after each sum's writes.
//    Two shared regions serve the four buffers of the phases in turn (the
//    gathered kinematics, then sum 2; sum 1, then the force moments), which
//    keeps a block at 16 KB in f32 and 32 KB in f64.
//  * the register budget is bounded (__launch_bounds__(256, kMinBlocks)):
//    64 registers and 4 resident blocks an SM in f32, as many blocks as the
//    first design held with its loads behind barriers; 2 in f64 (123
//    registers), the most that hold without spills.  The hoisted loads
//    alone raised f32 to 80 registers and 3 blocks, and gained nothing.
//  * the triaxiality is formed by each Gauss-point thread from the final
//    stress still in its registers: no second pass over the stress.
// Every per-thread operation and the order of every sum are those of the
// first design, so the outputs are its bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTE = 32;  // elements per block
constexpr int kNG = 8;   // Gauss points (and nodes) per element
constexpr int kThreads = kTE * kNG;
// hardening tables of at most this many bytes are staged in shared memory
constexpr int kTableBytes = 2048;

// resident blocks an SM is asked to hold (the register budget's bound)
template <typename T> constexpr int kMinBlocks = 4;
template <> constexpr int kMinBlocks<double> = 2;

__constant__ float c_pus_f[8 * 3 * 8];   // pus[k][a][i] = dN_i/dxi_a at k
__constant__ double c_pus_d[8 * 3 * 8];

template <typename T> __device__ __forceinline__ T pus(int k, int a, int i);
template <> __device__ __forceinline__ float pus<float>(int k, int a, int i) {
  return c_pus_f[(k * 3 + a) * 8 + i];
}
template <> __device__ __forceinline__ double pus<double>(int k, int a,
                                                          int i) {
  return c_pus_d[(k * 3 + a) * 8 + i];
}

// Row bases of the Gauss-point state: stress rows c*8+k, GP-mean strain
// rows c, eq_ps and yield rows k, each row E long.  ``pad`` (output only)
// is the packed layout's two zero rows, nullptr in the unpacked one.
template <typename T> struct StateIn {
  const T* stress;
  const T* strain;
  const T* eq;
  const T* yield;
};
template <typename T> struct StateOut {
  T* stress;
  T* strain;
  T* eq;
  T* yield;
  T* pad;
};

template <typename T> StateIn<T> packed_in(const T* P, int64_t E) {
  return {P, P + 48 * E, P + 56 * E, P + 64 * E};
}
template <typename T> StateOut<T> packed_out(T* P, int64_t E) {
  return {P, P + 48 * E, P + 56 * E, P + 64 * E, P + 54 * E};
}

// The hardening tables: strain (M, W), slope (M, W - 1), rows (M,).
template <typename T> struct Hardening {
  const T* strain;
  const T* slope;
  const int32_t* n;
  int M, W;
};

// Bytes of the tables in shared memory (strain, slope, then rows), or 0
// when they exceed kTableBytes and stay in device memory.
template <typename T> int table_bytes(int M, int W) {
  const int64_t b = (int64_t)M * (2 * W - 1) * sizeof(T) + 4 * (int64_t)M;
  return b <= kTableBytes ? (int)b : 0;
}

// GENERIC: a = position, b = d_disp (3, N) in T, centred after the gather,
// coord_e unused; else a = disp, b = dprev (3, N) in K with coord_e.
// ``staged``: the launch gave table_bytes(M, W) bytes of dynamic shared
// memory for the hardening tables.  NEG (generic only): count the live
// Gauss points with detJ < 0 into *neg.
template <typename K, typename T, bool GENERIC, bool TRIAX,
          int MINB = kMinBlocks<T>, bool NEG = false>
__global__ void __launch_bounds__(kThreads, MINB)
element_kernel(const int32_t* __restrict__ elem,      // (8, E)
               const T* __restrict__ coord_e,         // (24, E)
               const K* __restrict__ disp,            // (3, N)
               const K* __restrict__ dprev,           // (3, N)
               const StateIn<T> gp,                   // Gauss-point state
               const T* __restrict__ G_e,             // (E,)
               const T* __restrict__ lam_e,           // (E,)
               const int32_t* __restrict__ mat,       // (E,)
               const uint8_t* __restrict__ hasp,      // (E,)
               const uint8_t* __restrict__ flag,      // (E,)
               const Hardening<T> hard, bool staged,
               int E, int N,
               const StateOut<T> gpo,                 // new state
               T* __restrict__ qe,                    // (24, E)
               T* __restrict__ triax,                 // (8, E) if TRIAX
               int32_t* __restrict__ neg) {           // () if NEG
  static_assert(GENERIC || !NEG, "the count is the generic stage's");
  // region A: s_kin[48][kTE] (pos rows b*8+i, du rows 24+b*8+i) from the
  // gather to the Jacobian, then sum 2's partials [7][kNG][kTE] after
  // barrier 2; region B: sum 1's partials [2][kNG][kTE] (with NEG the
  // warps' counts, kNG ints, after them), then the force moments M[c][b]
  // [9][kNG][kTE] after barrier 3
  __shared__ T s_a[7 * kNG * kTE];
  __shared__ T s_b[9 * kNG * kTE];
  extern __shared__ __align__(16) unsigned char s_tab[];
  T (*s_kin)[kTE] = reinterpret_cast<T (*)[kTE]>(s_a);
  T (*s_sum2)[kNG][kTE] = reinterpret_cast<T (*)[kNG][kTE]>(s_a);
  T (*s_sum1)[kNG][kTE] = reinterpret_cast<T (*)[kNG][kTE]>(s_b);
  T (*s_m)[kNG][kTE] = reinterpret_cast<T (*)[kNG][kTE]>(s_b);

  const int x = threadIdx.x;
  const int k = threadIdx.y;
  const int64_t e = (int64_t)blockIdx.x * kTE + x;
  const bool live = e < E;
  const int64_t ec = live ? e : (int64_t)E - 1;   // clamped for loads
  const int64_t sE = E;

  // ---- every load that needs no other load: thread (x, j = k) reads node
  // slot j's id and node 0's, its coord_e rows, its Gauss point's state
  // rows and the element's constants; the block stages the tables ----
  const int32_t n = elem[k * sE + ec];
  const int32_t n0 = elem[ec];
  T xe[3];
  if (!GENERIC) {
#pragma unroll
    for (int b = 0; b < 3; ++b) xe[b] = coord_e[(b * 8 + k) * sE + ec];
  }
  T sig0[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) sig0[c] = gp.stress[(c * 8 + k) * sE + ec];
  const T eq = gp.eq[k * sE + ec];
  const T ys = gp.yield[k * sE + ec];
  const T strain0 = k < 6 ? gp.strain[k * sE + ec] : T(0);
  const T Ge = G_e[ec], le = lam_e[ec];
  const int m = mat[ec];
  const bool hp = hasp[ec] != 0;
  const bool alive = flag[ec] != 0;
  Hardening<T> tab = hard;
  if (staged) {
    T* ts = reinterpret_cast<T*>(s_tab);
    T* tl = ts + hard.M * hard.W;
    int32_t* tn = reinterpret_cast<int32_t*>(tl + hard.M * (hard.W - 1));
    const int tid = k * kTE + x;
    for (int i = tid; i < hard.M * hard.W; i += kThreads)
      ts[i] = hard.strain[i];
    for (int i = tid; i < hard.M * (hard.W - 1); i += kThreads)
      tl[i] = hard.slope[i];
    for (int i = tid; i < hard.M; i += kThreads) tn[i] = hard.n[i];
    tab.strain = ts;
    tab.slope = tl;
    tab.n = tn;
  }

  // ---- gather: node slot j = k's disp and dprev and node 0's disp.  The
  // packed stage takes both differences in the nodal type K, then casts to
  // T; the generic stage centres the T position on node 0 in T ----
  {
    const int j = k;
    K d[3], pv[3], d0[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      d[b] = disp[b * (int64_t)N + n];
      pv[b] = dprev[b * (int64_t)N + n];
      d0[b] = disp[b * (int64_t)N + n0];
    }
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      s_kin[24 + b * 8 + j][x] = GENERIC ? T(pv[b]) : T(d[b] - pv[b]);
      s_kin[b * 8 + j][x] = GENERIC ? T(d[b] - d0[b])
                                    : xe[b] + T(d[b] - d0[b]);
    }
  }
  __syncthreads();                      // barrier 1: s_kin and the tables

  // ---- Jacobian and reference-space displacement gradient at k ----
  T J[3][3], Gd[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      T aj = pus<T>(k, a, 0) * s_kin[b * 8][x];
      T ag = pus<T>(k, a, 0) * s_kin[24 + b * 8][x];
#pragma unroll
      for (int i = 1; i < 8; ++i) {
        aj += pus<T>(k, a, i) * s_kin[b * 8 + i][x];
        ag += pus<T>(k, a, i) * s_kin[24 + b * 8 + i][x];
      }
      J[a][b] = aj;
      Gd[a][b] = ag;
    }
  }
  const T detJ = J[0][0] * J[1][1] * J[2][2] + J[0][1] * J[1][2] * J[2][0]
               + J[0][2] * J[1][0] * J[2][1] - J[0][0] * J[1][2] * J[2][1]
               - J[0][1] * J[1][0] * J[2][2] - J[0][2] * J[1][1] * J[2][0];
  const T adet = detJ < T(0) ? -detJ : detJ;
  if constexpr (NEG) {   // warp k's count of its 32 points, after sum 1
    const unsigned ballot = __ballot_sync(0xffffffffu,
                                          live && alive && detJ < T(0));
    if (x == 0) reinterpret_cast<int*>(s_b + 2 * kNG * kTE)[k] =
        __popc(ballot);
  }
  const T inv_det = T(1) / (detJ == T(0) ? T(1) : detJ);
  T iJ[3][3];   // iJ[b][a] = cofactor(a, b) / detJ
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int a1 = (a + 1) % 3, a2 = (a + 2) % 3;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int b1 = (b + 1) % 3, b2 = (b + 2) % 3;
      iJ[b][a] = (J[a1][b1] * J[a2][b2] - J[a1][b2] * J[a2][b1]) * inv_det;
    }
  }
  T g[3][3];    // g[a][b] = d du_b / d x_a
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      g[a][b] = iJ[a][0] * Gd[0][b] + iJ[a][1] * Gd[1][b]
              + iJ[a][2] * Gd[2][b];
  const T tr = g[0][0] + g[1][1] + g[2][2];

  // ---- sum 1 over Gauss points: V and the volbar numerator ----
  s_sum1[0][k][x] = adet;
  s_sum1[1][k][x] = adet * tr;
  __syncthreads();                      // barrier 2: sum 1; s_kin is dead
  if constexpr (NEG) {   // the block's count, read before barrier 3
    if (x == 0 && k == 0) {
      const int* w = reinterpret_cast<const int*>(s_b + 2 * kNG * kTE);
      int c = 0;
#pragma unroll
      for (int kk = 0; kk < kNG; ++kk) c += w[kk];
      if (c) atomicAdd(neg, c);
    }
  }
  T V = s_sum1[0][0][x], S = s_sum1[1][0][x];
#pragma unroll
  for (int kk = 1; kk < kNG; ++kk) {
    V += s_sum1[0][kk][x];
    S += s_sum1[1][kk][x];
  }
  const T inv_V = T(1) / (V == T(0) ? T(1) : V);
  const T volbar = S * inv_V / T(3);
  T de[6];
  de[0] = g[0][0] - tr / T(3) + volbar;
  de[1] = g[1][1] - tr / T(3) + volbar;
  de[2] = g[2][2] - tr / T(3) + volbar;
  de[3] = g[0][1] + g[1][0];
  de[4] = g[1][2] + g[2][1];
  de[5] = g[0][2] + g[2][0];
  const T tr_de = T(3) * volbar;

  // ---- elastic trial and J2 radial return ----
  T trial[6];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    trial[c] = sig0[c] + (le * tr_de + T(2) * Ge * de[c]);
#pragma unroll
  for (int c = 3; c < 6; ++c) trial[c] = sig0[c] + Ge * de[c];
  const T mean_s = (trial[0] + trial[1] + trial[2]) / T(3);
  T dev[6] = {trial[0] - mean_s, trial[1] - mean_s, trial[2] - mean_s,
              trial[3], trial[4], trial[5]};
  const T vm = sqrt(T(1.5) * (dev[0] * dev[0] + dev[1] * dev[1]
                              + dev[2] * dev[2]
                              + T(2) * (dev[3] * dev[3] + dev[4] * dev[4]
                                        + dev[5] * dev[5])));
  // hardening slope: count table strains (rows >= 1) strictly below eq_ps,
  // capped at npp - 2; zero for materials with fewer than two rows
  const int npp = tab.n[m];
  T H = T(0);
  if (npp >= 2) {
    int cnt = 0;
    for (int j = 1; j < npp; ++j) cnt += eq > tab.strain[m * tab.W + j];
    H = tab.slope[m * (tab.W - 1) + min(cnt, npp - 2)];
  }
  const bool plastic = hp && (vm > ys) && alive;
  const T safe_vm = vm == T(0) ? T(1) : vm;
  const T d_ep = plastic ? (vm - ys) / (T(3) * Ge + H) : T(0);
  const T scale = plastic ? (ys + H * d_ep) / safe_vm : T(1);
  T fin[6];
#pragma unroll
  for (int c = 0; c < 6; ++c)
    fin[c] = plastic ? dev[c] * scale + (c < 3 ? mean_s : T(0)) : trial[c];
  if (live) {
#pragma unroll
    for (int c = 0; c < 6; ++c) gpo.stress[(c * 8 + k) * sE + e] = fin[c];
    gpo.eq[k * sE + e] = plastic ? eq + d_ep : eq;
    gpo.yield[k * sE + e] = plastic ? ys + H * d_ep : ys;
    if (TRIAX) {   // triaxiality of the final stress
      const T a0 = fin[0] - fin[1], a1 = fin[1] - fin[2], a2 = fin[0] - fin[2];
      const T vm_t = sqrt(T(0.5) * (a0 * a0 + a1 * a1 + a2 * a2
                                    + T(6) * (fin[3] * fin[3]
                                              + fin[4] * fin[4]
                                              + fin[5] * fin[5])));
      const T mean_t = (fin[0] + fin[1] + fin[2]) / T(3);
      triax[k * sE + e] = vm_t < T(1e-10)
          ? T(0) : mean_t / (vm_t == T(0) ? T(1) : vm_t);
    }
  }

  // ---- sum 2 over Gauss points: strain increments and sum_w_sig_m ----
  const T sig_m = (fin[0] + fin[1] + fin[2]) / T(3);
#pragma unroll
  for (int c = 0; c < 6; ++c) s_sum2[c][k][x] = de[c];
  s_sum2[6][k][x] = detJ * sig_m;
  __syncthreads();                      // barrier 3: sum 2; sum 1 is dead
  T swsm = s_sum2[6][0][x];
#pragma unroll
  for (int kk = 1; kk < kNG; ++kk) swsm += s_sum2[6][kk][x];
  if (live) {
    // thread k < 6 writes GP-mean strain row k; threads 6 and 7 the packed
    // layout's zero rows
    if (k < 6) {
      T sde = s_sum2[k][0][x];
      for (int kk = 1; kk < kNG; ++kk) sde += s_sum2[k][kk][x];
      gpo.strain[k * sE + e] = strain0 + T(0.125) * sde;
    } else if (gpo.pad != nullptr) {
      gpo.pad[(k - 6) * sE + e] = T(0);
    }
  }

  // ---- internal-force moments M[c][b] at k ----
  const T st[3][3] = {{fin[0], fin[3], fin[5]},
                      {fin[3], fin[1], fin[4]},
                      {fin[5], fin[4], fin[2]}};
  const T wdet = adet * inv_V;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      T acc = iJ[0][c] * st[0][b] + iJ[1][c] * st[1][b] + iJ[2][c] * st[2][b];
      acc = acc - iJ[b][c] * sig_m;
      s_m[c * 3 + b][k][x] = detJ * acc + wdet * (iJ[b][c] * swsm);
    }
  }
  __syncthreads();                      // barrier 4: the moments

  // ---- Qe fold: thread (x, i = k) sums node i's rows over Gauss points --
  if (live) {
    const int i = k;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      T q = T(0);
#pragma unroll
      for (int kk = 0; kk < kNG; ++kk)
        q += pus<T>(kk, 0, i) * s_m[b][kk][x]
           + pus<T>(kk, 1, i) * s_m[3 + b][kk][x]
           + pus<T>(kk, 2, i) * s_m[6 + b][kk][x];
      qe[(b * 8 + i) * sE + e] = alive ? q : T(0);
    }
  }
}

template <typename K, typename T, bool GENERIC, bool TRIAX, bool NEG>
int launch_one(const int32_t* elem, const T* coord_e, const K* a,
               const K* b, StateIn<T> gp, const T* G_e, const T* lam_e,
               const int32_t* mat, const uint8_t* hasp, const uint8_t* flag,
               Hardening<T> hard, int E, int N, StateOut<T> gpo, T* qe,
               T* triax, int32_t* neg, void* stream) {
  const int smem = table_bytes<T>(hard.M, hard.W);
  element_kernel<K, T, GENERIC, TRIAX, kMinBlocks<T>, NEG>
      <<<(E + kTE - 1) / kTE, dim3(kTE, kNG), smem,
         (cudaStream_t)stream>>>(elem, coord_e, a, b, gp, G_e, lam_e, mat,
                                 hasp, flag, hard, smem > 0, E, N, gpo, qe,
                                 triax, neg);
  return (int)cudaGetLastError();
}

template <typename K, typename T, bool GENERIC>
int launch(const int32_t* elem, const T* coord_e, const K* a, const K* b,
           StateIn<T> gp, const T* G_e, const T* lam_e, const int32_t* mat,
           const uint8_t* hasp, const uint8_t* flag, const T* hard_strain,
           const T* hard_slope, const int32_t* hard_n, int M, int W, int E,
           int N, StateOut<T> gpo, T* qe, T* triax, int32_t* neg,
           void* stream) {
  if (E <= 0) return 0;
  if (M < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const Hardening<T> hard{hard_strain, hard_slope, hard_n, M, W};
  if constexpr (GENERIC) {   // the packed stage is given no count
    if (neg != nullptr && triax != nullptr)
      return launch_one<K, T, true, true, true>(
          elem, coord_e, a, b, gp, G_e, lam_e, mat, hasp, flag, hard, E, N,
          gpo, qe, triax, neg, stream);
    if (neg != nullptr)
      return launch_one<K, T, true, false, true>(
          elem, coord_e, a, b, gp, G_e, lam_e, mat, hasp, flag, hard, E, N,
          gpo, qe, triax, neg, stream);
  }
  if (triax != nullptr)
    return launch_one<K, T, GENERIC, true, false>(
        elem, coord_e, a, b, gp, G_e, lam_e, mat, hasp, flag, hard, E, N,
        gpo, qe, triax, nullptr, stream);
  return launch_one<K, T, GENERIC, false, false>(
      elem, coord_e, a, b, gp, G_e, lam_e, mat, hasp, flag, hard, E, N, gpo,
      qe, triax, nullptr, stream);
}

template <typename K, typename T>
int launch_packed(const int32_t* elem, const T* coord_e, const K* disp,
                  const K* dprev, const T* P, const T* G_e, const T* lam_e,
                  const int32_t* mat, const uint8_t* hasp,
                  const uint8_t* flag, const T* hard_strain,
                  const T* hard_slope, const int32_t* hard_n, int M, int W,
                  int E, int N, T* P_out, T* qe, T* triax, void* stream) {
  return launch<K, T, false>(elem, coord_e, disp, dprev, packed_in(P, E),
                             G_e, lam_e, mat, hasp, flag, hard_strain,
                             hard_slope, hard_n, M, W, E, N,
                             packed_out(P_out, E), qe, triax, nullptr,
                             stream);
}

template <typename T>
int launch_generic(const int32_t* elem, const T* position, const T* d_disp,
                   const T* stress, const T* strain, const T* eq,
                   const T* yield, const T* G_e, const T* lam_e,
                   const int32_t* mat, const uint8_t* hasp,
                   const uint8_t* flag, const T* hard_strain,
                   const T* hard_slope, const int32_t* hard_n, int M, int W,
                   int E, int N, T* stress_out, T* strain_out, T* eq_out,
                   T* yield_out, T* qe, T* triax, int32_t* neg,
                   void* stream) {
  return launch<T, T, true>(
      elem, nullptr, position, d_disp, {stress, strain, eq, yield}, G_e,
      lam_e, mat, hasp, flag, hard_strain, hard_slope, hard_n, M, W, E, N,
      {stress_out, strain_out, eq_out, yield_out, nullptr}, qe, triax, neg,
      stream);
}

// What one instantiation holds, with ``smem`` bytes of dynamic shared
// memory: out = {resident blocks an SM, registers a thread, static shared
// memory a block, local memory a thread (spills), smem}.
template <typename K, typename T, bool GENERIC, bool TRIAX,
          bool NEG = false>
int resources(int smem, int* out) {
  const auto kernel = element_kernel<K, T, GENERIC, TRIAX, kMinBlocks<T>,
                                     NEG>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  out[1] = fa.numRegs;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = (int)fa.localSizeBytes;
  out[4] = smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                            kThreads, smem);
}

}  // namespace

extern "C" {

// Load the (8, 3, 8) shape-gradient table (host pointer, float64) into the
// current device's constant memory, in both precisions.
int hk_set_pusai(const double* pus_host) {
  float f[8 * 3 * 8];
  for (int i = 0; i < 8 * 3 * 8; ++i) f[i] = (float)pus_host[i];
  cudaError_t err = cudaMemcpyToSymbol(c_pus_d, pus_host, sizeof(c_pus_d));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(c_pus_f, f, sizeof(c_pus_f));
}

// Each entry takes triax == nullptr for no triaxiality output.
int hk_element_f32(const int32_t* elem, const float* coord_e,
                   const float* disp, const float* dprev, const float* P,
                   const float* G_e, const float* lam_e, const int32_t* mat,
                   const uint8_t* hasp, const uint8_t* flag,
                   const float* hard_strain, const float* hard_slope,
                   const int32_t* hard_n, int M, int W, int E, int N,
                   float* P_out, float* qe, float* triax, void* stream) {
  return launch_packed<float, float>(elem, coord_e, disp, dprev, P, G_e,
                                     lam_e, mat, hasp, flag, hard_strain,
                                     hard_slope, hard_n, M, W, E, N, P_out,
                                     qe, triax, stream);
}

int hk_element_f64(const int32_t* elem, const double* coord_e,
                   const double* disp, const double* dprev, const double* P,
                   const double* G_e, const double* lam_e, const int32_t* mat,
                   const uint8_t* hasp, const uint8_t* flag,
                   const double* hard_strain, const double* hard_slope,
                   const int32_t* hard_n, int M, int W, int E, int N,
                   double* P_out, double* qe, double* triax, void* stream) {
  return launch_packed<double, double>(elem, coord_e, disp, dprev, P, G_e,
                                       lam_e, mat, hasp, flag, hard_strain,
                                       hard_slope, hard_n, M, W, E, N, P_out,
                                       qe, triax, stream);
}

// Mixed precision: float64 nodal disp/dprev, float32 everything else.
int hk_element_mixed(const int32_t* elem, const float* coord_e,
                     const double* disp, const double* dprev, const float* P,
                     const float* G_e, const float* lam_e, const int32_t* mat,
                     const uint8_t* hasp, const uint8_t* flag,
                     const float* hard_strain, const float* hard_slope,
                     const int32_t* hard_n, int M, int W, int E, int N,
                     float* P_out, float* qe, float* triax, void* stream) {
  return launch_packed<double, float>(elem, coord_e, disp, dprev, P, G_e,
                                      lam_e, mat, hasp, flag, hard_strain,
                                      hard_slope, hard_n, M, W, E, N, P_out,
                                      qe, triax, stream);
}

// The generic step's unpacked update: position and d_disp (3, N) in the
// element type; stress (6, 8, E), strain (6, E), eq_ps and yield (8, E) in
// and out as separate arrays; qe (3, 8, E).  neg == nullptr: no count;
// else the live Gauss points with detJ < 0 are added to *neg (int32).
int hk_element_update_f32(const int32_t* elem, const float* position,
                          const float* d_disp, const float* stress,
                          const float* strain, const float* eq,
                          const float* yield, const float* G_e,
                          const float* lam_e, const int32_t* mat,
                          const uint8_t* hasp, const uint8_t* flag,
                          const float* hard_strain, const float* hard_slope,
                          const int32_t* hard_n, int M, int W, int E, int N,
                          float* stress_out, float* strain_out,
                          float* eq_out, float* yield_out, float* qe,
                          float* triax, int32_t* neg, void* stream) {
  return launch_generic<float>(elem, position, d_disp, stress, strain, eq,
                               yield, G_e, lam_e, mat, hasp, flag,
                               hard_strain, hard_slope, hard_n, M, W, E, N,
                               stress_out, strain_out, eq_out, yield_out, qe,
                               triax, neg, stream);
}

int hk_element_update_f64(const int32_t* elem, const double* position,
                          const double* d_disp, const double* stress,
                          const double* strain, const double* eq,
                          const double* yield, const double* G_e,
                          const double* lam_e, const int32_t* mat,
                          const uint8_t* hasp, const uint8_t* flag,
                          const double* hard_strain,
                          const double* hard_slope, const int32_t* hard_n,
                          int M, int W, int E, int N, double* stress_out,
                          double* strain_out, double* eq_out,
                          double* yield_out, double* qe, double* triax,
                          int32_t* neg, void* stream) {
  return launch_generic<double>(elem, position, d_disp, stress, strain, eq,
                                yield, G_e, lam_e, mat, hasp, flag,
                                hard_strain, hard_slope, hard_n, M, W, E, N,
                                stress_out, strain_out, eq_out, yield_out, qe,
                                triax, neg, stream);
}

// The resources of instantiation ``which`` (0 packed f32, 1 packed f64,
// 2 packed mixed, 3 unpacked f32, 4 unpacked f64; +5 with the triaxiality
// output; 10-13: 3, 4, 8, 9 with the negative-Jacobian count) with the
// shared-memory tables of an (M, W) hardening table, into out[5] (see
// resources above).
int hk_element_resources(int which, int M, int W, int* out) {
  const int sf = table_bytes<float>(M, W), sd = table_bytes<double>(M, W);
  switch (which) {
    case 0: return resources<float, float, false, false>(sf, out);
    case 1: return resources<double, double, false, false>(sd, out);
    case 2: return resources<double, float, false, false>(sf, out);
    case 3: return resources<float, float, true, false>(sf, out);
    case 4: return resources<double, double, true, false>(sd, out);
    case 5: return resources<float, float, false, true>(sf, out);
    case 6: return resources<double, double, false, true>(sd, out);
    case 7: return resources<double, float, false, true>(sf, out);
    case 8: return resources<float, float, true, true>(sf, out);
    case 9: return resources<double, double, true, true>(sd, out);
    case 10: return resources<float, float, true, false, true>(sf, out);
    case 11: return resources<double, double, true, false, true>(sd, out);
    case 12: return resources<float, float, true, true, true>(sf, out);
    case 13: return resources<double, double, true, true, true>(sd, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* hk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
