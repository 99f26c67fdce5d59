// Design variants of the element kernel (hakai_tpu_torch/csrc/element.cu)
// and of assembly kernel B (hakai_tpu_torch/csrc/assemble.cu) at the bench
// bar's shapes (32 x 32 x 128 hex8 elements in natural order: E = 131,072,
// N = 140,544 with padding, V = 8), each call timed alone with CUDA events
// behind a 256 MB memset (cold L2), the median of 5 batches of 20 calls,
// as chip_smoke.py times its kernels; each variant's outputs compared bit
// for bit with the first design's.  The shipped designs come from the
// package's sources; the first designs and the variants not shipped live
// here.
//
// Build and run, from the repository's root (the first two lines are one
// command):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//     scripts/kernel_variants.cu -o build/kernel_variants
//   ./build/kernel_variants
// About 20 s on an H100.  A line: the case, the variant, its registers,
// static and dynamic shared memory a block, local memory a thread (spills)
// and resident blocks an SM (cudaFuncGetAttributes and the occupancy
// calculator), its time and its share of the byte bound.
//
// Element variants: "first design" (every load behind the one it waits
// on or behind a barrier; six barriers); "hoisted, min b": the shipped
// design with __launch_bounds__(256, b) (shipped: b = 4 in f32, 2 in f64);
// "no stage": the hardening tables read from device memory; "C1 fold
// terms": each Gauss-point thread forms its 24 terms of the Qe fold and
// a node's thread sums them (a third of the fold's shared-memory reads,
// a larger buffer); "C2 two points": two Gauss points a thread (128
// threads a block), each gathered value and moment read once for both;
// "C3 constant operands": the Gauss point of the Jacobian and of the fold
// a template argument under a warp-uniform switch, so the shape-gradient
// table needs no indexed constant loads; "C4 nodal prefetch": the grid
// first asks L2 to prefetch disp and dprev; "C5 evict-first state":
// __ldcs/__stcs on the streamed state; "C6 persistent, cp.async": as many
// blocks as fit at once walk the tiles, staging the next tile's state rows
// with cp.async while they compute one (f32 only: its f64 buffers exceed
// 48 KB of static shared); and, as a floor, "diagnostic: memory only"
// (the loads, gather and stores without the arithmetic).
//
// Assembly variants: "first design" (a runtime slot loop: mask, branch,
// index, then the three source loads, one slot after the other); the
// shipped kernel with V = 8 a template argument and with its 8-slot
// chunks (any other V); V = 8 with plain table loads, at other block
// sizes and register bounds, and with an L2 prefetch of the source; 2 or
// 4 nodes a thread; 2 or 4 consecutive nodes a thread through 8- or
// 16-byte index loads; and, as a floor, the first wave alone (the table
// read, no gathers).
#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace el {
#include "../hakai_tpu_torch/csrc/element.cu"

// The first design (the kernel as first ported), kept for comparison.
template <typename K, typename T, bool GENERIC, bool TRIAX>
__global__ void __launch_bounds__(kTE * kNG)
first_element_kernel(const int32_t* __restrict__ elem,      // (8, E)
               const T* __restrict__ coord_e,         // (24, E)
               const K* __restrict__ disp,            // (3, N)
               const K* __restrict__ dprev,           // (3, N)
               const StateIn<T> gp,                   // Gauss-point state
               const T* __restrict__ G_e,             // (E,)
               const T* __restrict__ lam_e,           // (E,)
               const int32_t* __restrict__ mat,       // (E,)
               const uint8_t* __restrict__ hasp,      // (E,)
               const uint8_t* __restrict__ flag,      // (E,)
               const T* __restrict__ hard_strain,     // (M, W)
               const T* __restrict__ hard_slope,      // (M, W - 1)
               const int32_t* __restrict__ hard_n,    // (M,)
               int W, int E, int N,
               const StateOut<T> gpo,                 // new state
               T* __restrict__ qe,                    // (24, E)
               T* __restrict__ triax) {               // (8, E) if TRIAX
  __shared__ T s_kin[48][kTE];        // pos rows b*8+i, du rows 24+b*8+i
  __shared__ K s_d0[3][kTE];          // node 0's displacement, nodal type
  __shared__ T s_red[7][kNG][kTE];    // Gauss-point partials
  __shared__ T s_m[9][kNG][kTE];      // force moments M[c][b] per k

  const int x = threadIdx.x;
  const int k = threadIdx.y;
  const int64_t e = (int64_t)blockIdx.x * kTE + x;
  const bool live = e < E;
  const int64_t ec = live ? e : (int64_t)E - 1;   // clamped for loads
  const int64_t sE = E;

  // ---- gather: thread (x, j = k) loads node slot j of element x.  The
  // packed stage takes both differences in the nodal type K, then casts to
  // T; the generic stage centres the T position on node 0 in T ----
  {
    const int j = k;
    const int64_t n = elem[j * sE + ec];
    K d[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      d[b] = disp[b * (int64_t)N + n];
      s_kin[24 + b * 8 + j][x] = GENERIC ? T(dprev[b * (int64_t)N + n])
                                         : T(d[b] - dprev[b * (int64_t)N + n]);
      if (j == 0) s_d0[b][x] = d[b];
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < 3; ++b)   // node-0-centred position
      s_kin[b * 8 + j][x] =
          GENERIC ? T(d[b] - s_d0[b][x])
                  : coord_e[(b * 8 + j) * sE + ec] + T(d[b] - s_d0[b][x]);
    __syncthreads();
  }

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
  s_red[0][k][x] = adet;
  s_red[1][k][x] = adet * tr;
  __syncthreads();
  T V = s_red[0][0][x], S = s_red[1][0][x];
#pragma unroll
  for (int kk = 1; kk < kNG; ++kk) {
    V += s_red[0][kk][x];
    S += s_red[1][kk][x];
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
  const T Ge = G_e[ec], le = lam_e[ec];
  T trial[6];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    trial[c] = gp.stress[(c * 8 + k) * sE + ec]
             + (le * tr_de + T(2) * Ge * de[c]);
#pragma unroll
  for (int c = 3; c < 6; ++c)
    trial[c] = gp.stress[(c * 8 + k) * sE + ec] + Ge * de[c];
  const T mean_s = (trial[0] + trial[1] + trial[2]) / T(3);
  T dev[6] = {trial[0] - mean_s, trial[1] - mean_s, trial[2] - mean_s,
              trial[3], trial[4], trial[5]};
  const T vm = sqrt(T(1.5) * (dev[0] * dev[0] + dev[1] * dev[1]
                              + dev[2] * dev[2]
                              + T(2) * (dev[3] * dev[3] + dev[4] * dev[4]
                                        + dev[5] * dev[5])));
  const T eq = gp.eq[k * sE + ec];
  const T ys = gp.yield[k * sE + ec];
  // hardening slope: count table strains (rows >= 1) strictly below eq_ps,
  // capped at npp - 2; zero for materials with fewer than two rows
  const int m = mat[ec];
  const int npp = hard_n[m];
  T H = T(0);
  if (npp >= 2) {
    int cnt = 0;
    for (int j = 1; j < npp; ++j) cnt += eq > hard_strain[m * W + j];
    H = hard_slope[m * (W - 1) + min(cnt, npp - 2)];
  }
  const bool plastic = hasp[ec] && (vm > ys) && flag[ec];
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
  __syncthreads();                      // sum 1's reads are done
#pragma unroll
  for (int c = 0; c < 6; ++c) s_red[c][k][x] = de[c];
  s_red[6][k][x] = detJ * sig_m;
  __syncthreads();
  T swsm = s_red[6][0][x];
#pragma unroll
  for (int kk = 1; kk < kNG; ++kk) swsm += s_red[6][kk][x];
  if (live) {
    // thread k < 6 writes GP-mean strain row k; threads 6 and 7 the packed
    // layout's zero rows
    if (k < 6) {
      T sde = s_red[k][0][x];
      for (int kk = 1; kk < kNG; ++kk) sde += s_red[k][kk][x];
      gpo.strain[k * sE + e] = gp.strain[k * sE + ec] + T(0.125) * sde;
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
  __syncthreads();

  // ---- Qe fold: thread (x, i = k) sums node i's rows over Gauss points --
  if (live) {
    const int i = k;
    const bool alive = flag[e] != 0;
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

// candidate C2: two Gauss points a thread (blockDim (32, 4)): thread (x, h)
// owns Gauss points and node slots 2h and 2h + 1 of element x, so each
// gathered kinematic value and each force moment read from shared memory
// serves two Gauss points (two nodes); every per-point operation and every
// sum's order as in the one-point design
template <typename K, typename T, bool GENERIC, bool TRIAX, int MINB>
__global__ void __launch_bounds__(kTE * 4, MINB)
element_kernel_c2(const int32_t* __restrict__ elem,
                  const T* __restrict__ coord_e,
                  const K* __restrict__ disp,
                  const K* __restrict__ dprev,
                  const StateIn<T> gp,
                  const T* __restrict__ G_e,
                  const T* __restrict__ lam_e,
                  const int32_t* __restrict__ mat,
                  const uint8_t* __restrict__ hasp,
                  const uint8_t* __restrict__ flag,
                  const Hardening<T> hard, bool staged,
                  int E, int N,
                  const StateOut<T> gpo,
                  T* __restrict__ qe,
                  T* __restrict__ triax,
                  int32_t*) {                            // neg: unused
  __shared__ T s_a[7 * kNG * kTE];
  __shared__ T s_b[9 * kNG * kTE];
  extern __shared__ __align__(16) unsigned char s_tab[];
  T (*s_kin)[kTE] = reinterpret_cast<T (*)[kTE]>(s_a);
  T (*s_sum2)[kNG][kTE] = reinterpret_cast<T (*)[kNG][kTE]>(s_a);
  T (*s_sum1)[kNG][kTE] = reinterpret_cast<T (*)[kNG][kTE]>(s_b);
  T (*s_m)[kNG][kTE] = reinterpret_cast<T (*)[kNG][kTE]>(s_b);

  const int x = threadIdx.x;
  const int h = threadIdx.y;
  const int64_t e = (int64_t)blockIdx.x * kTE + x;
  const bool live = e < E;
  const int64_t ec = live ? e : (int64_t)E - 1;
  const int64_t sE = E;

  int32_t n[2];
  T xe[2][3], sig0[2][6], eq[2], ys[2], strain0[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int k = 2 * h + t;
    n[t] = elem[k * sE + ec];
    if (!GENERIC) {
#pragma unroll
      for (int b = 0; b < 3; ++b) xe[t][b] = coord_e[(b * 8 + k) * sE + ec];
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) sig0[t][c] = gp.stress[(c * 8 + k) * sE + ec];
    eq[t] = gp.eq[k * sE + ec];
    ys[t] = gp.yield[k * sE + ec];
    strain0[t] = k < 6 ? gp.strain[k * sE + ec] : T(0);
  }
  const int32_t n0 = elem[ec];
  const T Ge = G_e[ec], le = lam_e[ec];
  const int m = mat[ec];
  const bool hp = hasp[ec] != 0;
  const bool alive = flag[ec] != 0;
  Hardening<T> tab = hard;
  if (staged) {
    T* ts = reinterpret_cast<T*>(s_tab);
    T* tl = ts + hard.M * hard.W;
    int32_t* tn = reinterpret_cast<int32_t*>(tl + hard.M * (hard.W - 1));
    const int tid = h * kTE + x;
    for (int i = tid; i < hard.M * hard.W; i += kTE * 4) ts[i] = hard.strain[i];
    for (int i = tid; i < hard.M * (hard.W - 1); i += kTE * 4)
      tl[i] = hard.slope[i];
    for (int i = tid; i < hard.M; i += kTE * 4) tn[i] = hard.n[i];
    tab.strain = ts;
    tab.slope = tl;
    tab.n = tn;
  }

  {
    K d[2][3], pv[2][3], d0[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        d[t][b] = disp[b * (int64_t)N + n[t]];
        pv[t][b] = dprev[b * (int64_t)N + n[t]];
      }
      d0[b] = disp[b * (int64_t)N + n0];
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = 2 * h + t;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        s_kin[24 + b * 8 + j][x] = GENERIC ? T(pv[t][b]) : T(d[t][b] - pv[t][b]);
        s_kin[b * 8 + j][x] = GENERIC ? T(d[t][b] - d0[b])
                                      : xe[t][b] + T(d[t][b] - d0[b]);
      }
    }
  }
  __syncthreads();

  // Jacobians and displacement gradients of both points, each gathered
  // value read once
  T J[2][3][3], Gd[2][3][3];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const T p = s_kin[b * 8 + i][x], u = s_kin[24 + b * 8 + i][x];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          if (i == 0) {
            J[t][a][b] = pus<T>(2 * h + t, a, 0) * p;
            Gd[t][a][b] = pus<T>(2 * h + t, a, 0) * u;
          } else {
            J[t][a][b] += pus<T>(2 * h + t, a, i) * p;
            Gd[t][a][b] += pus<T>(2 * h + t, a, i) * u;
          }
        }
      }
    }
  }
  T detJ[2], adet[2], iJ[2][3][3], g[2][3][3], tr[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const T (&Jt)[3][3] = J[t];
    detJ[t] = Jt[0][0] * Jt[1][1] * Jt[2][2] + Jt[0][1] * Jt[1][2] * Jt[2][0]
            + Jt[0][2] * Jt[1][0] * Jt[2][1] - Jt[0][0] * Jt[1][2] * Jt[2][1]
            - Jt[0][1] * Jt[1][0] * Jt[2][2] - Jt[0][2] * Jt[1][1] * Jt[2][0];
    adet[t] = detJ[t] < T(0) ? -detJ[t] : detJ[t];
    const T inv_det = T(1) / (detJ[t] == T(0) ? T(1) : detJ[t]);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int a1 = (a + 1) % 3, a2 = (a + 2) % 3;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int b1 = (b + 1) % 3, b2 = (b + 2) % 3;
        iJ[t][b][a] = (Jt[a1][b1] * Jt[a2][b2] - Jt[a1][b2] * Jt[a2][b1])
                    * inv_det;
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        g[t][a][b] = iJ[t][a][0] * Gd[t][0][b] + iJ[t][a][1] * Gd[t][1][b]
                   + iJ[t][a][2] * Gd[t][2][b];
    tr[t] = g[t][0][0] + g[t][1][1] + g[t][2][2];
    s_sum1[0][2 * h + t][x] = adet[t];
    s_sum1[1][2 * h + t][x] = adet[t] * tr[t];
  }
  __syncthreads();
  T V = s_sum1[0][0][x], S = s_sum1[1][0][x];
#pragma unroll
  for (int kk = 1; kk < kNG; ++kk) {
    V += s_sum1[0][kk][x];
    S += s_sum1[1][kk][x];
  }
  const T inv_V = T(1) / (V == T(0) ? T(1) : V);
  const T volbar = S * inv_V / T(3);
  const T tr_de = T(3) * volbar;

  T de[2][6], fin[2][6], sig_m[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int k = 2 * h + t;
    de[t][0] = g[t][0][0] - tr[t] / T(3) + volbar;
    de[t][1] = g[t][1][1] - tr[t] / T(3) + volbar;
    de[t][2] = g[t][2][2] - tr[t] / T(3) + volbar;
    de[t][3] = g[t][0][1] + g[t][1][0];
    de[t][4] = g[t][1][2] + g[t][2][1];
    de[t][5] = g[t][0][2] + g[t][2][0];
    T trial[6];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      trial[c] = sig0[t][c] + (le * tr_de + T(2) * Ge * de[t][c]);
#pragma unroll
    for (int c = 3; c < 6; ++c) trial[c] = sig0[t][c] + Ge * de[t][c];
    const T mean_s = (trial[0] + trial[1] + trial[2]) / T(3);
    T dev[6] = {trial[0] - mean_s, trial[1] - mean_s, trial[2] - mean_s,
                trial[3], trial[4], trial[5]};
    const T vm = sqrt(T(1.5) * (dev[0] * dev[0] + dev[1] * dev[1]
                                + dev[2] * dev[2]
                                + T(2) * (dev[3] * dev[3] + dev[4] * dev[4]
                                          + dev[5] * dev[5])));
    const int npp = tab.n[m];
    T H = T(0);
    if (npp >= 2) {
      int cnt = 0;
      for (int j = 1; j < npp; ++j) cnt += eq[t] > tab.strain[m * tab.W + j];
      H = tab.slope[m * (tab.W - 1) + min(cnt, npp - 2)];
    }
    const bool plastic = hp && (vm > ys[t]) && alive;
    const T safe_vm = vm == T(0) ? T(1) : vm;
    const T d_ep = plastic ? (vm - ys[t]) / (T(3) * Ge + H) : T(0);
    const T scale = plastic ? (ys[t] + H * d_ep) / safe_vm : T(1);
#pragma unroll
    for (int c = 0; c < 6; ++c)
      fin[t][c] = plastic ? dev[c] * scale + (c < 3 ? mean_s : T(0)) : trial[c];
    if (live) {
#pragma unroll
      for (int c = 0; c < 6; ++c) gpo.stress[(c * 8 + k) * sE + e] = fin[t][c];
      gpo.eq[k * sE + e] = plastic ? eq[t] + d_ep : eq[t];
      gpo.yield[k * sE + e] = plastic ? ys[t] + H * d_ep : ys[t];
      if (TRIAX) {
        const T* f = fin[t];
        const T a0 = f[0] - f[1], a1 = f[1] - f[2], a2 = f[0] - f[2];
        const T vm_t = sqrt(T(0.5) * (a0 * a0 + a1 * a1 + a2 * a2
                                      + T(6) * (f[3] * f[3] + f[4] * f[4]
                                                + f[5] * f[5])));
        const T mean_t = (f[0] + f[1] + f[2]) / T(3);
        triax[k * sE + e] = vm_t < T(1e-10)
            ? T(0) : mean_t / (vm_t == T(0) ? T(1) : vm_t);
      }
    }
    sig_m[t] = (fin[t][0] + fin[t][1] + fin[t][2]) / T(3);
#pragma unroll
    for (int c = 0; c < 6; ++c) s_sum2[c][k][x] = de[t][c];
    s_sum2[6][k][x] = detJ[t] * sig_m[t];
  }
  __syncthreads();
  T swsm = s_sum2[6][0][x];
#pragma unroll
  for (int kk = 1; kk < kNG; ++kk) swsm += s_sum2[6][kk][x];
  if (live) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int k = 2 * h + t;
      if (k < 6) {
        T sde = s_sum2[k][0][x];
        for (int kk = 1; kk < kNG; ++kk) sde += s_sum2[k][kk][x];
        gpo.strain[k * sE + e] = strain0[t] + T(0.125) * sde;
      } else if (gpo.pad != nullptr) {
        gpo.pad[(k - 6) * sE + e] = T(0);
      }
    }
  }
  const T wdet0 = adet[0] * inv_V, wdet1 = adet[1] * inv_V;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const T* f = fin[t];
    const T st[3][3] = {{f[0], f[3], f[5]}, {f[3], f[1], f[4]},
                        {f[5], f[4], f[2]}};
    const T wdet = t == 0 ? wdet0 : wdet1;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        T acc = iJ[t][0][c] * st[0][b] + iJ[t][1][c] * st[1][b]
              + iJ[t][2][c] * st[2][b];
        acc = acc - iJ[t][b][c] * sig_m[t];
        s_m[c * 3 + b][2 * h + t][x] = detJ[t] * acc
                                     + wdet * (iJ[t][b][c] * swsm);
      }
    }
  }
  __syncthreads();
  if (live) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      T q0 = T(0), q1 = T(0);
#pragma unroll
      for (int kk = 0; kk < kNG; ++kk) {
        const T m0 = s_m[b][kk][x], m1 = s_m[3 + b][kk][x],
                m2 = s_m[6 + b][kk][x];
        q0 += pus<T>(kk, 0, 2 * h) * m0 + pus<T>(kk, 1, 2 * h) * m1
            + pus<T>(kk, 2, 2 * h) * m2;
        q1 += pus<T>(kk, 0, 2 * h + 1) * m0 + pus<T>(kk, 1, 2 * h + 1) * m1
            + pus<T>(kk, 2, 2 * h + 1) * m2;
      }
      qe[(b * 8 + 2 * h) * sE + e] = alive ? q0 : T(0);
      qe[(b * 8 + 2 * h + 1) * sE + e] = alive ? q1 : T(0);
    }
  }
}

// C3's Jacobian and fold: the Gauss point (node) index a template
// argument, so every shape-gradient entry is a constant-bank operand
template <int KG, typename T>
__device__ __forceinline__ void c3_jacobian(const T (*s_kin)[kTE], int x,
                                            T (&J)[3][3], T (&Gd)[3][3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      T aj = pus<T>(KG, a, 0) * s_kin[b * 8][x];
      T ag = pus<T>(KG, a, 0) * s_kin[24 + b * 8][x];
#pragma unroll
      for (int i = 1; i < 8; ++i) {
        aj += pus<T>(KG, a, i) * s_kin[b * 8 + i][x];
        ag += pus<T>(KG, a, i) * s_kin[24 + b * 8 + i][x];
      }
      J[a][b] = aj;
      Gd[a][b] = ag;
    }
  }
}

template <int IG, typename T>
__device__ __forceinline__ void c3_fold(const T (*s_m)[kNG][kTE], int x,
                                        T (&q)[3]) {
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    T acc = T(0);
#pragma unroll
    for (int kk = 0; kk < kNG; ++kk)
      acc += pus<T>(kk, 0, IG) * s_m[b][kk][x]
           + pus<T>(kk, 1, IG) * s_m[3 + b][kk][x]
           + pus<T>(kk, 2, IG) * s_m[6 + b][kk][x];
    q[b] = acc;
  }
}

// Candidates C1, C3, C4 and C5: the shipped design with one change each
// (ALT = 1, 3, 4 or 5), every per-thread operation and sum order kept:
//  C1 each Gauss-point thread forms its 24 terms of the Qe fold and node
//     i's thread sums them (a third of the fold's shared-memory reads, a
//     larger buffer);
//  C3 the Gauss point of the Jacobian and of the fold a template argument
//     under a warp-uniform switch;
//  C4 the grid first asks L2 to prefetch disp and dprev;
//  C5 evict-first loads and stores of the streamed state.
template <typename K, typename T, bool GENERIC, bool TRIAX, int MINB,
          int ALT>
__global__ void __launch_bounds__(kThreads, MINB)
element_kernel_alt(const int32_t* __restrict__ elem,      // (8, E)
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
               int32_t*) {                            // neg: unused
  // region A: s_kin[48][kTE] (pos rows b*8+i, du rows 24+b*8+i) from the
  // gather to the Jacobian, then sum 2's partials [7][kNG][kTE] after
  // barrier 2; region B: sum 1's partials [2][kNG][kTE], then the force
  // moments M[c][b] [9][kNG][kTE] after barrier 3
  __shared__ T s_a[7 * kNG * kTE];
  __shared__ T s_b[(ALT == 1 ? 24 : 9) * kNG * kTE];
  extern __shared__ __align__(16) unsigned char s_tab[];
  T (*s_kin)[kTE] = reinterpret_cast<T (*)[kTE]>(s_a);
  T (*s_sum2)[kNG][kTE] = reinterpret_cast<T (*)[kNG][kTE]>(s_a);
  T (*s_sum1)[kNG][kTE] = reinterpret_cast<T (*)[kNG][kTE]>(s_b);
  T (*s_m)[kNG][kTE] = reinterpret_cast<T (*)[kNG][kTE]>(s_b);
  T (*s_f)[24][kTE] = reinterpret_cast<T (*)[24][kTE]>(s_b);   // C1
  // C5: the streamed state evict-first
  const auto load = [](const T* p) { return ALT == 5 ? __ldcs(p) : *p; };
  const auto store = [](T* p, T v) {
    if (ALT == 5) __stcs(p, v);
    else *p = v;
  };

  const int x = threadIdx.x;
  const int k = threadIdx.y;
  const int64_t e = (int64_t)blockIdx.x * kTE + x;
  const bool live = e < E;
  const int64_t ec = live ? e : (int64_t)E - 1;   // clamped for loads
  const int64_t sE = E;

  if (ALT == 4) {   // C4: the grid asks L2 for the nodal arrays
    const int64_t lines = (3 * (int64_t)N * (int64_t)sizeof(K) + 127) / 128;
    const int64_t g = (int64_t)blockIdx.x * kThreads + k * kTE + x;
    for (int64_t l = g; l < lines; l += (int64_t)gridDim.x * kThreads) {
      asm volatile("prefetch.global.L2 [%0];"
                   ::"l"(reinterpret_cast<const char*>(disp) + 128 * l));
      asm volatile("prefetch.global.L2 [%0];"
                   ::"l"(reinterpret_cast<const char*>(dprev) + 128 * l));
    }
  }
  // ---- every load that needs no other load: thread (x, j = k) reads node
  // slot j's id and node 0's, its coord_e rows, its Gauss point's state
  // rows and the element's constants; the block stages the tables ----
  const int32_t n = elem[k * sE + ec];
  const int32_t n0 = elem[ec];
  T xe[3];
  if (!GENERIC) {
#pragma unroll
    for (int b = 0; b < 3; ++b) xe[b] = load(coord_e + (b * 8 + k) * sE + ec);
  }
  T sig0[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) sig0[c] = load(gp.stress + (c * 8 + k) * sE + ec);
  const T eq = load(gp.eq + k * sE + ec);
  const T ys = load(gp.yield + k * sE + ec);
  const T strain0 = k < 6 ? load(gp.strain + k * sE + ec) : T(0);
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
  if (ALT == 3) {   // C3: warp-uniform, the table entries constant operands
    switch (k) {
      case 0: c3_jacobian<0>(s_kin, x, J, Gd); break;
      case 1: c3_jacobian<1>(s_kin, x, J, Gd); break;
      case 2: c3_jacobian<2>(s_kin, x, J, Gd); break;
      case 3: c3_jacobian<3>(s_kin, x, J, Gd); break;
      case 4: c3_jacobian<4>(s_kin, x, J, Gd); break;
      case 5: c3_jacobian<5>(s_kin, x, J, Gd); break;
      case 6: c3_jacobian<6>(s_kin, x, J, Gd); break;
      default: c3_jacobian<7>(s_kin, x, J, Gd); break;
    }
  } else {
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
  }
  const T detJ = J[0][0] * J[1][1] * J[2][2] + J[0][1] * J[1][2] * J[2][0]
               + J[0][2] * J[1][0] * J[2][1] - J[0][0] * J[1][2] * J[2][1]
               - J[0][1] * J[1][0] * J[2][2] - J[0][2] * J[1][1] * J[2][0];
  const T adet = detJ < T(0) ? -detJ : detJ;
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
    for (int c = 0; c < 6; ++c) store(gpo.stress + (c * 8 + k) * sE + e, fin[c]);
    store(gpo.eq + k * sE + e, plastic ? eq + d_ep : eq);
    store(gpo.yield + k * sE + e, plastic ? ys + H * d_ep : ys);
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
      store(gpo.strain + k * sE + e, strain0 + T(0.125) * sde);
    } else if (gpo.pad != nullptr) {
      gpo.pad[(k - 6) * sE + e] = T(0);
    }
  }

  // ---- internal-force moments M[c][b] at k ----
  const T st[3][3] = {{fin[0], fin[3], fin[5]},
                      {fin[3], fin[1], fin[4]},
                      {fin[5], fin[4], fin[2]}};
  const T wdet = adet * inv_V;
  T Mk[9];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      T acc = iJ[0][c] * st[0][b] + iJ[1][c] * st[1][b] + iJ[2][c] * st[2][b];
      acc = acc - iJ[b][c] * sig_m;
      Mk[c * 3 + b] = detJ * acc + wdet * (iJ[b][c] * swsm);
    }
  }
  if (ALT == 1) {   // C1: this point's terms of the fold, node rows b*8+i
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        s_f[k][b * 8 + i][x] = pus<T>(k, 0, i) * Mk[b]
                             + pus<T>(k, 1, i) * Mk[3 + b]
                             + pus<T>(k, 2, i) * Mk[6 + b];
  } else {
#pragma unroll
    for (int cb = 0; cb < 9; ++cb) s_m[cb][k][x] = Mk[cb];
  }
  __syncthreads();                      // barrier 4: the moments

  // ---- Qe fold: thread (x, i = k) sums node i's rows over Gauss points --
  if (live) {
    const int i = k;
    T q[3];
    if (ALT == 1) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        q[b] = T(0);
#pragma unroll
        for (int kk = 0; kk < kNG; ++kk) q[b] += s_f[kk][b * 8 + i][x];
      }
    } else if (ALT == 3) {
      switch (k) {
        case 0: c3_fold<0>(s_m, x, q); break;
        case 1: c3_fold<1>(s_m, x, q); break;
        case 2: c3_fold<2>(s_m, x, q); break;
        case 3: c3_fold<3>(s_m, x, q); break;
        case 4: c3_fold<4>(s_m, x, q); break;
        case 5: c3_fold<5>(s_m, x, q); break;
        case 6: c3_fold<6>(s_m, x, q); break;
        default: c3_fold<7>(s_m, x, q); break;
      }
    } else {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        q[b] = T(0);
#pragma unroll
        for (int kk = 0; kk < kNG; ++kk)
          q[b] += pus<T>(kk, 0, i) * s_m[b][kk][x]
                + pus<T>(kk, 1, i) * s_m[3 + b][kk][x]
                + pus<T>(kk, 2, i) * s_m[6 + b][kk][x];
      }
    }
#pragma unroll
    for (int b = 0; b < 3; ++b)
      qe[(b * 8 + i) * sE + e] = alive ? q[b] : T(0);
  }
}

// candidate C6: the shipped design as a persistent grid (as many blocks as
// fit at once) whose blocks walk their tiles, each staging the next
// tile's state rows and node ids with cp.async while it computes one
template <typename K, typename T, bool GENERIC, bool TRIAX,
          int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
element_kernel_c6(const int32_t* __restrict__ elem,      // (8, E)
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
               int32_t*) {                            // neg: unused
  // region A: s_kin[48][kTE] (pos rows b*8+i, du rows 24+b*8+i) from the
  // gather to the Jacobian, then sum 2's partials [7][kNG][kTE] after
  // barrier 2; region B: sum 1's partials [2][kNG][kTE], then the force
  // moments M[c][b] [9][kNG][kTE] after barrier 3
  __shared__ T s_a[7 * kNG * kTE];
  __shared__ T s_b[9 * kNG * kTE];
  extern __shared__ __align__(16) unsigned char s_tab[];
  T (*s_kin)[kTE] = reinterpret_cast<T (*)[kTE]>(s_a);
  T (*s_sum2)[kNG][kTE] = reinterpret_cast<T (*)[kNG][kTE]>(s_a);
  T (*s_sum1)[kNG][kTE] = reinterpret_cast<T (*)[kNG][kTE]>(s_b);
  T (*s_m)[kNG][kTE] = reinterpret_cast<T (*)[kNG][kTE]>(s_b);

  // C6: the state rows of tile t + gridDim.x staged with cp.async while
  // tile t computes: slots 0-2 coord_e, 3-8 stress, 9 eq_ps, 10 yield,
  // 11 strain; the node ids apart
  __shared__ T s_st[12][kThreads];
  __shared__ int32_t s_id[2][kThreads];
  const int x = threadIdx.x;
  const int k = threadIdx.y;
  const int tid = k * kTE + x;
  const int64_t sE = E;
  const int n_tiles = (E + kTE - 1) / kTE;
  const auto stage = [&](int tile) {
    const int64_t e = (int64_t)tile * kTE + x;
    const int64_t ec = e < E ? e : (int64_t)E - 1;
    __pipeline_memcpy_async(&s_id[0][tid], elem + k * sE + ec, 4);
    __pipeline_memcpy_async(&s_id[1][tid], elem + ec, 4);
    if (!GENERIC) {
#pragma unroll
      for (int b = 0; b < 3; ++b)
        __pipeline_memcpy_async(&s_st[b][tid], coord_e + (b * 8 + k) * sE + ec,
                                sizeof(T));
    }
#pragma unroll
    for (int c = 0; c < 6; ++c)
      __pipeline_memcpy_async(&s_st[3 + c][tid],
                              gp.stress + (c * 8 + k) * sE + ec, sizeof(T));
    __pipeline_memcpy_async(&s_st[9][tid], gp.eq + k * sE + ec, sizeof(T));
    __pipeline_memcpy_async(&s_st[10][tid], gp.yield + k * sE + ec, sizeof(T));
    if (k < 6)
      __pipeline_memcpy_async(&s_st[11][tid], gp.strain + k * sE + ec,
                              sizeof(T));
    __pipeline_commit();
  };
  Hardening<T> tab = hard;
  if (staged) {
    T* ts = reinterpret_cast<T*>(s_tab);
    T* tl = ts + hard.M * hard.W;
    int32_t* tn = reinterpret_cast<int32_t*>(tl + hard.M * (hard.W - 1));
    for (int i = tid; i < hard.M * hard.W; i += kThreads)
      ts[i] = hard.strain[i];
    for (int i = tid; i < hard.M * (hard.W - 1); i += kThreads)
      tl[i] = hard.slope[i];
    for (int i = tid; i < hard.M; i += kThreads) tn[i] = hard.n[i];
    tab.strain = ts;
    tab.slope = tl;
    tab.n = tn;
  }

  stage(blockIdx.x);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
  const int64_t e = (int64_t)tile * kTE + x;
  const bool live = e < E;
  const int64_t ec = live ? e : (int64_t)E - 1;
  __pipeline_wait_prior(0);
  const int32_t n = s_id[0][tid];
  const int32_t n0 = s_id[1][tid];
  T xe[3];
  if (!GENERIC) {
#pragma unroll
    for (int b = 0; b < 3; ++b) xe[b] = s_st[b][tid];
  }
  T sig0[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) sig0[c] = s_st[3 + c][tid];
  const T eq = s_st[9][tid];
  const T ys = s_st[10][tid];
  const T strain0 = k < 6 ? s_st[11][tid] : T(0);
  const T Ge = G_e[ec], le = lam_e[ec];
  const int m = mat[ec];
  const bool hp = hasp[ec] != 0;
  const bool alive = flag[ec] != 0;
  if (tile + (int)gridDim.x < n_tiles) stage(tile + gridDim.x);

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
}

// diagnostic, not an element update: the shipped kernel's loads, gather
// and stores with a token of its arithmetic, so its time is the floor that
// the kernel's memory traffic alone sets
template <typename K, typename T, bool GENERIC, bool TRIAX, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
element_kernel_mem(const int32_t* __restrict__ elem,
                   const T* __restrict__ coord_e, const K* __restrict__ disp,
                   const K* __restrict__ dprev, const StateIn<T> gp,
                   const T* __restrict__ G_e, const T* __restrict__ lam_e,
                   const int32_t* __restrict__ mat,
                   const uint8_t* __restrict__ hasp,
                   const uint8_t* __restrict__ flag, const Hardening<T> hard,
                   bool staged, int E, int N, const StateOut<T> gpo,
                   T* __restrict__ qe, T* __restrict__ triax,
                   int32_t*) {                            // neg: unused
  __shared__ T s_kin[48][kTE];
  const int x = threadIdx.x, k = threadIdx.y;
  const int64_t e = (int64_t)blockIdx.x * kTE + x;
  const bool live = e < E;
  const int64_t ec = live ? e : (int64_t)E - 1;
  const int64_t sE = E;
  const int32_t n = elem[k * sE + ec], n0 = elem[ec];
  T xe[3] = {T(0), T(0), T(0)};
  if (!GENERIC)
    for (int b = 0; b < 3; ++b) xe[b] = coord_e[(b * 8 + k) * sE + ec];
  T sig0[6];
  for (int c = 0; c < 6; ++c) sig0[c] = gp.stress[(c * 8 + k) * sE + ec];
  const T eq = gp.eq[k * sE + ec], ys = gp.yield[k * sE + ec];
  const T strain0 = k < 6 ? gp.strain[k * sE + ec] : T(0);
  const T Ge = G_e[ec] + lam_e[ec] + T(mat[ec]) + T(hasp[ec]);
  const bool alive = flag[ec] != 0;
  for (int b = 0; b < 3; ++b) {
    const K d = disp[b * (int64_t)N + n], pv = dprev[b * (int64_t)N + n],
            d0 = disp[b * (int64_t)N + n0];
    s_kin[24 + b * 8 + k][x] = T(d - pv);
    s_kin[b * 8 + k][x] = xe[b] + T(d - d0);
  }
  __syncthreads();
  T a = T(0);
  for (int r = 0; r < 48; ++r) a += s_kin[r][x];
  if (!live) return;
  for (int c = 0; c < 6; ++c) gpo.stress[(c * 8 + k) * sE + e] = sig0[c] + a;
  gpo.eq[k * sE + e] = eq + Ge;
  gpo.yield[k * sE + e] = ys + a;
  if (TRIAX) triax[k * sE + e] = a;
  if (k < 6) gpo.strain[k * sE + e] = strain0 + a;
  else if (gpo.pad != nullptr) gpo.pad[(k - 6) * sE + e] = T(0);
  for (int b = 0; b < 3; ++b) qe[(b * 8 + k) * sE + e] = alive ? a : T(0);
}

}  // namespace el

namespace as {
#include "../hakai_tpu_torch/csrc/assemble.cu"
}  // namespace as

// ---------------------------------------------------------------------------
// host side: the bench bar's mesh and states, timing, the report
// ---------------------------------------------------------------------------

#define CK(x)                                                              \
  do {                                                                     \
    cudaError_t err_ = (x);                                                \
    if (err_ != cudaSuccess) {                                             \
      fprintf(stderr, "%s:%d %s: %s\n", __FILE__, __LINE__, #x,            \
              cudaGetErrorString(err_));                                   \
      exit(1);                                                             \
    }                                                                      \
  } while (0)

struct Rng {   // xorshift64*, Box-Muller
  uint64_t s;
  double uniform() {
    s ^= s >> 12; s ^= s << 25; s ^= s >> 27;
    return ((s * 2685821657736338717ull) >> 11) * (1.0 / 9007199254740992.0);
  }
  double normal() {
    const double u = uniform() + 1e-300, v = uniform();
    return sqrt(-2.0 * log(u)) * cos(6.283185307179586 * v);
  }
};

// The bench bar: nx x ny x nz hex8 elements over lx x ly x lz, nodes in
// natural order, N padded to a multiple of 128 as the lowering pads it;
// the incidence table lists each node's (slot, element) entries by element.
struct Mesh {
  int E, N, V;
  std::vector<int32_t> elem;       // (8, E)
  std::vector<double> coord_e;     // (24, E), node-0-centred
  std::vector<double> coord;       // (3, N)
  std::vector<int32_t> inc_idx;    // (V, N) into 8E
  std::vector<uint8_t> inc_mask;   // (V, N)
};

Mesh bar(int nx, int ny, int nz, double lx, double ly, double lz) {
  Mesh m;
  const int n_nodes = (nx + 1) * (ny + 1) * (nz + 1);
  m.E = nx * ny * nz;
  m.N = (n_nodes + 127) / 128 * 128;
  m.coord.assign(3 * (size_t)m.N, 0.0);
  auto nid = [&](int i, int j, int k) { return i + (nx + 1) * (j + (ny + 1) * k); };
  for (int k = 0; k <= nz; ++k)
    for (int j = 0; j <= ny; ++j)
      for (int i = 0; i <= nx; ++i) {
        const int n = nid(i, j, k);
        m.coord[n] = lx * i / nx;
        m.coord[m.N + n] = ly * j / ny;
        m.coord[2 * (size_t)m.N + n] = lz * k / nz;
      }
  const int di[8] = {0, 1, 1, 0, 0, 1, 1, 0}, dj[8] = {0, 0, 1, 1, 0, 0, 1, 1},
            dk[8] = {0, 0, 0, 0, 1, 1, 1, 1};
  m.elem.resize(8 * (size_t)m.E);
  m.coord_e.resize(24 * (size_t)m.E);
  std::vector<std::vector<int32_t>> inc(m.N);
  for (int k = 0; k < nz; ++k)
    for (int j = 0; j < ny; ++j)
      for (int i = 0; i < nx; ++i) {
        const int e = i + nx * (j + ny * k);
        for (int a = 0; a < 8; ++a) {
          const int n = nid(i + di[a], j + dj[a], k + dk[a]);
          m.elem[(size_t)a * m.E + e] = n;
          inc[n].push_back(a * m.E + e);
        }
      }
  for (int e = 0; e < m.E; ++e)
    for (int b = 0; b < 3; ++b)
      for (int a = 0; a < 8; ++a)
        m.coord_e[(size_t)(b * 8 + a) * m.E + e] =
            m.coord[(size_t)b * m.N + m.elem[(size_t)a * m.E + e]] -
            m.coord[(size_t)b * m.N + m.elem[e]];
  m.V = 0;
  for (auto& l : inc) m.V = std::max(m.V, (int)l.size());
  m.inc_idx.assign((size_t)m.V * m.N, 0);
  m.inc_mask.assign((size_t)m.V * m.N, 0);
  for (int n = 0; n < m.N; ++n) {
    std::sort(inc[n].begin(), inc[n].end(),
              [&](int32_t p, int32_t q) { return p % m.E < q % m.E; });
    for (size_t v = 0; v < inc[n].size(); ++v) {
      m.inc_idx[v * m.N + n] = inc[n][v];
      m.inc_mask[v * m.N + n] = 1;
    }
  }
  return m;
}

template <typename T> T* dev(const std::vector<T>& h) {
  T* d;
  CK(cudaMalloc(&d, h.size() * sizeof(T) + 16));
  CK(cudaMemcpy(d, h.data(), h.size() * sizeof(T), cudaMemcpyHostToDevice));
  return d;
}
template <typename T, typename S> T* dev_as(const std::vector<S>& h) {
  std::vector<T> c(h.begin(), h.end());
  return dev(c);
}
template <typename T> T* dev_zeros(size_t n) {
  T* d;
  CK(cudaMalloc(&d, n * sizeof(T) + 16));
  CK(cudaMemset(d, 0, n * sizeof(T) + 16));
  return d;
}
template <typename T> std::vector<T> host(const T* d, size_t n) {
  std::vector<T> h(n);
  CK(cudaMemcpy(h.data(), d, n * sizeof(T), cudaMemcpyDeviceToHost));
  return h;
}

uint8_t* g_flush;   // 256 MB: written before each timed call (cold L2)
const size_t kFlush = 256u << 20;

// Median over 5 batches of the mean device time of one call (CUDA events
// around each call, a 256 MB memset before it), as chip_smoke.py times.
template <class F> double time_ms(F launch) {
  const int reps = 20;
  cudaEvent_t a[reps], b[reps];
  for (int i = 0; i < reps; ++i) {
    CK(cudaEventCreate(&a[i]));
    CK(cudaEventCreate(&b[i]));
  }
  for (int w = 0; w < 3; ++w) launch();
  CK(cudaDeviceSynchronize());
  std::vector<double> means;
  for (int r = 0; r < 5; ++r) {
    for (int i = 0; i < reps; ++i) {
      CK(cudaMemsetAsync(g_flush, r + i, kFlush));
      CK(cudaEventRecord(a[i]));
      launch();
      CK(cudaEventRecord(b[i]));
    }
    CK(cudaDeviceSynchronize());
    double s = 0;
    for (int i = 0; i < reps; ++i) {
      float t;
      CK(cudaEventElapsedTime(&t, a[i], b[i]));
      s += t;
    }
    means.push_back(s / reps);
  }
  CK(cudaGetLastError());
  for (int i = 0; i < reps; ++i) {
    cudaEventDestroy(a[i]);
    cudaEventDestroy(b[i]);
  }
  std::sort(means.begin(), means.end());
  return means[2];
}

template <class K> void kernel_resources(K kernel, int threads, int smem,
                                  char* buf) {
  cudaFuncAttributes fa;
  CK(cudaFuncGetAttributes(&fa, kernel));
  int blocks = 0;
  CK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                   smem));
  snprintf(buf, 160, "%3d regs, %5zu B smem + %4d dyn, %3zu B local, "
           "%d blocks/SM", fa.numRegs, fa.sharedSizeBytes, smem,
           fa.localSizeBytes, blocks);
}

const double kHBM = 3.35e12;   // bytes/s, the card's nominal rate

void report(const char* what, const char* variant, const char* res,
            double ms, double bound_ms, const char* bits) {
  printf("%-26s %-22s %s  %.4f ms  %.3f of bound (%.4f ms)  %s\n", what,
         variant, res, ms, bound_ms / ms, bound_ms, bits);
  fflush(stdout);
}

// ---------------------------------------------------------------------------
// element kernel
// ---------------------------------------------------------------------------

template <typename K, typename T> struct ElementCase {
  const Mesh& m;
  bool generic, triax;
  int32_t *elem, *mat, *hard_n;
  T *coord_e, *P, *G, *lam, *hard_strain, *hard_slope;
  K *a, *b;
  uint8_t *hasp, *flag;
  T *P_out, *qe, *tri;
  int M = 1, W = 8;
  double bytes;

  ElementCase(const Mesh& mesh, Rng& rng, bool gen, bool tx)
      : m(mesh), generic(gen), triax(tx) {
    const int E = m.E, N = m.N;
    std::vector<double> disp(3 * (size_t)N), dprev(3 * (size_t)N);
    for (size_t i = 0; i < disp.size(); ++i) {
      disp[i] = 1e-3 * rng.normal();
      dprev[i] = disp[i] + 2e-4 * rng.normal();
    }
    std::vector<double> Ph(72 * (size_t)E);
    for (size_t i = 0; i < 48 * (size_t)E; ++i) Ph[i] = 300.0 * rng.normal();
    for (size_t i = 48 * (size_t)E; i < 54 * (size_t)E; ++i)
      Ph[i] = 1e-3 * rng.normal();
    for (size_t i = 56 * (size_t)E; i < 64 * (size_t)E; ++i)
      Ph[i] = 0.3 * rng.uniform();
    for (size_t i = 64 * (size_t)E; i < 72 * (size_t)E; ++i)
      Ph[i] = 755.0 + 300.0 * rng.uniform();
    std::vector<uint8_t> fl(E, 1), hp(E, 1);
    fl[3] = 0;
    for (int e = E - 128; e < E; ++e) fl[e] = 0;
    const double hs[8] = {0.0, 0.01, 0.02, 0.1, 0.15, 0.4, 1.0, 4.0};
    const double hy[8] = {755, 809, 829, 842, 895, 922, 953, 1100};
    std::vector<double> vs(hs, hs + 8), sl(7);
    for (int j = 0; j < 7; ++j) sl[j] = (hy[j + 1] - hy[j]) / (hs[j + 1] - hs[j]);
    const double young = 210000.0, nu = 0.3;
    elem = dev(m.elem);
    mat = dev(std::vector<int32_t>(E, 0));
    hard_n = dev(std::vector<int32_t>{8});
    coord_e = dev_as<T>(m.coord_e);
    P = dev_as<T>(Ph);
    G = dev_as<T>(std::vector<double>(E, young / (2 * (1 + nu))));
    lam = dev_as<T>(std::vector<double>(E, young * nu / ((1 + nu) * (1 - 2 * nu))));
    hard_strain = dev_as<T>(vs);
    hard_slope = dev_as<T>(sl);
    if (generic) {   // position = coord + disp and d_disp, in T
      std::vector<double> pos(3 * (size_t)N), dd(3 * (size_t)N);
      for (size_t i = 0; i < pos.size(); ++i) {
        pos[i] = (double)(T)(m.coord[i] + disp[i]);
        dd[i] = (double)(T)(disp[i] - dprev[i]);
      }
      a = dev_as<K>(pos);
      b = dev_as<K>(dd);
    } else {
      a = dev_as<K>(disp);
      b = dev_as<K>(dprev);
    }
    hasp = dev(hp);
    flag = dev(fl);
    P_out = dev_zeros<T>(72 * (size_t)E);
    qe = dev_zeros<T>(24 * (size_t)E);
    tri = triax ? dev_zeros<T>(8 * (size_t)E) : nullptr;
    // each input read once, each output written once
    bytes = 8.0 * E * 4 + (generic ? 0 : 24.0 * E * sizeof(T)) +
            6.0 * N * sizeof(K) + 72.0 * E * sizeof(T) * 2 +
            2.0 * E * sizeof(T) + 4.0 * E + 2.0 * E + 24.0 * E * sizeof(T) +
            (triax ? 8.0 * E * sizeof(T) : 0.0);
  }
  el::StateIn<T> in() const { return el::packed_in<T>(P, m.E); }
  el::StateOut<T> out() const {
    el::StateOut<T> o = el::packed_out<T>(P_out, m.E);
    if (generic) o.pad = nullptr;
    return o;
  }
  std::vector<T> result() const {
    std::vector<T> r = host(P_out, 72 * (size_t)m.E), q = host(qe, 24 * (size_t)m.E);
    if (generic) std::fill(r.begin() + 54 * (size_t)m.E, r.begin() + 56 * (size_t)m.E, T(0));
    r.insert(r.end(), q.begin(), q.end());
    if (triax) {
      std::vector<T> t = host(tri, 8 * (size_t)m.E);
      r.insert(r.end(), t.begin(), t.end());
    }
    return r;
  }
  void clear() const {
    CK(cudaMemset(P_out, 0, 72 * (size_t)m.E * sizeof(T)));
    CK(cudaMemset(qe, 0, 24 * (size_t)m.E * sizeof(T)));
  }
};

// design D: 0 the shipped kernel, 1 candidate C1, 2 candidate C2
template <int D, typename K, typename T, bool GENERIC, bool TRIAX, int MINB>
struct Design {
  static auto kernel() {
    if constexpr (D == 0) return el::element_kernel<K, T, GENERIC, TRIAX, MINB>;
    else if constexpr (D == 2) return el::element_kernel_c2<K, T, GENERIC, TRIAX, MINB>;
    else if constexpr (D == 6) return el::element_kernel_mem<K, T, GENERIC, TRIAX, MINB>;
    else if constexpr (D == 7) return el::element_kernel_c6<K, T, GENERIC, TRIAX, MINB>;
    else return el::element_kernel_alt<K, T, GENERIC, TRIAX, MINB, D>;
  }
  static constexpr int threads = D == 2 ? 128 : 256;
  static void launch(const ElementCase<K, T>& c, bool stage) {
    const int smem = stage ? el::table_bytes<T>(c.M, c.W) : 0;
    int grid = (c.m.E + 31) / 32;
    if (D == 7) {   // persistent: the blocks that fit at once
      int per = 0, sms = 0;
      CK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel(),
                                                       threads, smem));
      CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
      grid = std::min(grid, per * sms);
    }
    kernel()<<<grid, dim3(32, threads / 32), smem>>>(
        c.elem, c.coord_e, c.a, c.b, c.in(), c.G, c.lam, c.mat, c.hasp,
        c.flag, el::Hardening<T>{c.hard_strain, c.hard_slope, c.hard_n,
                                 c.M, c.W},
        smem > 0, c.m.E, c.m.N, c.out(), c.qe, c.tri, nullptr);
  }
};

template <int D, typename K, typename T, bool GENERIC, bool TRIAX, int MINB>
void run_new(const ElementCase<K, T>& c, const char* what, double bound,
             const std::vector<T>& ref, bool stage = true) {
  using Dz = Design<D, K, T, GENERIC, TRIAX, MINB>;
  char res[160], name[40];
  const int smem = stage ? el::table_bytes<T>(c.M, c.W) : 0;
  kernel_resources(Dz::kernel(), Dz::threads, smem, res);
  c.clear();
  Dz::launch(c, stage);
  CK(cudaDeviceSynchronize());
  const bool same = c.result() == ref;
  const double ms = time_ms([&] { Dz::launch(c, stage); });
  const char* dn[8] = {"hoisted", "C1 fold terms", "C2 two points",
                       "C3 constant operands", "C4 nodal prefetch",
                       "C5 evict-first state", "diagnostic: memory only",
                       "C6 persistent, cp.async"};
  snprintf(name, 40, "%s, min %d%s", dn[D], MINB, stage ? "" : ", no stage");
  report(what, name, res, ms, bound, same ? "bitwise first" : "DIFFERS");
}

template <typename K, typename T, bool GENERIC, bool TRIAX>
void element_variants(const Mesh& m, Rng& rng, const char* what) {
  ElementCase<K, T> c(m, rng, GENERIC, TRIAX);
  const double bound = c.bytes / kHBM * 1e3;
  char res[160];
  kernel_resources(el::first_element_kernel<K, T, GENERIC, TRIAX>, 256, 0, res);
  c.clear();
  el::first_element_kernel<K, T, GENERIC, TRIAX>
      <<<(c.m.E + 31) / 32, dim3(32, 8)>>>(
          c.elem, c.coord_e, c.a, c.b, c.in(), c.G, c.lam, c.mat, c.hasp,
          c.flag, c.hard_strain, c.hard_slope, c.hard_n, c.W, c.m.E, c.m.N,
          c.out(), c.qe, c.tri);
  CK(cudaDeviceSynchronize());
  const std::vector<T> ref = c.result();
  const double ms = time_ms([&] {
    el::first_element_kernel<K, T, GENERIC, TRIAX>
        <<<(c.m.E + 31) / 32, dim3(32, 8)>>>(
            c.elem, c.coord_e, c.a, c.b, c.in(), c.G, c.lam, c.mat, c.hasp,
            c.flag, c.hard_strain, c.hard_slope, c.hard_n, c.W, c.m.E,
            c.m.N, c.out(), c.qe, c.tri);
  });
  report(what, "first design", res, ms, bound, "");
  if constexpr (sizeof(T) == 4) {
    run_new<0, K, T, GENERIC, TRIAX, 4>(c, what, bound, ref);
    run_new<0, K, T, GENERIC, TRIAX, 3>(c, what, bound, ref);
    run_new<0, K, T, GENERIC, TRIAX, 5>(c, what, bound, ref);
    run_new<0, K, T, GENERIC, TRIAX, 4>(c, what, bound, ref, false);
    run_new<1, K, T, GENERIC, TRIAX, 4>(c, what, bound, ref);
    run_new<2, K, T, GENERIC, TRIAX, 5>(c, what, bound, ref);
    run_new<3, K, T, GENERIC, TRIAX, 4>(c, what, bound, ref);
    run_new<4, K, T, GENERIC, TRIAX, 4>(c, what, bound, ref);
    run_new<5, K, T, GENERIC, TRIAX, 4>(c, what, bound, ref);
    run_new<7, K, T, GENERIC, TRIAX, 4>(c, what, bound, ref);
    run_new<6, K, T, GENERIC, TRIAX, 4>(c, what, bound, ref);
  } else {   // C1's and C6's buffers do not fit 48 KB of static shared in f64
    run_new<0, K, T, GENERIC, TRIAX, 2>(c, what, bound, ref);
    run_new<0, K, T, GENERIC, TRIAX, 3>(c, what, bound, ref);
    run_new<0, K, T, GENERIC, TRIAX, 2>(c, what, bound, ref, false);
    run_new<2, K, T, GENERIC, TRIAX, 3>(c, what, bound, ref);
    run_new<3, K, T, GENERIC, TRIAX, 2>(c, what, bound, ref);
    run_new<4, K, T, GENERIC, TRIAX, 2>(c, what, bound, ref);
    run_new<5, K, T, GENERIC, TRIAX, 2>(c, what, bound, ref);
    run_new<6, K, T, GENERIC, TRIAX, 2>(c, what, bound, ref);
  }
}

// ---------------------------------------------------------------------------
// assembly kernel B: the first design and the variants not shipped
// ---------------------------------------------------------------------------

// the first design: a runtime slot loop, mask -> branch -> index -> source
template <typename T, typename O>
__global__ void __launch_bounds__(256)
asm_first(const T* __restrict__ src, const int32_t* __restrict__ idx,
          const uint8_t* __restrict__ mask, int V, int64_t S, int64_t N,
          O* __restrict__ out) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  T acc[3] = {T(0), T(0), T(0)};
  for (int v = 0; v < V; ++v) {
    const int64_t o = v * N + j;
    if (mask[o]) {
      const int64_t s = idx[o];
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[c] += src[c * S + s];
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c * N + j] = O(acc[c]);
}

// V a compile-time constant as shipped, but plain index and mask loads
// (CS: evict-first ones, as shipped); BLOCK threads a block,
// __launch_bounds__(BLOCK, MINB); PF: first, the grid's threads ask L2 to
// prefetch the whole (3, S) source, a 128-byte line a thread in turn, so
// the source streams in while the table's loads are in flight
template <typename T, typename O, int V, int BLOCK = 256, int MINB = 1,
          bool CS = false, bool PF = false>
__global__ void __launch_bounds__(BLOCK, MINB)
asm_fixed(const T* __restrict__ src, const int32_t* __restrict__ idx,
          const uint8_t* __restrict__ mask, int64_t S, int64_t N,
          O* __restrict__ out) {
  const int64_t j = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  if (PF) {
    const int64_t lines = (3 * S * (int64_t)sizeof(T) + 127) / 128;
    const char* base = reinterpret_cast<const char*>(src);
    for (int64_t l = j; l < lines; l += (int64_t)gridDim.x * BLOCK)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(base + 128 * l));
  }
  if (j >= N) return;
  bool m[V];
  int32_t s[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    m[u] = CS ? __ldcs(mask + u * N + j) : mask[u * N + j];
    s[u] = CS ? __ldcs(idx + u * N + j) : idx[u * N + j];
  }
  T val[V][3];
#pragma unroll
  for (int u = 0; u < V; ++u)
#pragma unroll
    for (int c = 0; c < 3; ++c) val[u][c] = m[u] ? src[c * S + s[u]] : T(0);
  T acc[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int u = 0; u < V; ++u)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      if (m[u]) acc[c] += val[u][c];
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c * N + j] = O(acc[c]);
}

// diagnostic, not an assembly: the first wave alone (the V masks and
// indices of a column, evict-first) and a store of what it read, so its
// time is the floor under any design that must read the table first
template <typename O>
__global__ void __launch_bounds__(256)
asm_wave1(const int32_t* __restrict__ idx, const uint8_t* __restrict__ mask,
          int64_t N, O* __restrict__ out) {
  const int64_t j = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (j >= N) return;
  int32_t acc = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u)
    acc += __ldcs(mask + u * N + j) ? __ldcs(idx + u * N + j) : 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c * N + j] = O(acc + c);
}

// NPT nodes a thread (j, j + 256, ...), V <= 8, both waves for all of them
template <typename T, typename O, int NPT>
__global__ void __launch_bounds__(256)
asm_multi(const T* __restrict__ src, const int32_t* __restrict__ idx,
          const uint8_t* __restrict__ mask, int V, int64_t S, int64_t N,
          O* __restrict__ out) {
  const int64_t j0 = (int64_t)blockIdx.x * 256 * NPT + threadIdx.x;
  bool m[NPT][8];
  int32_t s[NPT][8];
#pragma unroll
  for (int p = 0; p < NPT; ++p)
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int64_t j = j0 + p * 256;
      const bool in = u < V && j < N;
      m[p][u] = in && mask[u * N + j];
      s[p][u] = in ? idx[u * N + j] : 0;
    }
  T val[NPT][8][3];
#pragma unroll
  for (int p = 0; p < NPT; ++p)
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        val[p][u][c] = m[p][u] ? src[c * S + s[p][u]] : T(0);
#pragma unroll
  for (int p = 0; p < NPT; ++p) {
    const int64_t j = j0 + p * 256;
    if (j >= N) continue;
    T acc[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (m[p][u]) acc[c] += val[p][u][c];
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c * N + j] = O(acc[c]);
  }
}

// W consecutive nodes a thread through one W-wide index and mask load a
// slot (N a multiple of W), V <= 8, BLOCK threads a block
template <int W> struct Vec;
template <> struct Vec<2> { using I = int2; using M = uchar2; };
template <> struct Vec<4> { using I = int4; using M = uchar4; };

template <typename T, typename O, int W, int BLOCK>
__global__ void __launch_bounds__(BLOCK)
asm_vec(const T* __restrict__ src, const int32_t* __restrict__ idx,
        const uint8_t* __restrict__ mask, int V, int64_t S, int64_t N,
        O* __restrict__ out) {
  using I = typename Vec<W>::I;
  using M = typename Vec<W>::M;
  const int64_t q = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  const int64_t NW = N / W;
  if (q >= NW) return;
  int32_t s[8][W];
  uint8_t m[8][W];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    I iv{};
    M mv{};
    if (u < V) {
      iv = reinterpret_cast<const I*>(idx)[u * NW + q];
      mv = reinterpret_cast<const M*>(mask)[u * NW + q];
    }
    memcpy(s[u], &iv, sizeof(iv));
    memcpy(m[u], &mv, sizeof(mv));
  }
  T acc[W][3];
#pragma unroll
  for (int r = 0; r < W; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[r][c] = T(0);
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int r = 0; r < W; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T v = m[u][r] ? src[c * S + s[u][r]] : T(0);
        if (m[u][r]) acc[r][c] += v;
      }
#pragma unroll
  for (int r = 0; r < W; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c * N + W * q + r] = O(acc[r][c]);
}

template <typename T, typename O>
void assembly_variants(const Mesh& m, Rng& rng, const char* what) {
  const int E = m.E, N = m.N, V = m.V;
  const int64_t S = 8 * (int64_t)E;
  std::vector<double> qh(24 * (size_t)E);
  for (auto& x : qh) x = 100.0 * rng.normal();
  const T* src = dev_as<T>(qh);
  const int32_t* idx = dev(m.inc_idx);
  const uint8_t* mask = dev(m.inc_mask);
  O* out = dev_zeros<O>(3 * (size_t)N);
  const double bound = (24.0 * E * sizeof(T) + 5.0 * V * N +
                        3.0 * N * sizeof(O)) / kHBM * 1e3;
  const int grid = (N + 255) / 256;
  char res[160];
  auto result = [&] {
    CK(cudaDeviceSynchronize());
    return host(out, 3 * (size_t)N);
  };
  auto clear = [&] { CK(cudaMemset(out, 0, 3 * (size_t)N * sizeof(O))); };

  kernel_resources(asm_first<T, O>, 256, 0, res);
  asm_first<T, O><<<grid, 256>>>(src, idx, mask, V, S, N, out);
  const std::vector<O> ref = result();
  report(what, "first design", res,
         time_ms([&] { asm_first<T, O><<<grid, 256>>>(src, idx, mask, V, S, N, out); }),
         bound, "");

  auto check = [&](const char* name, const char* r, auto launch) {
    clear();
    launch();
    const bool same = result() == ref;
    report(what, name, r, time_ms(launch), bound,
           same ? "bitwise first" : "DIFFERS");
  };
  kernel_resources(as::assemble_kernel<T, O, 3, 8, as::NodeMajor>, 256, 0, res);
  check("shipped, V = 8", res, [&] {
    as::assemble_kernel<T, O, 3, 8, as::NodeMajor><<<grid, 256>>>(
        src, idx, mask, V, S, N, as::NodeMajor{N}, out);
  });
  kernel_resources(as::assemble_kernel<T, O, 3, 0, as::NodeMajor>, 256, 0, res);
  check("shipped, 8-slot chunks", res, [&] {
    as::assemble_kernel<T, O, 3, 0, as::NodeMajor><<<grid, 256>>>(
        src, idx, mask, V, S, N, as::NodeMajor{N}, out);
  });
  if (V == 8) {
    kernel_resources(asm_fixed<T, O, 8>, 256, 0, res);
    check("V = 8, no __ldcs", res, [&] {
      asm_fixed<T, O, 8><<<grid, 256>>>(src, idx, mask, S, N, out);
    });
    kernel_resources(asm_fixed<T, O, 8, 256, 1, true, true>, 256, 0, res);
    check("V = 8, source prefetched to L2", res, [&] {
      asm_fixed<T, O, 8, 256, 1, true, true><<<grid, 256>>>(src, idx, mask, S, N, out);
    });
    kernel_resources(asm_fixed<T, O, 8, 256, 6>, 256, 0, res);
    check("V = 8, no __ldcs, min 6", res, [&] {
      asm_fixed<T, O, 8, 256, 6><<<grid, 256>>>(src, idx, mask, S, N, out);
    });
    kernel_resources(asm_fixed<T, O, 8, 128>, 128, 0, res);
    check("V = 8, no __ldcs, 128", res, [&] {
      asm_fixed<T, O, 8, 128><<<(N + 127) / 128, 128>>>(src, idx, mask, S, N, out);
    });
    kernel_resources(asm_fixed<T, O, 8, 512>, 512, 0, res);
    check("V = 8, no __ldcs, 512", res, [&] {
      asm_fixed<T, O, 8, 512><<<(N + 511) / 512, 512>>>(src, idx, mask, S, N, out);
    });
  }
  kernel_resources(asm_multi<T, O, 2>, 256, 0, res);
  check("2 nodes a thread", res, [&] {
    asm_multi<T, O, 2><<<(N + 511) / 512, 256>>>(src, idx, mask, V, S, N, out);
  });
  kernel_resources(asm_multi<T, O, 4>, 256, 0, res);
  check("4 nodes a thread", res, [&] {
    asm_multi<T, O, 4><<<(N + 1023) / 1024, 256>>>(src, idx, mask, V, S, N, out);
  });
  if (V == 8) {
    kernel_resources(asm_wave1<O>, 256, 0, res);
    const double ms = time_ms([&] {
      asm_wave1<O><<<grid, 256>>>(idx, mask, N, out);
    });
    report(what, "diagnostic: wave 1 only", res, ms,
           (5.0 * V * N + 3.0 * N * sizeof(O)) / kHBM * 1e3, "");
  }
  auto vec = [&](auto kernel, int w, int block, const char* name) {
    kernel_resources(kernel, block, 0, res);
    check(name, res, [&] {
      kernel<<<(N / w + block - 1) / block, block>>>(src, idx, mask, V, S, N,
                                                     out);
    });
  };
  vec(asm_vec<T, O, 2, 128>, 2, 128, "2 nodes, 8-byte loads, 128");
  vec(asm_vec<T, O, 2, 256>, 2, 256, "2 nodes, 8-byte loads, 256");
  vec(asm_vec<T, O, 4, 64>, 4, 64, "4 nodes, 16-byte loads, 64");
  vec(asm_vec<T, O, 4, 128>, 4, 128, "4 nodes, 16-byte loads, 128");
}

int main() {
  cudaDeviceProp prop;
  CK(cudaGetDeviceProperties(&prop, 0));
  printf("device: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  CK(cudaMalloc(&g_flush, kFlush));
  // the (8, 3, 8) shape-gradient table of csrc/element.cu
  const double g = 1.0 / sqrt(3.0);
  const int dl[8][3] = {{-1, -1, -1}, {1, -1, -1}, {1, 1, -1}, {-1, 1, -1},
                        {-1, -1, 1},  {1, -1, 1},  {1, 1, 1},  {-1, 1, 1}};
  const int gc[8][3] = {{-1, -1, -1}, {-1, -1, 1}, {-1, 1, -1}, {-1, 1, 1},
                        {1, -1, -1},  {1, -1, 1},  {1, 1, -1},  {1, 1, 1}};
  double pus[8 * 3 * 8];
  for (int k = 0; k < 8; ++k)
    for (int i = 0; i < 8; ++i) {
      const double z = gc[k][0] * g, e = gc[k][1] * g, t = gc[k][2] * g;
      const int d1 = dl[i][0], d2 = dl[i][1], d3 = dl[i][2];
      pus[(k * 3 + 0) * 8 + i] = 0.125 * d1 * (1 + e * d2) * (1 + t * d3);
      pus[(k * 3 + 1) * 8 + i] = 0.125 * d2 * (1 + z * d1) * (1 + t * d3);
      pus[(k * 3 + 2) * 8 + i] = 0.125 * d3 * (1 + z * d1) * (1 + e * d2);
    }
  CK((cudaError_t)el::hk_set_pusai(pus));
  const Mesh m = bar(32, 32, 128, 10.0, 10.0, 50.0);
  printf("bench bar: E = %d, N = %d, V = %d\n", m.E, m.N, m.V);
  Rng rng{20261016};
  element_variants<float, float, false, false>(m, rng, "element f32 packed");
  element_variants<double, float, false, true>(m, rng, "element mixed+triax");
  element_variants<float, float, true, false>(m, rng, "element f32 unpacked");
  element_variants<double, double, false, false>(m, rng, "element f64 packed");
  element_variants<double, double, true, false>(m, rng, "element f64 unpacked");
  assembly_variants<float, float>(m, rng, "assembly f32");
  assembly_variants<float, double>(m, rng, "assembly f32->f64");
  assembly_variants<double, double>(m, rng, "assembly f64");
  CK(cudaGetLastError());
  printf("done\n");
  return 0;
}
