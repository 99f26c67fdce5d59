// The interleave probe: per tile, `builds` (8, 128) float32 values built
// from one (W, 8, 128) window and summed in build order.
//
// Replaces `kernel` of benchmarks/interleave_microbench.py:33 (its
// pallas_call at :62), the TPU probe of the fused-gather design's
// interleave primitive.  It computes what that kernel computes: for every
// tile, acc = v_0 + v_1 + ... + v_{builds-1} (float32 adds, from zero, in
// build order) written to rows 8 tile .. 8 tile + 7 of the (n_tiles * 8,
// 128) output, where build b of each mode is (off: eight row offsets, the
// TPU's SMEM scalars)
//   0 copy:      v = window[b % W]
//   1 stackrows: v[i, :] = window[off[i] + b % 16, i, :]
//   2 selrows:   the values of stackrows, built as a select cascade over
//                the eight candidate rows on the row index
//   3 gatherrow: v[i, :] = window[b % W, i, (7 i + b) % 128], one value of
//                the row broadcast along it.
// Only copies and float32 adds in the plain version's order, so the kernel
// is bit for bit its plain version (ops/interleave_cuda.interleave_plain).
//
// What bounds it on an H100: the output's bytes, n_tiles * 4 KB written
// (2 MB at the probe's 512 tiles, 0.63 us at 3.35 TB/s) beside the window
// read once (<= 256 KB), against n_tiles * builds * 1,024 float32 adds
// (31.5 M at 512 x 60: 0.47 us at 67 TFLOP/s).  What a build costs on the
// card is a read of the window held on chip: 126 MB of shared-memory
// reads at 512 x 60, ~4 us at 128 B a clock an SM, and only when a read
// instruction moves 16 bytes a thread (a warp's 4-byte reads issue at
// about half that rate, measured on an H100); and the window's
// way into every SM, 128 SMs x 240 KB through L2 for copy.
//
// Design.  A TPU vreg is not a block: on the card a build is a read of a
// window held in shared memory.  A block holds the `group` tiles an SM
// must take (at most kMaxGroup).  For copy, stackrows and gatherrow a
// thread sums four lanes of one row of a tile as a float4 (256 threads a
// tile), so each build is one 16-byte read and four adds (gatherrow's read
// is the row's one broadcast value, added to the four lanes).  For
// selrows a thread sums two lanes of all eight rows (64 threads a tile,
// the block's other threads only stage the window):
// it reads its lanes of the eight candidate rows once a build and forms
// each row's value with the cascade v = (row == k) ? x_k : v, the TPU's
// select on the sublane iota; the row of each of the thread's registers
// is known when the kernel is compiled, as a sublane's is in a vreg, so on
// the card the cascade leaves no instruction, and selrows reads what
// stackrows reads.  Every thread of the block stages the window
// into shared memory with cp.async, in groups of four slabs, each group
// completing on an mbarrier that every thread arrives on as its own
// copies land (cp.async.mbarrier.arrive), so the builds of a group start
// while later groups are in flight.  (TMA bulk copies issued by one
// thread, with or without a cluster's multicast, staged slower on an
// H100.)  The slabs a mode reads:
//   copy, gatherrow - 0 .. min(builds, W) - 1: the first kMaxSlabs (56) in
//                     shared memory; each thread holds its share of the
//                     next kRegSlabs (slabs 56-59 at the probe's 60 builds)
//                     in registers, loaded before the builds; slabs past
//                     64, or gatherrow's reads of slabs past 56 when the
//                     builds wrap around the window, read through L1/L2;
//   stackrows,      - 0 .. max(off) + min(builds, 16) - 1 (19 at the
//   selrows           probe's offsets), each build reading row i at the
//                     row's dynamic offset off[i] + b % 16.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kRows = 8;
constexpr int kLanes = 128;
constexpr int kSlab = kRows * kLanes;         // floats of one (8, 128) slab
constexpr int kQuads = kLanes / 4;            // float4 columns of a row
constexpr int kMaxSlabs = 56;                 // slabs in shared memory
constexpr int kRegSlabs = 8;                  // copy, gatherrow: in registers
constexpr int kMaxGroup = 4;                  // tiles a block holds at once
constexpr int kStageSlabs = 4;                // slabs a staging group
constexpr int kStageGroups = kMaxSlabs / kStageSlabs;
constexpr uint32_t kSlabBytes = kSlab * sizeof(float);

struct Params {
  const float* src;
  float* out;
  int W, builds, n_tiles;
  int off[kRows];         // row offsets (stackrows, selrows)
  int slabs;              // slabs the builds read: 0 .. slabs - 1
  int staged;             // of them in shared memory: 0 .. staged - 1
  int group;              // tiles a block holds at once
  int n_groups;
};

// threads a tile: a thread a (row, float4 of lanes); selrows' a float2 of
// lanes of all eight rows
template <int MODE>
__host__ __device__ constexpr int tile_threads() {
  return MODE == 2 ? kLanes / 2 : kRows * kQuads;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// 16 bytes global -> shared, asynchronously
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// `bar` counts this thread's arrival once its earlier copies have landed
__device__ __forceinline__ void arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

// a[k] for a uniform k < kRegSlabs, without indexing registers
template <typename V>
__device__ __forceinline__ V pick(const V (&a)[kRegSlabs], int k) {
  V v = a[0];
#pragma unroll
  for (int m = 1; m < kRegSlabs; ++m) v = k == m ? a[m] : v;
  return v;
}

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x = __fadd_rn(acc.x, v.x);
  acc.y = __fadd_rn(acc.y, v.y);
  acc.z = __fadd_rn(acc.z, v.z);
  acc.w = __fadd_rn(acc.w, v.w);
}

template <int MODE>
__global__ void __launch_bounds__(kMaxGroup * kRows * kQuads)
interleave_kernel(const Params p) {
  constexpr int R = MODE == 2 ? kRows : 1, kTile = tile_threads<MODE>();
  extern __shared__ __align__(128) float4 win[];       // staged x 256
  __shared__ __align__(8) uint64_t full[kStageGroups];
  const float* wf = reinterpret_cast<const float*>(win);
  const float4* src4 = reinterpret_cast<const float4*>(p.src);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n_iter = (p.n_groups - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int groups = (p.staged + kStageSlabs - 1) / kStageSlabs;
  if (tid == 0)
    for (int g = 0; g < groups; ++g) bar_init(&full[g], nt);
  __syncthreads();
  // group g: float4s [g, g + 1) x kStageSlabs x 256 of the window, dealt
  // round the block's threads; each thread arrives once a group
  for (int g = 0; g < groups; ++g) {
    const int lo = g * kStageSlabs * (kSlab / 4);
    const int hi = min(lo + kStageSlabs * (kSlab / 4),
                       p.staged * (kSlab / 4));
    for (int f = lo + tid; f < hi; f += nt) copy16(win + f, src4 + f);
    arrive_on_copies(&full[g]);
  }
  if (tid >= p.group * kTile) {           // selrows: staging only
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }
  const int t = tid % kTile, q = t % kQuads, r0 = MODE == 2 ? 0 : t / kQuads;
  int my_off = 0;                         // off[r0], without local memory
#pragma unroll
  for (int k = 0; k < kRows; ++k) my_off = r0 == k ? p.off[k] : my_off;
  // copy, gatherrow: this thread's share of slabs staged .. staged + 7
  float4 ex[kRegSlabs];
  float exg[kRegSlabs];
#pragma unroll
  for (int k = 0; k < kRegSlabs; ++k) {
    const int u = p.staged + k;
    const bool in = u < p.slabs;
    if (MODE == 0)
      ex[k] = in ? __ldg(src4 + (int64_t)u * (kSlab / 4) + r0 * kQuads + q)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    if (MODE == 3)      // build b = u's value (the first pass: b == u)
      exg[k] = in ? __ldg(p.src + ((int64_t)u * kRows + r0) * kLanes
                          + ((7 * r0 + u) & (kLanes - 1))) : 0.f;
  }
  for (int it = 0; it < n_iter; ++it) {
    const int tile = ((int)blockIdx.x + it * (int)gridDim.x) * p.group
                     + tid / kTile;
    if (tile >= p.n_tiles) continue;      // a warp's tile: warp-uniform
    float4 acc[MODE == 2 ? 1 : R];
    float2 acc2[MODE == 2 ? R : 1];
    acc[0] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < (MODE == 2 ? R : 1); ++r) acc2[r] = make_float2(0.f, 0.f);
    if (MODE == 0 || MODE == 3) {
      int u = 0;                          // b % W
      for (int b = 0; b < p.builds; ++b) {
        float4 v;
        float g;
        if (u < p.staged) {
          if (it == 0 && b < p.staged && u % kStageSlabs == 0)
            bar_wait(&full[u / kStageSlabs], 0);
          if (MODE == 0) v = win[(u * kRows + r0) * kQuads + q];
          else g = wf[(u * kRows + r0) * kLanes + ((7 * r0 + b) & 127)];
        } else if (u < p.staged + kRegSlabs && (MODE == 0 || b == u)) {
          if (MODE == 0) v = pick(ex, u - p.staged);
          else g = pick(exg, u - p.staged);
        } else if (MODE == 0) {
          v = __ldg(src4 + (int64_t)u * (kSlab / 4) + r0 * kQuads + q);
        } else {
          g = __ldg(p.src + ((int64_t)u * kRows + r0) * kLanes
                    + ((7 * r0 + b) & 127));
        }
        if (MODE == 3) v = make_float4(g, g, g, g);
        add4(acc[0], v);
        if (++u == p.W) u = 0;
      }
    } else {
      for (int b = 0; b < p.builds; ++b) {
        const int u = b & 15;
        if (MODE == 1) {
          const int s = my_off + u;       // the row's dynamic offset
          if (it == 0 && b < 16) bar_wait(&full[s / kStageSlabs], 0);
          add4(acc[0], win[(s * kRows + r0) * kQuads + q]);
        } else {
          const float2* win2 = reinterpret_cast<const float2*>(win);
          float2 x[kRows];                // candidate row k, lanes 2t, 2t+1
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            const int s = p.off[k] + u;
            if (it == 0 && b < 16) bar_wait(&full[s / kStageSlabs], 0);
            x[k] = win2[(s * kRows + k) * (kLanes / 2) + t];
          }
#pragma unroll
          for (int i = 0; i < R; ++i) {   // the select cascade on the row
            float2 v = make_float2(0.f, 0.f);
#pragma unroll
            for (int k = 0; k < kRows; ++k) v = i == k ? x[k] : v;
            acc2[i].x = __fadd_rn(acc2[i].x, v.x);
            acc2[i].y = __fadd_rn(acc2[i].y, v.y);
          }
        }
      }
    }
    const bool aligned = (reinterpret_cast<uintptr_t>(p.out) & 15) == 0;
    if (MODE == 2) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int64_t o = ((int64_t)tile * kRows + r) * kLanes + 2 * t;
        if (aligned) {
          *reinterpret_cast<float2*>(p.out + o) = acc2[r];
        } else {
          p.out[o] = acc2[r].x;
          p.out[o + 1] = acc2[r].y;
        }
      }
    } else {
      const int64_t o = ((int64_t)tile * kRows + r0) * kLanes + 4 * q;
      if (aligned) {
        *reinterpret_cast<float4*>(p.out + o) = acc[0];
      } else {
        p.out[o] = acc[0].x;
        p.out[o + 1] = acc[0].y;
        p.out[o + 2] = acc[0].z;
        p.out[o + 3] = acc[0].w;
      }
    }
  }
  // no thread leaves a copy in flight into the block's shared memory
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The launch of mode `mode` over n_tiles: its Params (pointers unset),
// grid and block; an error for a window that the design cannot hold.
cudaError_t plan(int W, int builds, int n_tiles, int mode, const int* off,
                 Params* p, int* grid, int* block) {
  memset(p, 0, sizeof(*p));
  p->W = W;
  p->builds = builds;
  p->n_tiles = n_tiles;
  int hi = 0;
  for (int k = 0; k < kRows; ++k) {
    p->off[k] = off[k];
    hi = off[k] > hi ? off[k] : hi;
  }
  if (mode == 1 || mode == 2) {
    p->slabs = builds > 0 ? hi + (builds < 16 ? builds : 16) : 0;
    if (p->slabs > kMaxSlabs) return cudaErrorInvalidValue;
  } else if (mode == 0 || mode == 3) {
    p->slabs = builds < W ? builds : W;
  } else {
    return cudaErrorInvalidValue;
  }
  p->staged = p->slabs < kMaxSlabs ? p->slabs : kMaxSlabs;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // the tiles an SM must take, held at once where they fit
  const int per = (n_tiles + sms - 1) / sms;
  p->group = per < kMaxGroup ? per : kMaxGroup;
  p->n_groups = (n_tiles + p->group - 1) / p->group;
  *grid = p->n_groups < sms ? p->n_groups : sms;
  *block = p->group * tile_threads<0>();
  return cudaSuccess;
}

template <int MODE>
cudaError_t launch(const Params& p, int grid, int block,
                   cudaStream_t stream) {
  const auto kernel = interleave_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kMaxSlabs * kSlabBytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, block, (size_t)p.staged * kSlabBytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t run(const float* src, int W, int builds, int n_tiles, int mode,
                const int* off, float* out, cudaStream_t stream) {
  if (n_tiles <= 0) return cudaSuccess;
  Params p;
  int grid = 0, block = 0;
  cudaError_t err = plan(W, builds, n_tiles, mode, off, &p, &grid, &block);
  if (err != cudaSuccess) return err;
  p.src = src;
  p.out = out;
  switch (mode) {
    case 0: return launch<0>(p, grid, block, stream);
    case 1: return launch<1>(p, grid, block, stream);
    case 2: return launch<2>(p, grid, block, stream);
    default: return launch<3>(p, grid, block, stream);
  }
}

}  // namespace

extern "C" {

// The probe's kernel in `mode` (0 copy, 1 stackrows, 2 selrows, 3
// gatherrow) over a (W, 8, 128) float32 window `src` (16-byte aligned),
// the eight row offsets `off` (host memory), into the (n_tiles * 8, 128)
// float32 `out`.  The wrapper checks that every build's slab lies
// in the window and that stackrows' and selrows' slabs fit in shared
// memory (kMaxSlabs).
int hk_interleave_f32(const float* src, int W, int builds, int n_tiles,
                      int mode, const int* off, float* out, void* stream) {
  return (int)run(src, W, builds, n_tiles, mode, off, out,
                  (cudaStream_t)stream);
}

// The resources of a launch of `mode` at these shapes into out[5]:
// resident blocks an SM, registers a thread, static shared bytes a block,
// local bytes a thread (spills), dynamic shared bytes a block.
int hk_interleave_resources(int W, int builds, int n_tiles, int mode,
                            const int* off, int* out) {
  Params p;
  int grid = 0, block = 0;
  cudaError_t err = plan(W, builds, n_tiles, mode, off, &p, &grid, &block);
  if (err != cudaSuccess) return (int)err;
  const auto kernel = mode == 0 ? interleave_kernel<0>
                      : mode == 1 ? interleave_kernel<1>
                      : mode == 2 ? interleave_kernel<2>
                      : interleave_kernel<3>;
  const size_t smem = (size_t)p.staged * kSlabBytes;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(kMaxSlabs * kSlabBytes));
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess)
    return (int)err;
  out[1] = fa.numRegs;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = (int)fa.localSizeBytes;
  out[4] = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                            block, smem);
}

}  // extern "C"
