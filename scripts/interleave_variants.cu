// Design variants of TPU kernel #12's replacement, the interleave probe's
// kernel (hakai_tpu_torch/csrc/interleave.cu), in the four modes, each
// held bit for bit against the plain version; built into a shared library
// and driven by scripts/interleave_variants.py (its header says how to run
// it).  The shipped design comes from the package's source:
//
//   hk_interleave_f32  the shipped design: the tiles an SM must take held
//                      at once, a thread four lanes of a row read as
//                      float4s (selrows: two lanes of rows 0-7, float2s),
//                      56 slabs staged by every thread with cp.async in
//                      groups of four, each completing on an mbarrier,
//                      copy's share of slabs 56-63 held in registers
//   iv_first           the first design: a thread per value, the
//                      window staged by a load-then-store loop behind one
//                      barrier, slabs past 56 read through L1/L2 inside
//                      the chain of adds, selrows reading all eight
//                      candidate rows for every value
//   iv_tma             the TMA design (below), in clusters of 1, 2 or 4
//                      blocks, a slab multicast to every block of a
//                      cluster; 1: every block loads the whole window
//   iv_ring            the ring design (below), in clusters of 1 or 4
#include "../hakai_tpu_torch/csrc/interleave.cu"

// the ring design: a block holds its tiles' lanes (a thread a lane, rows
// 0-7 in eight registers, 4-byte reads), a producer warp issues the bulk
// copies, copy's and gatherrow's slabs past 56 stream through a ring of
// 56 slots that every consumer warp of the cluster releases after each
// build (a remote mbarrier arrive), and selrows' cascade runs on row ids
// passed at run time (64 bitwise selects a build)
namespace ring {
namespace {

constexpr int kRows = 8;
constexpr int kLanes = 128;
constexpr int kSlab = kRows * kLanes;         // floats of one (8, 128) slab
constexpr int kMaxSlabs = 56;                 // 56 * 4,096 B of shared memory
constexpr int kMaxGroup = 4;                  // tiles a block holds at once
constexpr int kMaxThreads = kMaxGroup * kLanes + 32;
constexpr int kCluster = 4;                   // blocks sharing a window load

struct Params {
  const float* src;
  float* out;
  int W, builds, n_tiles;
  int off[kRows];         // row offsets (stackrows, selrows)
  int row[kRows];         // row ids 0..7 (selrows' cascade)
  int slabs;              // slabs the builds read: 0 .. slabs - 1
  int slots;              // ring slots: == slabs resident, < slabs streamed
  int group;              // tiles a block holds at once
  int n_groups;
  int cluster;            // blocks a cluster
};

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

// arrive on `bar` as it lies in block `rank` of the cluster
__device__ __forceinline__ void bar_arrive_remote(uint64_t* bar,
                                                  uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
               :: "r"(remote) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

constexpr uint32_t kSlabBytes = kSlab * sizeof(float);

// this block's slot `bar` expects one slab
__device__ __forceinline__ void expect_slab(uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(kSlabBytes) : "memory");
}

// one slab (4 KB) of the window into `dst` of every block in `mask`,
// completing on each one's `bar`
__device__ __forceinline__ void load_slab(float* dst, const float* src,
                                          uint64_t* bar, uint16_t mask) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes.multicast::cluster [%0], [%1], %2, [%3], %4;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(kSlabBytes),
                  "r"(smem_addr(bar)), "h"(mask) : "memory");
}

// v = m ? x : v, bit for bit
__device__ __forceinline__ float select_bits(uint32_t m, float x, float v) {
  return __uint_as_float((__float_as_uint(x) & m)
                         | (__float_as_uint(v) & ~m));
}

template <int MODE>
__global__ void __launch_bounds__(kMaxThreads, 1)
interleave_kernel(const Params p) {
  extern __shared__ __align__(128) float ring[];        // slots x kSlab
  __shared__ __align__(8) uint64_t full[kMaxSlabs], empty[kMaxSlabs];
  const int tid = threadIdx.x, consumers = p.group * kLanes;
  const int C = p.cluster;
  const uint32_t rank = cluster_rank();
  const bool streamed = p.slots < p.slabs;
  // every block of a cluster walks as many groups as its first block, so
  // they consume the same slabs in the same order
  const int first = (int)blockIdx.x - (int)rank;
  const int n_iter = (p.n_groups - 1 - first) / (int)gridDim.x + 1;
  if (tid == 0) {
    for (int s = 0; s < p.slots; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], C * consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();
  if (tid >= consumers) {
    if (tid == consumers) {               // the producer
      // resident: each slab once, slot = slab; streamed: slab (b % W) of
      // every build of every tile iteration, in order, slot c % slots
      const int total = streamed ? n_iter * p.builds : p.slabs;
      const uint16_t all = (uint16_t)((1u << C) - 1u);
      for (int c = 0; c < total; ++c) {
        const int s = c % p.slots, fill = c / p.slots;
        if (fill > 0) bar_wait(&full[s], (fill - 1) & 1);
        expect_slab(&full[s]);
        if (c % C == (int)rank) {
          if (fill > 0) bar_wait(&empty[s], (fill - 1) & 1);
          const int slab = streamed ? (c % p.builds) % p.W : c;
          load_slab(ring + s * kSlab, p.src + (int64_t)slab * kSlab,
                    &full[s], all);
        }
      }
    }
  } else {
    const int j = tid % kLanes;
    uint32_t mask[kRows][kRows];          // selrows: row[i] == k
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        mask[i][k] = 0u - (uint32_t)(p.row[i] == k);
    for (int it = 0; it < n_iter; ++it) {
      const int tile = ((int)blockIdx.x + it * (int)gridDim.x) * p.group
                       + tid / kLanes;
      const bool live = tile < p.n_tiles; // a warp's tile: warp-uniform
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;
      if (MODE == 0 || MODE == 3) {
        int u = 0;                        // b % W
        for (int b = 0; b < p.builds; ++b) {
          const int c = streamed ? it * p.builds + b : u;
          const int s = streamed ? c % p.slots : u;
          if (streamed || (it == 0 && b < p.slabs))
            bar_wait(&full[s], streamed ? (c / p.slots) & 1 : 0);
          const float* sl = ring + s * kSlab;
          if (live) {
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const float v = MODE == 0
                  ? sl[i * kLanes + j] : sl[i * kLanes + ((7 * i + b) & 127)];
              acc[i] = __fadd_rn(acc[i], v);
            }
          }
          if (streamed) {                 // this warp is done with slot s
            __syncwarp();
            if ((tid & 31) == 0) bar_arrive_remote(&empty[s], c % C);
          }
          if (++u == p.W) u = 0;
        }
      } else {
        for (int b = 0; b < p.builds; ++b) {
          const int u = b & 15;
          if (it == 0 && b < 16)
#pragma unroll
            for (int k = 0; k < kRows; ++k) bar_wait(&full[p.off[k] + u], 0);
          if (!live) continue;
          float x[kRows];                 // row k at its dynamic offset
#pragma unroll
          for (int k = 0; k < kRows; ++k)
            x[k] = ring[((p.off[k] + u) * kRows + k) * kLanes + j];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            float v = x[i];
            if (MODE == 2) {              // the select cascade on row ids
              v = 0.0f;
#pragma unroll
              for (int k = 0; k < kRows; ++k)
                v = select_bits(mask[i][k], x[k], v);
            }
            acc[i] = __fadd_rn(acc[i], v);
          }
        }
      }
      if (live)
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          p.out[((int64_t)tile * kRows + i) * kLanes + j] = acc[i];
    }
    // no block leaves a bulk copy in flight into its shared memory
    if (tid == 0 && !streamed)
      for (int s = 0; s < p.slabs; ++s) bar_wait(&full[s], 0);
  }
  // nor leaves the cluster while a block may still arrive on its barriers
  cluster_sync();
}

// The launch of mode `mode` over n_tiles in clusters of `cluster` blocks:
// its Params (pointers unset), grid and block; an error for a window that
// the design cannot hold.
cudaError_t plan(int W, int builds, int n_tiles, int mode, const int* off,
                 int cluster, Params* p, int* grid, int* block) {
  memset(p, 0, sizeof(*p));
  p->W = W;
  p->builds = builds;
  p->n_tiles = n_tiles;
  p->cluster = cluster;
  int hi = 0;
  for (int k = 0; k < kRows; ++k) {
    p->off[k] = off[k];
    p->row[k] = k;
    hi = off[k] > hi ? off[k] : hi;
  }
  if (mode == 1 || mode == 2) {
    p->slabs = builds > 0 ? hi + (builds < 16 ? builds : 16) : 0;
    if (p->slabs > kMaxSlabs) return cudaErrorInvalidValue;
    p->slots = p->slabs;
  } else if (mode == 0 || mode == 3) {
    p->slabs = builds < W ? builds : W;
    p->slots = p->slabs < kMaxSlabs ? p->slabs : kMaxSlabs;
  } else {
    return cudaErrorInvalidValue;
  }
  if (cluster < 1 || cluster > 8) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // the tiles an SM must take, held at once where they fit
  const int per = (n_tiles + sms - 1) / sms;
  p->group = per < kMaxGroup ? per : kMaxGroup;
  p->n_groups = (n_tiles + p->group - 1) / p->group;
  // whole clusters, at most a block an SM
  const int want = (p->n_groups + cluster - 1) / cluster * cluster;
  const int most = sms / cluster * cluster;
  *grid = want < most ? want : most;
  *block = p->group * kLanes + 32;
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
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = (size_t)p.slots * kSlabBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t run(const float* src, int W, int builds, int n_tiles, int mode,
                const int* off, int cluster, float* out,
                cudaStream_t stream) {
  if (n_tiles <= 0) return cudaSuccess;
  Params p;
  int grid = 0, block = 0;
  cudaError_t err = plan(W, builds, n_tiles, mode, off, cluster, &p, &grid,
                         &block);
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

}  // namespace ring

// the TMA design: as shipped, but the window staged by TMA bulk copies
// that thread 0 issues up front, an mbarrier a slab, in clusters whose
// blocks each issue a share of the slabs, multicast to the cluster
namespace tma {
namespace {

constexpr int kRows = 8;
constexpr int kLanes = 128;
constexpr int kSlab = kRows * kLanes;         // floats of one (8, 128) slab
constexpr int kQuads = kLanes / 4;            // float4 columns of a row
constexpr int kMaxSlabs = 56;                 // slabs in shared memory
constexpr int kRegSlabs = 8;                  // copy, gatherrow: in registers
constexpr int kMaxGroup = 4;                  // tiles a block holds at once
constexpr int kCluster = 2;                   // blocks sharing a window load
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
  int cluster;            // blocks a cluster
};

// rows a thread sums, threads a tile
template <int MODE>
__host__ __device__ constexpr int rows_of() { return MODE == 2 ? kRows : 1; }
template <int MODE>
__host__ __device__ constexpr int tile_threads() {
  return kRows / rows_of<MODE>() * kQuads;
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

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// this block's `bar` expects one slab
__device__ __forceinline__ void expect_slab(uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(kSlabBytes) : "memory");
}

// one slab (4 KB) of the window into `dst` of this block (C == 1) or of
// every block of the cluster of C, completing on each one's `bar`
__device__ __forceinline__ void load_slab(void* dst, const float* src,
                                          uint64_t* bar, int C) {
  if (C == 1) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(kSlabBytes),
                    "r"(smem_addr(bar)) : "memory");
  } else {
    const uint16_t mask = (uint16_t)((1u << C) - 1u);
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes.multicast::cluster [%0], [%1], %2, [%3], %4;"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(kSlabBytes),
                    "r"(smem_addr(bar)), "h"(mask) : "memory");
  }
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
__global__ void __launch_bounds__(kMaxGroup * tile_threads<MODE>())
interleave_kernel(const Params p) {
  constexpr int R = rows_of<MODE>(), kTile = tile_threads<MODE>();
  extern __shared__ __align__(128) float4 win[];       // staged x 256
  __shared__ __align__(8) uint64_t full[kMaxSlabs];
  const float* wf = reinterpret_cast<const float*>(win);
  const float4* src4 = reinterpret_cast<const float4*>(p.src);
  const int tid = threadIdx.x, C = p.cluster;
  const uint32_t rank = C > 1 ? cluster_rank() : 0u;
  // every block of a cluster walks as many groups as its first block
  const int first = (int)blockIdx.x - (int)rank;
  const int n_iter = (p.n_groups - 1 - first) / (int)gridDim.x + 1;
  if (tid == 0) {
    for (int s = 0; s < p.staged; ++s) bar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (C > 1) cluster_sync(); else __syncthreads();
  if (tid == 0)
    for (int s = 0; s < p.staged; ++s) {
      expect_slab(&full[s]);
      if (s % C == (int)rank)
        load_slab(win + s * (kSlab / 4), p.src + (int64_t)s * kSlab,
                  &full[s], C);
    }
  const int t = tid % kTile, q = t % kQuads, r0 = t / kQuads * R;
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
    float4 acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (MODE == 0 || MODE == 3) {
      int u = 0;                          // b % W
      for (int b = 0; b < p.builds; ++b) {
        float4 v;
        float g;
        if (u < p.staged) {
          if (it == 0 && b < p.staged) bar_wait(&full[u], 0);
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
          if (it == 0 && b < 16) bar_wait(&full[s], 0);
          add4(acc[0], win[(s * kRows + r0) * kQuads + q]);
        } else {
          float4 x[kRows];                // candidate row k, four lanes
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            const int s = p.off[k] + u;
            if (it == 0 && b < 16) bar_wait(&full[s], 0);
            x[k] = win[(s * kRows + k) * kQuads + q];
          }
#pragma unroll
          for (int i = 0; i < R; ++i) {   // the select cascade on the row
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int k = 0; k < kRows; ++k) v = i == k ? x[k] : v;
            add4(acc[i], v);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t o = ((int64_t)tile * kRows + r0 + r) * kLanes + 4 * q;
      if ((reinterpret_cast<uintptr_t>(p.out) & 15) == 0) {
        *reinterpret_cast<float4*>(p.out + o) = acc[r];
      } else {
        p.out[o] = acc[r].x;
        p.out[o + 1] = acc[r].y;
        p.out[o + 2] = acc[r].z;
        p.out[o + 3] = acc[r].w;
      }
    }
  }
  // no block leaves a bulk copy in flight into its shared memory, nor its
  // cluster while a block may still multicast into it
  if (tid == 0)
    for (int s = 0; s < p.staged; ++s) bar_wait(&full[s], 0);
  if (C > 1) cluster_sync();
}

// The launch of mode `mode` over n_tiles in clusters of `cluster` blocks:
// its Params (pointers unset), grid and block; an error for a window that
// the design cannot hold.
cudaError_t plan(int W, int builds, int n_tiles, int mode, const int* off,
                 int cluster, Params* p, int* grid, int* block) {
  memset(p, 0, sizeof(*p));
  p->W = W;
  p->builds = builds;
  p->n_tiles = n_tiles;
  p->cluster = cluster;
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
  if (cluster < 1 || cluster > 8) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // the tiles an SM must take, held at once where they fit
  const int per = (n_tiles + sms - 1) / sms;
  p->group = per < kMaxGroup ? per : kMaxGroup;
  p->n_groups = (n_tiles + p->group - 1) / p->group;
  // whole clusters, at most a block an SM
  const int want = (p->n_groups + cluster - 1) / cluster * cluster;
  const int most = sms / cluster * cluster;
  *grid = want < most ? want : most;
  *block = p->group * (mode == 2 ? tile_threads<2>() : tile_threads<0>());
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
  const size_t smem = (size_t)p.staged * kSlabBytes;
  if (p.cluster == 1) {
    kernel<<<grid, block, smem, stream>>>(p);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t run(const float* src, int W, int builds, int n_tiles, int mode,
                const int* off, int cluster, float* out,
                cudaStream_t stream) {
  if (n_tiles <= 0) return cudaSuccess;
  Params p;
  int grid = 0, block = 0;
  cudaError_t err = plan(W, builds, n_tiles, mode, off, cluster, &p, &grid,
                         &block);
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

}  // namespace tma

namespace {

constexpr int kFirstSlabs = 56;

struct Offsets {
  int v[kRows];
};

template <int MODE>
__global__ void __launch_bounds__(kSlab, 1)
first_kernel(const float* __restrict__ src, int W, int builds, int n_tiles,
             Offsets off, int staged, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const float* sm = reinterpret_cast<const float*>(smem4);
  const int tid = threadIdx.x;
  const int i = tid / kLanes, j = tid % kLanes;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  for (int k = tid; k < staged * (kSlab / 4); k += kSlab) smem4[k] = src4[k];
  int my_off = 0;
#pragma unroll
  for (int k = 0; k < kRows; ++k) my_off = i == k ? off.v[k] : my_off;
  __syncthreads();
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    float acc = 0.0f;
    int s = 0;
    for (int b = 0; b < builds; ++b) {
      float v;
      if (MODE == 0) {
        const int k = s * kSlab + tid;
        v = s < staged ? sm[k] : __ldg(src + k);
      } else if (MODE == 1) {
        v = sm[((my_off + (b & 15)) * kRows + i) * kLanes + j];
      } else if (MODE == 2) {
        v = 0.0f;
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const float x = sm[((off.v[k] + (b & 15)) * kRows + k) * kLanes + j];
          v = i == k ? x : v;
        }
      } else {
        const int k = (s * kRows + i) * kLanes + ((7 * i + b) & (kLanes - 1));
        v = s < staged ? sm[k] : __ldg(src + k);
      }
      acc = __fadd_rn(acc, v);
      if (++s == W) s = 0;
    }
    out[(int64_t)tile * kSlab + tid] = acc;
  }
}

template <int MODE>
int first_launch(const float* src, int W, int builds, int n_tiles,
                 const Offsets& off, int staged, float* out,
                 cudaStream_t stream) {
  const size_t smem = (size_t)staged * kSlab * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      first_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kFirstSlabs * kSlab * sizeof(float)));
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int per = (n_tiles + sms - 1) / sms;
  const int grid = (n_tiles + per - 1) / per;
  first_kernel<MODE><<<grid, kSlab, smem, stream>>>(src, W, builds, n_tiles,
                                                    off, staged, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int iv_first(const float* src, int W, int builds, int n_tiles, int mode,
             const int* off, float* out, void* stream) {
  if (n_tiles <= 0) return 0;
  Offsets o;
  memcpy(o.v, off, sizeof(o.v));
  int hi = 0;
  for (int k = 0; k < kRows; ++k) hi = o.v[k] > hi ? o.v[k] : hi;
  const int used = builds < W ? builds : W;
  const int rows16 = builds < 16 ? builds : 16;
  int staged = mode == 1 || mode == 2 ? hi + rows16 : used;
  staged = staged < kFirstSlabs ? staged : kFirstSlabs;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0: return first_launch<0>(src, W, builds, n_tiles, o, staged, out, s);
    case 1: return first_launch<1>(src, W, builds, n_tiles, o, staged, out, s);
    case 2: return first_launch<2>(src, W, builds, n_tiles, o, staged, out, s);
    case 3: return first_launch<3>(src, W, builds, n_tiles, o, staged, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the ring design (its clusters of `cluster` blocks)
int iv_ring(const float* src, int W, int builds, int n_tiles, int mode,
            const int* off, float* out, void* stream, int cluster) {
  return (int)ring::run(src, W, builds, n_tiles, mode, off, cluster, out,
                        (cudaStream_t)stream);
}

// the TMA design in clusters of `cluster` blocks (1, 2 or 4)
int iv_tma(const float* src, int W, int builds, int n_tiles, int mode,
           const int* off, float* out, void* stream, int cluster) {
  return (int)tma::run(src, W, builds, n_tiles, mode, off, cluster, out,
                       (cudaStream_t)stream);
}

const char* iv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
