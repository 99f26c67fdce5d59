// Streaming kernel o = x + 1.0f over a (rows, E) float32 array in tiles of
// (rows, TE): the port's bandwidth probe (hakai_tpu_torch/probes/dma.py).
//
// Replaces copy_kernel (benchmarks/dma_microbench.py:35, its pallas_call
// at :42), the TPU's HBM streaming probe over the packed Gauss state's
// (72, E) shape, in one of three layouts:
//   0 strided:   row-major (rows, E); a tile's rows are TE floats apart
//                by E (rows strided bursts on the TPU);
//   1 tilemajor: (n_tiles, rows, TE); a tile is one contiguous block;
//   2 flat:      (rows * n_tiles, TE); row block i is tile i.  These are
//                the same bytes in the same order as tilemajor: the TPU
//                probe names them apart by their BlockSpec.
//
// What bounds it on an H100: device-memory bytes.  A pass reads and writes
// rows * E * 4 bytes each: 2 * 72 * 1,048,576 * 4 = 603,979,776 B, 0.1803
// ms at the nominal 3.35 TB/s.  No arithmetic to speak of.
//
// The grid does not copy the TPU's (one block a tile gave 512 blocks on
// 132 SMs, one uneven wave, 4 loads in flight a thread).  The array is cut
// into lines, one row of one tile each (TE floats, or the strided layout's
// ragged last tile), numbered in address order; the layout only maps a
// line to its first value.  A unit is a warp's run of 32 16-byte columns
// of one line (512 contiguous bytes), one unit a warp and one 16-byte load
// and store a thread, evict-first (__ldcs/__stcs: a stream reuses
// nothing), so short blocks of 4 warps stream through the SMs as
// torch.add's do.  Timed on an H100 (PERF.md, Findings), a
// persistent grid that kept 8 loads in flight a thread ran 5-6% slower
// than this, more loads a thread were slower in every grid, and a TMA ring
// (the Hopper form of the TPU's HBM -> VMEM -> HBM DMA pipeline: bulk
// copies into shared-memory stages, the add there, bulk stores back) ran
// 6-8% slower: each value crosses shared memory twice.
//
// Lines whose starts are not 16-byte aligned (a strided E or a TE that is
// no multiple of 4 floats) take a scalar grid-stride pass over the whole
// array, which is contiguous in every layout.  Both passes add the same
// 1.0f to the same values: the result is bitwise x + 1.0f.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // scalar pass: threads a block
constexpr int kVecThreads = 128;   // vector pass: threads a block

// the array as lines, in address order
struct Lines {
  int rows, E, TE, layout, n_tiles;

  // first value of line l: row r of tile t
  __device__ __forceinline__ int64_t base(int l) const {
    if (layout != 0) return (int64_t)l * TE;
    const int r = l / n_tiles, t = l - r * n_tiles;
    return (int64_t)r * E + (int64_t)t * TE;
  }
  __device__ __forceinline__ int width(int l) const {
    if (layout != 0) return TE;
    const int t = l % n_tiles;
    return E - t * TE < TE ? E - t * TE : TE;
  }
};

// a warp per unit: run r of line l, 16-byte column 32 r + lane
__global__ void __launch_bounds__(kVecThreads)
stream_vector(const float* __restrict__ x, float* __restrict__ o, Lines L,
              int runs, int units) {
  const int u = blockIdx.x * (kVecThreads / 32) + threadIdx.x / 32;
  if (u >= units) return;
  const int l = u / runs;
  const int c = (u - l * runs) * 32 + (threadIdx.x & 31);
  if (c >= L.width(l) / 4) return;
  const int64_t b = L.base(l);
  float4 v = __ldcs(reinterpret_cast<const float4*>(x + b) + c);
  v.x += 1.0f; v.y += 1.0f; v.z += 1.0f; v.w += 1.0f;
  __stcs(reinterpret_cast<float4*>(o + b) + c, v);
}

__global__ void __launch_bounds__(kThreads)
stream_scalar(const float* __restrict__ x, float* __restrict__ o,
              int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads)
    __stcs(o + i, __ldcs(x + i) + 1.0f);
}

}  // namespace

extern "C" {

// o = x + 1.0f over n_tiles = ceil(E / TE) tiles of (rows, TE) in `layout`;
// for the tilemajor and flat layouts E must be a multiple of TE (the
// wrapper checks it, and that rows * E < 2^31 and that x and o are 16-byte
// aligned).
int hk_stream_add1_f32(const float* x, float* o, int rows, int E, int TE,
                       int layout, void* stream) {
  if (rows <= 0 || E <= 0 || TE <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (E + TE - 1) / TE;
  const Lines L{rows, E, TE, layout, n_tiles};
  const int lines = rows * n_tiles;
  // the float4 pass: every line start 16-byte aligned
  if (TE % 4 != 0 || (layout == 0 && E % 4 != 0)) {
    const int64_t n = (int64_t)rows * E;
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    stream_scalar<<<(unsigned)(blocks < 8 * sms ? blocks : 8 * sms),
                    kThreads, 0, st>>>(x, o, n);
  } else {
    const int runs = (TE / 4 + 31) / 32;
    const int units = lines * runs;
    const int warps = kVecThreads / 32;
    stream_vector<<<(units + warps - 1) / warps, kVecThreads, 0, st>>>(
        x, o, L, runs, units);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
