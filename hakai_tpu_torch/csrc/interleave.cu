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
// (31.5 M at 512 x 60: 0.47 us at 67 TFLOP/s).  A single call is far
// shorter than a launch, so launch latency rules it.
//
// Design.  A TPU vreg is not a block: on the card the primitive is a
// build from a window held on chip.  Blocks are persistent, as the TPU's
// constant index map keeps the window resident over its grid: each block
// stages the window once into shared memory and walks tiles t += gridDim.x
// (a block per SM, ~4 tiles each at 512 tiles).  A block has a thread per
// value of a tile, thread (i, j) = (row, lane), which sums its value over
// the builds in registers and stores it once per tile.  The modes' builds:
//   copy      - a shared-memory read of slab b % W, row i, lane j;
//   stackrows - a shared-memory read at the row's own dynamic offset;
//   selrows   - eight shared-memory reads (one per candidate row) and a
//               predicated select on the thread's row index, in registers;
//   gatherrow - an indexed shared-memory read at lane (7 i + b) % 128, one
//               address per row (a broadcast to the row's threads).
// Shared memory holds at most kMaxSlabs slabs (229,376 B of a block's
// 232,448): stackrows and selrows touch slabs 0 .. max(off) + 15 only (19
// at the probe's offsets, 76 KB); copy and gatherrow touch slabs 0 ..
// min(builds, W) - 1 (60 at the probe's 60 builds), so slabs past
// kMaxSlabs are read through L1/L2 (__ldg) where a build needs them.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kRows = 8;
constexpr int kLanes = 128;
constexpr int kSlab = kRows * kLanes;         // floats of one (8, 128) slab
constexpr int kThreads = kSlab;               // a thread per tile value
constexpr int kMaxSlabs = 56;                 // 56 * 4,096 B in shared memory

struct Offsets {
  int v[kRows];
};

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
interleave_kernel(const float* __restrict__ src, int W, int builds,
                  int n_tiles, Offsets off, int staged,
                  float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const float* sm = reinterpret_cast<const float*>(smem4);
  const int tid = threadIdx.x;
  const int i = tid / kLanes, j = tid % kLanes;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  for (int k = tid; k < staged * (kSlab / 4); k += kThreads)
    smem4[k] = src4[k];
  int my_off = 0;                             // off[i], without a local array
#pragma unroll
  for (int k = 0; k < kRows; ++k) my_off = i == k ? off.v[k] : my_off;
  __syncthreads();
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    float acc = 0.0f;
    int s = 0;                                // b % W
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
cudaError_t launch(const float* src, int W, int builds, int n_tiles,
                   const Offsets& off, int staged, float* out,
                   cudaStream_t stream) {
  const size_t smem = (size_t)staged * kSlab * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      interleave_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kMaxSlabs * kSlab * sizeof(float)));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // persistent: a block per SM at most, every block the same tile count
  const int per = (n_tiles + sms - 1) / sms;
  const int grid = (n_tiles + per - 1) / per;
  interleave_kernel<MODE><<<grid, kThreads, smem, stream>>>(
      src, W, builds, n_tiles, off, staged, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The probe's kernel in `mode` (0 copy, 1 stackrows, 2 selrows, 3
// gatherrow) over a (W, 8, 128) float32 window `src` (16-byte aligned),
// the eight row offsets `off` (host memory), into the (n_tiles * 8, 128)
// float32 `out`.  The wrapper checks that every build's slab lies in the
// window and that stackrows' and selrows' slabs fit in shared memory.
int hk_interleave_f32(const float* src, int W, int builds, int n_tiles,
                      int mode, const int* off, float* out, void* stream) {
  if (n_tiles <= 0) return 0;
  Offsets o;
  memcpy(o.v, off, sizeof(o.v));
  int hi = 0;
  for (int k = 0; k < kRows; ++k) hi = o.v[k] > hi ? o.v[k] : hi;
  const int used = builds < W ? builds : W;         // slabs of copy, gatherrow
  const int rows16 = builds < 16 ? builds : 16;
  int staged = mode == 1 || mode == 2 ? hi + rows16 : used;
  staged = staged < kMaxSlabs ? staged : kMaxSlabs;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0: return (int)launch<0>(src, W, builds, n_tiles, o, staged, out, s);
    case 1: return (int)launch<1>(src, W, builds, n_tiles, o, staged, out, s);
    case 2: return (int)launch<2>(src, W, builds, n_tiles, o, staged, out, s);
    case 3: return (int)launch<3>(src, W, builds, n_tiles, o, staged, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
