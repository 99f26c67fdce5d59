// Streaming kernel o = x + 1.0f over a (rows, E) float32 array, tile by
// tile: the port's bandwidth probe (hakai_tpu_torch/probes/dma.py).
//
// Replaces copy_kernel (benchmarks/dma_microbench.py:35, its pallas_call
// at :42), the TPU's HBM streaming probe over the packed Gauss state's
// (72, E) shape.  Each block takes one (rows, TE) tile, in the order the
// TPU's grid walks the tiles, in one of three layouts:
//   0 strided:   row-major (rows, E); the tile's rows are TE floats apart
//                by E (rows strided bursts);
//   1 tilemajor: (n_tiles, rows, TE); the tile is one contiguous block;
//   2 flat:      (rows * n_tiles, TE); row block i is tile i.  These are
//                the same bytes in the same order as tilemajor: the TPU
//                probe names them apart by their BlockSpec, and on the
//                card they are one access pattern.
//
// What bounds it on an H100: device-memory bytes.  A pass reads and writes
// rows * E * 4 bytes each: 2 * 72 * 1,048,576 * 4 = 603,979,776 B, 0.1803
// ms at the nominal 3.35 TB/s.  No arithmetic to speak of.
//
// Design: a tile is rows lines of TE floats, `pitch` floats apart (E in
// the strided layout, TE in the others).  Thread c of the block owns
// float4 column c of every line and walks the lines kUnroll at a time, all
// loads of a group in flight before its stores; neighbouring threads take
// neighbouring 16-byte words, so a warp moves 512 contiguous bytes a line,
// and no index is divided on the float4 path.  The
// strided layout's ragged last tile (E % TE != 0) and a line width that is
// no multiple of 4 floats take a scalar path for the columns past the
// last whole float4.  Nothing is staged in shared memory (a streaming pass
// reuses no byte) and no TMA: a simple, right kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
stream_add1_kernel(const float* __restrict__ x, float* __restrict__ o,
                   int rows, int E, int TE, int layout) {
  const int t = blockIdx.x;
  // the tile's first value, the distance between its lines, its width
  const int64_t base = layout == 0 ? (int64_t)t * TE : (int64_t)t * rows * TE;
  const int64_t pitch = layout == 0 ? E : TE;
  const int width = (layout == 0 && E - t * TE < TE) ? E - t * TE : TE;
  // float4 path: every line start of the tile must be 16-byte aligned
  const bool vec = (TE % 4 == 0) && (layout != 0 || E % 4 == 0);
  const int w4 = vec ? width / 4 : 0;           // whole float4s per line
  const float* xt = x + base;
  float* ot = o + base;
  for (int c = threadIdx.x; c < w4; c += blockDim.x) {
    for (int r0 = 0; r0 < rows; r0 += kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + u < rows)
          v[u] = reinterpret_cast<const float4*>(xt + (r0 + u) * pitch)[c];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + u < rows) {
          float4 w = v[u];
          w.x += 1.0f; w.y += 1.0f; w.z += 1.0f; w.w += 1.0f;
          reinterpret_cast<float4*>(ot + (r0 + u) * pitch)[c] = w;
        }
      }
    }
  }
  // scalar tail: the columns past the last whole float4 of each line
  const int tail = width - 4 * w4;
  for (int i = threadIdx.x; i < tail * rows; i += blockDim.x) {
    const int64_t k = (int64_t)(i / tail) * pitch + 4 * w4 + i % tail;
    ot[k] = xt[k] + 1.0f;
  }
}

}  // namespace

extern "C" {

// o = x + 1.0f over n_tiles = ceil(E / TE) tiles of (rows, TE); for the
// tilemajor and flat layouts E must be a multiple of TE (the wrapper
// checks it, and that rows * E < 2^31).  A block has a thread per float4
// of a line, 32 at least and kThreads at most.
int hk_stream_add1_f32(const float* x, float* o, int rows, int E, int TE,
                       int layout, void* stream) {
  if (rows <= 0 || E <= 0 || TE <= 0) return 0;
  const int n_tiles = (int)(((int64_t)E + TE - 1) / TE);
  const int lanes = ((TE + 3) / 4 + 31) / 32 * 32;    // >= 32
  const int threads = lanes < kThreads ? lanes : kThreads;
  stream_add1_kernel<<<(unsigned)n_tiles, threads, 0,
                       (cudaStream_t)stream>>>(x, o, rows, E, TE, layout);
  return (int)cudaGetLastError();
}

}  // extern "C"
