// A design of the reduce probe (llcomp_tpu_torch/csrc/probe_reduce.cu) not
// shipped, kept whole as a copy that chip_smoke.py builds and times beside
// the shipped kernel in one profiler session: one warp for the whole
// (8, lanes) tile.
//
// Thread t holds words t, t + 32, ... of the tile (kWords of them at the
// largest tile, 8 x 128 = 1,024 words; words past the tile are masked and
// give INT_MIN to the maximum), with fill, acc and the flushed counts in
// registers.  As in the shipped design the maximum is taken only where
// kFlushGap or more slices have passed since the last flush (a count every
// thread keeps alike); here it is a thread's own maximum and one warp
// redux, with no shared memory and no barrier.  Each slice's loads are
// issued before the previous slice's reduction.  What it trades: a block
// of one thread a word spreads the loads and the adds over 32 warps; one
// warp issues all of them itself (32 loads and ~100 instructions a slice
// a thread at 128 lanes).
#include "probe_common.cuh"

namespace {

using namespace probe;

// Words of the largest tile a thread holds (1,024 / 32).
constexpr int kWords = 1024 / kWarp;
constexpr int kFlushGap = 4;

__device__ __forceinline__ void load_slice(int32_t (&v)[kWords],
                                           const int32_t* __restrict__ row,
                                           int t, int tile) {
#pragma unroll
  for (int i = 0; i < kWords; ++i)
    v[i] = i * kWarp + t < tile ? row[i * kWarp] : 0;
}

__global__ void __launch_bounds__(kWarp)
fill_flush_warp(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                int lanes, int blocks) {
  const int t = threadIdx.x;
  const int tile = 8 * lanes;
  const int slices = 4 * blocks;
  int32_t fill[kWords], acc[kWords], flushed[kWords], v[kWords], w[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) fill[i] = acc[i] = flushed[i] = w[i] = 0;
  load_slice(v, x + t, t, tile);
  int since = 0;
  for (int g = 0; g < slices; ++g) {
    if (g + 1 < slices)
      load_slice(w, x + static_cast<size_t>(g + 1) * tile + t, t, tile);
    const bool fresh = (g & 3) == 0;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      fill[i] = wadd(fill[i], v[i] & 1);
      acc[i] = wadd(fresh ? 0 : acc[i], v[i]);
    }
    if (++since >= kFlushGap) {
      int32_t m = INT_MIN;
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        m = i * kWarp + t < tile ? max(m, fill[i]) : m;
      if (__reduce_max_sync(0xFFFFFFFFu, m) > 3) {
#pragma unroll
        for (int i = 0; i < kWords; ++i) {
          flushed[i] = wadd(flushed[i], fill[i]);
          fill[i] = 0;
        }
        since = 0;
      }
    }
#pragma unroll
    for (int i = 0; i < kWords; ++i) v[i] = w[i];
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const int at = i * kWarp + t;
    if (at < tile) {
      out[at] = flushed[i];
      out[tile + at] = acc[i];
    }
  }
}

}  // namespace

// x [rows, lanes] int32 with 8 * lanes <= 1,024 and rows >= 32 (rows past
// the last multiple of 32 are not read, as the TPU grid's floor); out
// [16, lanes] int32.  Returns cudaGetLastError().
extern "C" int llct_probe_reduce(const void* x, void* out, int lanes, int rows,
                                 void* stream) {
  fill_flush_warp<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), lanes,
      rows / 32);
  return done();
}
