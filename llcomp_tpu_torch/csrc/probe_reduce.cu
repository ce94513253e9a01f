// The reduce probe of llcomp_tpu_torch.probes.reduce: per-lane counters
// flushed when their maximum over the whole tile crosses a threshold, on
// the H100.
//
// Replaces tools/probe_reduce.py::_kernel (:25), launched by run (:54,
// pallas_call :55).  The TPU grid walks x in order, 32 rows a step, and
// carries the fill counters and the output block from step to step; here
// one block walks the whole of x in a loop, and the (8, lanes) tile of
// counters lives in registers, one word a thread.  Each 8-row slice adds
// v & 1 to fill and v to acc (reset every 32 rows); where max(fill) over
// the tile exceeds 3, fill is added to out[0:8] and reset.  out[8:16] is
// the last 32 rows' acc.
//
// What the TPU probe asked: whether a full vector-to-scalar max lowers and
// can gate a rare flush (pl.when).  On Hopper it is a block-wide
// reduction, and every thread takes the same branch, so it costs no
// divergence.  What bounds it: not its bytes (x is 32 KB at the probe's
// shape) but its reductions and loads in series after one launch.
//
// What the design does about it.  A slice adds 0 or 1 to a counter and a
// flush zeroes every counter, so no counter passes 3 before the 4th slice
// after the last flush (or the start): the maximum is taken only where
// kFlushGap or more slices have passed since the last flush, a count that
// every thread keeps alike, so the branch is uniform.  At the probe's shape
// (64 rows, words 0-3) that is 2 reductions where the parent took 8.  A
// reduction is one warp redux, one word a warp into shared memory
// (double-buffered by the parity of the check, so one __syncthreads
// serves), and each warp's own redux of the 32 words, one a lane.  Each
// 32-row block's four loads are issued before its first reduction, the
// next block's before this block's reductions: no load depends on a flush.
// The parent design (a block_max with two __syncthreads and a 31-read
// serial loop on every slice, each slice's load behind the previous
// reduction) is kept whole in tools/designs/probe_reduce_every_slice.cu,
// and one warp for the whole tile (32 words a thread, no shared memory) in
// tools/designs/probe_reduce_one_warp.cu; chip_smoke.py times all three
// in one profiler session.  On one H100 80GB HBM3 at 700 W (chip_smoke.py
// phase 8) a launch runs 2.35 us on the device, the one warp 4.66 and the
// parent 7.97, against an empty launch's 0.87 (PERF.md keeps the runs).
#include "probe_common.cuh"

namespace {

using namespace probe;

constexpr int kMaxBlock = 1024;
// Slices since the last flush before a counter can pass 3.
constexpr int kFlushGap = 4;

__global__ void __launch_bounds__(kMaxBlock)
fill_flush_block(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                 int lanes, int blocks) {
  __shared__ int32_t red[2][kWarp];
  const int t = threadIdx.x;      // word (t / lanes, t % lanes) of the tile
  const int tile = 8 * lanes;
  const bool live = t < tile;
  const int lane = t & (kWarp - 1);
  const bool mine = lane < static_cast<int>(blockDim.x) / kWarp;
  const int32_t* p = x + t;
  int32_t v[4], w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = live ? p[static_cast<size_t>(j) * tile] : 0;
  int32_t fill = 0, flushed = 0, acc = 0;
  int since = 0, parity = 0;
  for (int c = 0; c < blocks; ++c) {
    const bool more = live && c + 1 < blocks;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = more ? p[static_cast<size_t>(4 * c + 4 + j) * tile] : 0;
    acc = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fill = wadd(fill, v[j] & 1);
      acc = wadd(acc, v[j]);
      if (++since < kFlushGap) continue;
      const int32_t m = __reduce_max_sync(0xFFFFFFFFu, live ? fill : INT_MIN);
      if (lane == 0) red[parity][t / kWarp] = m;
      __syncthreads();
      const int32_t top = __reduce_max_sync(
          0xFFFFFFFFu, mine ? red[parity][lane] : INT_MIN);
      parity ^= 1;
      if (top > 3) {
        flushed = wadd(flushed, fill);
        fill = 0;
        since = 0;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = w[j];
  }
  if (live) {
    out[t] = flushed;
    out[tile + t] = acc;
  }
}

}  // namespace

// x [rows, lanes] int32 with 8 * lanes <= 1,024 and rows >= 32 (rows past
// the last multiple of 32 are not read, as the TPU grid's floor); out
// [16, lanes] int32.  Returns cudaGetLastError().
extern "C" int llct_probe_reduce(const void* x, void* out, int lanes, int rows,
                                 void* stream) {
  fill_flush_block<<<1, whole_warps(8 * lanes), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), lanes,
      rows / 32);
  return done();
}
