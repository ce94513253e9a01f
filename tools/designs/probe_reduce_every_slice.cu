// The design that the reduce probe (llcomp_tpu_torch/csrc/probe_reduce.cu)
// replaced, kept whole as a copy that chip_smoke.py builds and times beside
// the shipped kernel in one profiler session: a block-wide maximum
// (probe_common.cuh block_max: two __syncthreads and a serial loop of 31
// shared-memory reads in every thread) on every 8-row slice, each slice's
// load issued after the previous slice's reduction.  Its kernel is renamed
// (fill_flush_every_slice) so that a profiler tells it from the shipped
// one.  Its note follows as it stood.
//
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
// reduction (warp redux, shared memory, two __syncthreads), taken once per
// 8-row slice; every thread takes the same branch, so it costs no
// divergence.  What bounds it: the reduction's latency a slice; x is 32 KB
// at the probe's shape.  On one H100 80GB HBM3 at 700 W (chip_smoke.py
// phase 8, two runs) a launch of the 8 slices runs 5.7-6.3 us on the
// device.
#include "probe_common.cuh"

namespace {

using namespace probe;

constexpr int kMaxBlock = 1024;

__global__ void __launch_bounds__(kMaxBlock)
fill_flush_every_slice(const int32_t* __restrict__ x,
                       int32_t* __restrict__ out, int lanes, int blocks) {
  __shared__ int32_t red[kWarp];
  const int t = threadIdx.x;      // word (t / lanes, t % lanes) of the tile
  const int tile = 8 * lanes;
  const bool live = t < tile;
  int32_t fill = 0;
  int32_t flushed = 0;
  int32_t acc = 0;
  for (int c = 0; c < blocks; ++c) {
    acc = 0;
    for (int j = 0; j < 4; ++j) {
      const int32_t v =
          live ? x[static_cast<size_t>(c * 4 + j) * tile + t] : 0;
      fill = wadd(fill, v & 1);
      acc = wadd(acc, v);
      if (block_max(live ? fill : INT_MIN, red) > 3) {
        flushed = wadd(flushed, fill);
        fill = 0;
      }
    }
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
  fill_flush_every_slice<<<1, whole_warps(8 * lanes), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), lanes,
      rows / 32);
  return done();
}
