// The design that probe p11 (llcomp_tpu_torch/csrc/probe_mosaic.cu,
// stage_few) replaced, kept as a copy.  chip_smoke.py (VARIANTS, copy
// "p11 serial") includes it into a copy of probe_mosaic.cu, inside its
// namespace, and launches it for p11 over every lane, one thread a lane.
// Its kernel follows as it stood, renamed from stage_few.
//
// Each staged lane runs the TPU probe's loop, one thread a lane, while the
// other SMs idle: 171-287 ns a step at T 512 through one launch's CUDA
// events, host time included, on one H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 8).  Its device time, in turns with an empty launch
// in one profiler session, is near 71 ns a step: a step's row depends on
// x and s alone, so the compiler unrolls the loop 4 steps a pass and
// overlaps their loads.  chip_smoke.py takes p8's chain floor (one load
// latency) from this copy's step through CUDA events, as it took p11's
// before p11 became a warp's sum.
#pragma once

// p11: T steps in which only lanes below nstage read their row:
// carry = (carry + word) & 0x7FFF, the plane left as it is.
__global__ void __launch_bounds__(kLaneBlock)
stage_few_serial(const int32_t* __restrict__ idx, const int32_t* __restrict__ A,
          int32_t* __restrict__ out, int lanes, int rows, int T, int nstage) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int32_t x = idx[l];
  const size_t n = static_cast<size_t>(lanes);
  int32_t carry = 0;
  if (l < nstage) {
    for (int s = 0; s < T; ++s)
      carry = wadd(carry, A[step_row(x, s, rows - 1) * n + l]) & 0x7FFF;
  }
  out[l] = carry;
}
