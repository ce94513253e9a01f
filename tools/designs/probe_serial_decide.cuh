// The shift-and-select decision step that the shipped probes replaced,
// kept for the copies of the designs replaced (chip_smoke.py VARIANTS:
// tools/designs/probe_mosaic_serial_step.cu, p7's, p9's and p10's serial
// step, and tools/designs/probe_mosaic2_serial_step.cu, pF's), which
// include it beside csrc/probe_common.cuh (chip_smoke.build_copy puts
// this directory on the include path).  The shipped probes decide with
// decide_perm (probe_common.cuh): 3.5 dependent SASS instructions a
// decision on the carried chain, where this step has 10.
//
// One stand-in decision (probe_mosaic.py:258-266): ctx = (acc + d) & 7
// picks byte ctx of the lane's 8-byte model row, acc = (acc*5 + byte + 1)
// & 0x7FFF, and the byte steps to (byte + 1) & 0xFF.  The row stays in two
// 32-bit registers (bytes 0-3 in lo, 4-7 in hi), read and written with
// shifts: an int[8] indexed by ctx would live in local memory.
#pragma once

#include "probe_common.cuh"

namespace probe {

__device__ __forceinline__ void decide(uint32_t& lo, uint32_t& hi,
                                       int32_t& acc, int d) {
  const int ctx = (acc + d) & 7;
  const int sh = (ctx & 3) * 8;
  const bool up = ctx >= 4;
  uint32_t w = up ? hi : lo;
  const uint32_t b = (w >> sh) & 0xFFu;
  acc = (acc * 5 + static_cast<int32_t>(b) + 1) & 0x7FFF;
  w = (w & ~(0xFFu << sh)) | (((b + 1) & 0xFFu) << sh);
  if (up) {
    hi = w;
  } else {
    lo = w;
  }
}

// 24 decisions, the loop kept (Unroll false) or unrolled (true).
template <bool Unroll>
__device__ __forceinline__ void decide24(uint32_t& lo, uint32_t& hi,
                                         int32_t& acc) {
  if constexpr (Unroll) {
#pragma unroll
    for (int d = 0; d < 24; ++d) decide(lo, hi, acc, d);
  } else {
#pragma unroll 1
    for (int d = 0; d < 24; ++d) decide(lo, hi, acc, d);
  }
}

}  // namespace probe
