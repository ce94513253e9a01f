// A form of p8's row not shipped: StepRows (llcomp_tpu_torch/csrc/
// probe_common.cuh) with no division a step.  chip_smoke.py (VARIANTS,
// copy "p8 row step") includes it into a copy of probe_mosaic.cu, inside
// its namespace, and launches p8's stage_only on it.
//
// StepRows takes a floor modulo by the run-time divisor m of each step's
// wrapped 32-bit value v, which compiles to a division sequence.  Here the
// row is stepped instead: v' = v + dv wraps at most once, by 2^32 upwards
// where dv is negative as a signed word and downwards where it is not, so
// r' = (r + (dv mod m) + (v' wrapped ? fix : 0)) mod m with fix the
// lane's constant (-2^32 mod m, or 2^32 mod m for a negative dv), each
// partial sum under 2m and brought under m by one unsigned minimum, min(t,
// t - m).  A wrap shows as v' < v (signed) for dv >= 0, v' > v for dv < 0.
// Exact for every int32 x and every m of 1 to 2^31 - 1.  ptxas gave 70
// SASS instructions a step at depth 16 against StepRows' 74 (whose
// reciprocal of m it works out once, before the loop); at T 512 on one
// H100 it ran under StepRows in 10 of 10 alternated rounds at 128 and
// 1,024 lanes, 12% and 6% by median, at 1,024 lanes by less than the
// shipped kernel's quartile spread (PERF.md §6), so p8 keeps
// StepRows.
#pragma once

struct StepRowsAdd {
  uint32_t v, dv, m, dm, fix, r;
  bool neg;
  __device__ StepRowsAdd(int32_t x, int32_t m_)
      : v(static_cast<uint32_t>(x)), dv(static_cast<uint32_t>(x) + 40503u),
        m(static_cast<uint32_t>(m_)) {
    r = static_cast<uint32_t>(fmod_floor(x, m_));
    dm = static_cast<uint32_t>(fmod_floor(static_cast<int32_t>(dv), m_));
    const uint32_t c = (0u - m) % m;   // 2^32 mod m
    neg = static_cast<int32_t>(dv) < 0;
    fix = neg ? c : (m - c) % m;
  }
  __device__ __forceinline__ int32_t next() {
    const uint32_t out = r;
    uint32_t t = r + dm;
    t = min(t, t - m);
    const uint32_t v2 = v + dv;
    const bool wrapped =
        (static_cast<int32_t>(v2) < static_cast<int32_t>(v)) != neg;
    v = v2;
    t += wrapped ? fix : 0u;
    r = min(t, t - m);
    return static_cast<int32_t>(out);
  }
};
