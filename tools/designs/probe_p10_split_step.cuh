// A form of p10's decision not shipped: decide24_perm<true>'s function
// (llcomp_tpu_torch/csrc/probe_common.cuh) in fewer instructions and a
// shorter chain.  chip_smoke.py (VARIANTS, copy "p10 split") includes it
// into a copy of probe_mosaic.cu, inside its namespace, and launches its
// kernel for p10; probe_p10_pipes_step.cuh builds on it.
//
// What it changes against decide_perm:
//   - acc's +1 in every decision goes: t = 5t + byte, one multiply-add,
//     and the 24 +1s of a step are added once after it (kSplitOnes);
//   - acc no longer carries ctx: the carry s (its low 3 bits: ctx) is
//     raw + (5s + k), and the rotate that builds the write selectors'
//     masks takes 4s unmasked (the rotate takes its amount mod 32).
// The row writes are decide_perm's: one prmt a word writes byte 0 of
// raw + 1 over byte ctx & 3 of the word ctx is in (put_byte_sel).  ctx
// itself must be masked: a selector nibble's bit 3 asks prmt for a sign
// fill.  ptxas gave 14.42 SASS instructions a decision (9.04 ALU, 4.25
// FMA) with 3.00 on the chain, against decide_perm's 16.33 and 3.50.  At
// T 512 on one H100 it ran under decide_perm in most rounds of turns, by
// 5-8% of the median, but at 128 lanes by less than decide_perm's own
// quartile spread (PERF.md §6, PR 11), so p10 keeps decide_perm.
#pragma once

// u32 a * b + c as one multiply-add, kept in the order written: the
// products stay off the carried chain.
__device__ __forceinline__ uint32_t imad(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ void decide_split(uint32_t& lo, uint32_t& hi,
                                             uint32_t& s, uint32_t& t,
                                             uint32_t k) {
  const uint32_t ctx = s & 7u;
  const uint32_t raw = prmt(lo, hi, ctx);
  const uint32_t ahead = imad(s, 5u, k);
  const uint32_t sh = imad(s, 4u, 0u);
  const uint32_t next = raw + 1u;
  lo = prmt(lo, next, put_byte_sel(__funnelshift_l(0xFu, 0xFu, sh)));
  hi = prmt(hi, next, put_byte_sel(__funnelshift_l(0xF0000u, 0xF0000u, sh)));
  s = imad(raw, 1u, ahead);
  t = imad(t, 5u, raw & 0xFFu);
}

// The sum of 5^j for j < 24, wrapped: the +1s of a step's 24 decisions as
// they reach t after the step.
constexpr uint32_t split_ones() {
  uint32_t v = 0;
  for (int d = 0; d < 24; ++d) v = v * 5u + 1u;
  return v;
}
constexpr uint32_t kSplitOnes = split_ones();

// One step of 24 decide_split, unrolled: acc goes in and out as t, the
// carry as s (s = t mod 8 on both sides; k = 2 - 4d as in decide_perm).
__device__ __forceinline__ void decide24_split(uint32_t& lo, uint32_t& hi,
                                               uint32_t& s, uint32_t& t) {
#pragma unroll
  for (int d = 0; d < 24; ++d) decide_split(lo, hi, s, t, 2u - 4u * d);
  t += kSplitOnes;
}

// p10 (decisions_perm<true> of probe_mosaic.cu) on this step.
__global__ void __launch_bounds__(kLaneBlock)
decisions_split(const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                int lanes, int T) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  uint32_t lo = (static_cast<uint32_t>(idx[l]) & 0xFFu) * 0x01010101u;
  uint32_t hi = lo;
  uint32_t s = 0, t = 0;
#pragma unroll 1
  for (int st = 0; st < T; ++st) decide24_split(lo, hi, s, t);
  out[l] = static_cast<int32_t>(t & 0x7FFFu);
}
