// A design of probe p11 (llcomp_tpu_torch/csrc/probe_mosaic.cu,
// stage_few) not shipped: one thread a lane, as the TPU probe's loop, with
// the rows of its next kFewDepth steps loaded ahead.  chip_smoke.py
// (VARIANTS, copy "p11 ring") includes it into a copy of probe_mosaic.cu,
// inside its namespace, and launches it for p11 over every lane.
//
// This is p8's register ring (StepRows, word_at's one multiply-add an
// address) without its forwarding: p11 stores nothing, so a load issued
// ahead reads what the step would have read.  Slot k of the ring holds
// the word of step s0 + k; as the step takes it, the slot loads the word
// of step s0 + k + D.  The carry's chain stays serial (an add and a mask a
// step) and the loads leave it, so the step is held by its instructions
// (the row's floor modulo by the run-time rows - 1 most of them), as p8's
// was at five to six clocks an instruction (PERF.md §6); D = 16
// covers one load latency over those steps.
#pragma once

// Steps of p11's rows in flight ahead of the step that adds (D).
constexpr int kFewDepth = 16;

__global__ void __launch_bounds__(kLaneBlock)
stage_few_ring(const int32_t* __restrict__ idx, const int32_t* __restrict__ A,
               int32_t* __restrict__ out, int lanes, int rows, int T,
               int nstage) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  int32_t carry = 0;
  if (l < nstage) {
    const int32_t* const col = A + l;
    const uint32_t pitch = 4u * static_cast<uint32_t>(lanes);
    StepRows rows_of(idx[l], rows - 1);
    int32_t w[kFewDepth];
#pragma unroll
    for (int k = 0; k < kFewDepth; ++k) {
      const int32_t r = rows_of.next();
      w[k] = k < T ? *word_at(col, r, pitch) : 0;
    }
    for (int s0 = 0; s0 < T; s0 += kFewDepth) {
#pragma unroll
      for (int k = 0; k < kFewDepth; ++k) {
        if (s0 + k >= T) break;
        const int32_t word = w[k];
        const int32_t r = rows_of.next();   // step s + D
        if (s0 + k + kFewDepth < T) w[k] = *word_at(col, r, pitch);
        carry = wadd(carry, word) & 0x7FFF;
      }
    }
  }
  out[l] = carry;
}
